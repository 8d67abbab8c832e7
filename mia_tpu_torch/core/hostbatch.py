"""ctypes binding for the native batched host engine
(mia_tpu_torch/native/src/hostbatch.cc, built by :mod:`mia_tpu_torch.io.native`).

The device scores whole batches; this binding packs those batches (k-mer
filter + band intervals + encoded reads) and finishes them (score-verified
window DP + traceback) in single per-batch FFI calls, replacing the per-read
Python path of ops/kmer.new_kmer_filter + jax_engine.windowed_exact_dp.

Reference semantics covered here: new_kmer_filter
(src/kmer.c:239-331), the window traceback contract of
dyn_prog/max_sg_score/find_align_begin (src/mia.c:605-637,
740-981, 1278-1302).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..io.native import _load

FLAG_SKIP = 1
FLAG_HOST_ONLY = 2
FLAG_WIDE = 4

# solver thread cap: each thread holds full score+trace planes for both
# strands (~w*len2*16 bytes); with the k-mer filter off (full-open windows on
# a long reference) uncapped cpu_count threads could hold many GB resident
# and oversubscribe shared hosts
MAX_SOLVE_THREADS = 16


def host_cpus() -> int:
    """CPUs this process may run on: its affinity set, which in a container
    can be smaller than ``os.cpu_count()``."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity on this platform
        return os.cpu_count() or 1


def _default_threads() -> int:
    return min(host_cpus(), MAX_SOLVE_THREADS)


# mia_p1_solve / mia_rei_solve status codes
STATUS_OK = 0
STATUS_NO_KMER = 1
STATUS_GATED = 2
STATUS_HOST_FALLBACK = 3

_DECLARED = False


def _lib():
    global _DECLARED
    lib = _load()
    if lib is None or not hasattr(lib, "mia_p1_create"):
        return None
    if not _DECLARED:
        lib.mia_kpa_build.restype = ctypes.c_void_p
        lib.mia_kpa_build.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.mia_kpa_free.argtypes = [ctypes.c_void_p]
        lib.mia_p1_create.restype = ctypes.c_void_p
        lib.mia_p1_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.mia_p1_free.argtypes = [ctypes.c_void_p]
        lib.mia_p1_prepare.restype = ctypes.c_int
        lib.mia_p1_prepare.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int,
        ]
        lib.mia_p1_finish.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int,
        ]
        lib.mia_p1_solve.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.mia_rei_solve.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
        ]
        _DECLARED = True
    return lib


class BatchHost:
    """Per-assembly native context: both reference strands + PSSMs + k-mer
    indexes.  Rebuild whenever the reference changes (each iteration)."""

    TRACE_CAP = 4096  # per-read per-side traceback arena (chars)

    def __init__(self, lib, ctx, kpa_handles, len1: int = 0):
        self._lib = lib
        self._ctx = ctx
        self._kpas = kpa_handles
        self.len1 = len1

    @property
    def wide_cap(self) -> int:
        """Arena size that can hold any traceback (full-width window)."""
        return self.len1 + 256 + 64

    @classmethod
    def create(
        cls,
        fw_seq: str,
        rc_seq: str,
        len1: int,
        submat_a: np.ndarray,
        submat_b: np.ndarray | None,
        kmer_len: int,
        soft_mask: bool,
        win_w: int,
        max_intervals: int,
        upper: bool = True,
        hp: bool = False,
    ) -> "BatchHost | None":
        """fw_seq/rc_seq: the (possibly soft-masked) strand characters used
        for BOTH the k-mer index build and (uppercased by caller) scoring.
        The k-mer index sees the original case; pass the pre-uppercase
        strings here and the already-uppercased chars drive the DP via
        base2inx (lowercase encodes as 4, matching the reference flow where
        make_ref_upper runs after populate_kpa, src/mia_main.c:659-676)."""
        lib = _lib()
        if lib is None:
            return None
        fb = fw_seq[:len1].encode("latin-1")
        rb = rc_seq[:len1].encode("latin-1")
        kpas = []
        fk = rk = None
        if kmer_len > 0:
            fk = lib.mia_kpa_build(fb, len1, kmer_len, int(soft_mask))
            rk = lib.mia_kpa_build(rb, len1, kmer_len, int(soft_mask))
            kpas = [fk, rk]
        sa = np.ascontiguousarray(submat_a, dtype=np.int32)
        sb = (
            np.ascontiguousarray(submat_b, dtype=np.int32)
            if submat_b is not None
            else None
        )
        # scoring chars are the uppercased strands (reference flow uppercases
        # after the k-mer index is built); reiterate contexts pass the
        # consensus as-is (upper=False) to mirror set_seq1 on the raw string
        if upper:
            fu = fw_seq[:len1].upper().encode("latin-1")
            ru = rc_seq[:len1].upper().encode("latin-1")
        else:
            fu = fb
            ru = rb
        ctx = lib.mia_p1_create(
            fu,
            ru,
            len1,
            sa.ctypes.data_as(ctypes.c_void_p),
            sb.ctypes.data_as(ctypes.c_void_p) if sb is not None else None,
            fk,
            rk,
            kmer_len,
            win_w,
            max_intervals,
            int(hp),
        )
        return cls(lib, ctx, kpas, len1)

    def close(self) -> None:
        if self._ctx:
            self._lib.mia_p1_free(self._ctx)
            self._ctx = None
        for k in self._kpas:
            self._lib.mia_kpa_free(k)
        self._kpas = []

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

    @staticmethod
    def pack_reads(reads: list[str]) -> tuple[bytes, np.ndarray, np.ndarray]:
        """(arena, offsets[n], lens[n]) for a batch of read strings."""
        lens = np.fromiter((len(r) for r in reads), np.int32, len(reads))
        off = np.zeros(len(reads) + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        arena = "".join(reads).encode("latin-1")
        return arena, off, lens

    def prepare(self, arena: bytes, off: np.ndarray, lens: np.ndarray, L: int, K: int,
                n_threads: int = 0):
        """Returns (s2c [n,L], fw_ws, rc_ws, fw_ivg, rc_ivg [n,K,2], flags,
        errors), threaded over reads (the arrays do not depend on
        ``n_threads``); ``errors`` counts the reads whose native iteration
        failed, which are flagged HOST_ONLY."""
        n = len(lens)
        if n_threads <= 0:
            n_threads = _default_threads()
        s2c = np.empty((n, L), np.int32)
        fw_ws = np.empty(n, np.int32)
        rc_ws = np.empty(n, np.int32)
        fw_ivg = np.empty((n, K, 2), np.int32)
        rc_ivg = np.empty((n, K, 2), np.int32)
        flags = np.empty(n, np.int32)
        errors = self._lib.mia_p1_prepare(
            self._ctx,
            n,
            arena,
            off.ctypes.data_as(ctypes.c_void_p),
            np.ascontiguousarray(lens, np.int32).ctypes.data_as(ctypes.c_void_p),
            L,
            s2c.ctypes.data_as(ctypes.c_void_p),
            fw_ws.ctypes.data_as(ctypes.c_void_p),
            rc_ws.ctypes.data_as(ctypes.c_void_p),
            fw_ivg.ctypes.data_as(ctypes.c_void_p),
            rc_ivg.ctypes.data_as(ctypes.c_void_p),
            flags.ctypes.data_as(ctypes.c_void_p),
            n_threads,
        )
        return s2c, fw_ws, rc_ws, fw_ivg, rc_ivg, flags, errors

    def finish(
        self,
        arena: bytes,
        off: np.ndarray,
        lens: np.ndarray,
        strand: np.ndarray,
        smidx: np.ndarray,
        dev_best: np.ndarray,
        dev_aec: np.ndarray,
        ivg: np.ndarray,
        n_threads: int = 0,
        cap: int = 0,
    ):
        """Window-exact DP + traceback for each read's winning strand,
        threaded over reads.

        Returns (meta [n,4] = best/abc/aec/pwlen, ref_arena, frag_arena);
        read b's strings are the first meta[b,3] chars at offset b*cap
        (default TRACE_CAP; callers that pass a tighter cap must slice with
        the same value).  A pwlen of -1 marks a worker failure (including
        cap overflow): rerun that read on the per-read host path.
        """
        n = len(lens)
        K = ivg.shape[1]
        meta = np.empty((n, 4), np.int32)
        cap = cap or self.TRACE_CAP
        # np.empty, not create_string_buffer: the zero-fill of the output
        # arenas cost more than the DP at production batch sizes
        out_ref = np.empty(n * cap, np.uint8)
        out_frag = np.empty(n * cap, np.uint8)
        if n_threads <= 0:
            n_threads = _default_threads()
        self._lib.mia_p1_finish(
            self._ctx,
            n,
            arena,
            off.ctypes.data_as(ctypes.c_void_p),
            np.ascontiguousarray(lens, np.int32).ctypes.data_as(ctypes.c_void_p),
            np.ascontiguousarray(strand, np.uint8).ctypes.data_as(ctypes.c_void_p),
            np.ascontiguousarray(smidx, np.uint8).ctypes.data_as(ctypes.c_void_p),
            np.ascontiguousarray(dev_best, np.int32).ctypes.data_as(ctypes.c_void_p),
            np.ascontiguousarray(dev_aec, np.int32).ctypes.data_as(ctypes.c_void_p),
            np.ascontiguousarray(ivg, np.int32).ctypes.data_as(ctypes.c_void_p),
            K,
            meta.ctypes.data_as(ctypes.c_void_p),
            out_ref.ctypes.data_as(ctypes.c_void_p),
            out_frag.ctypes.data_as(ctypes.c_void_p),
            cap,
            n_threads,
        )
        return meta, out_ref.tobytes(), out_frag.tobytes()

    def solve_pass1(
        self,
        arena: bytes,
        off: np.ndarray,
        lens: np.ndarray,
        distant_ref: bool,
        n_threads: int = 0,
        cap: int = 0,
    ):
        """Fully-native batched pass 1 (k-mer filter + banded fw/rc DP +
        strand pick + gate + traceback), threaded over reads.

        Returns (meta [n,6] = status/strand/best/abc/aec/pwlen, ref_arena,
        frag_arena); read b's gapped strings are meta[b,5] chars at offset
        b*cap (default TRACE_CAP).  Status: 0 aligned, 1 zero k-mer hits,
        2 gate-rejected, 3 arena too small for this window (retry with a
        larger ``cap``)."""
        n = len(lens)
        meta = np.empty((n, 6), np.int32)
        cap = cap or self.TRACE_CAP
        out_ref = np.empty(n * cap, np.uint8)
        out_frag = np.empty(n * cap, np.uint8)
        if n_threads <= 0:
            n_threads = _default_threads()
        self._lib.mia_p1_solve(
            self._ctx,
            n,
            arena,
            np.ascontiguousarray(off, np.int64).ctypes.data_as(ctypes.c_void_p),
            np.ascontiguousarray(lens, np.int32).ctypes.data_as(ctypes.c_void_p),
            int(distant_ref),
            n_threads,
            meta.ctypes.data_as(ctypes.c_void_p),
            out_ref.ctypes.data_as(ctypes.c_void_p),
            out_frag.ctypes.data_as(ctypes.c_void_p),
            cap,
        )
        return meta, out_ref.tobytes(), out_frag.tobytes()

    def solve_rei(
        self,
        arena: bytes,
        off: np.ndarray,
        lens: np.ndarray,
        smidx: np.ndarray,
        wlo: np.ndarray,
        whi: np.ndarray,
        n_threads: int = 0,
        cap: int = 0,
    ):
        """Batched per-iteration window realignment (reiterate_assembly's
        strand-known loop).  Returns (meta [n,5] = status/best/abc/aec/pwlen,
        ref_arena, frag_arena) with abc/aec in global coordinates."""
        n = len(lens)
        meta = np.empty((n, 5), np.int32)
        cap = cap or self.TRACE_CAP
        out_ref = np.empty(n * cap, np.uint8)
        out_frag = np.empty(n * cap, np.uint8)
        if n_threads <= 0:
            n_threads = _default_threads()
        self._lib.mia_rei_solve(
            self._ctx,
            n,
            arena,
            np.ascontiguousarray(off, np.int64).ctypes.data_as(ctypes.c_void_p),
            np.ascontiguousarray(lens, np.int32).ctypes.data_as(ctypes.c_void_p),
            np.ascontiguousarray(smidx, np.uint8).ctypes.data_as(ctypes.c_void_p),
            np.ascontiguousarray(wlo, np.int32).ctypes.data_as(ctypes.c_void_p),
            np.ascontiguousarray(whi, np.int32).ctypes.data_as(ctypes.c_void_p),
            n_threads,
            meta.ctypes.data_as(ctypes.c_void_p),
            out_ref.ctypes.data_as(ctypes.c_void_p),
            out_frag.ctypes.data_as(ctypes.c_void_p),
            cap,
        )
        return meta, out_ref.tobytes(), out_frag.tobytes()
