"""ctypes binding for the native C++ read parser (mia_tpu_torch/native/src/fastaio.cc).

The port's native host library, ``libmiaio.so``, is built from the port's
own sources (``mia_tpu_torch/native/``: the read parser, the host DP, the
batched pass-1 engine and the score cut) at first use, by their
``Makefile``, into ``mia_tpu_torch/_build/native-<hash>/``, keyed by a hash of
the sources (an edited ``.cc`` rebuilds), as ``utils/torchcfg.py`` keys the
CUDA kernels.  Callers use :func:`iter_frag_seqs_fast`, which falls back to
the exact Python parser when the library did not build; the device engine
has no such fallback and raises with the build's output
(:func:`build_error`).  Both parsers produce identical records
(tests/test_native_io.py asserts it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from typing import Iterator

import numpy as np

from ..core.types import FragSeq

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(PKG_DIR, "native")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

_LIB = None
_TRIED = False
_ERROR = ""
_LOAD_LOCK = threading.Lock()


def _sources() -> list[str]:
    src = os.path.join(NATIVE_DIR, "src")
    return [os.path.join(NATIVE_DIR, "Makefile")] + sorted(
        os.path.join(src, fn) for fn in os.listdir(src) if fn.endswith(".cc"))


def library_path() -> str:
    """Where the library for the current sources lives."""
    h = hashlib.sha256()
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.relpath(path, NATIVE_DIR).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"native-{h.hexdigest()[:16]}", "libmiaio.so")


def build_library() -> str:
    """Build the library for the current sources unless it exists; returns
    its path.  A file lock beside it serialises concurrent builds (test
    workers, ranks); the library is written under a temporary name and
    renamed into place.  Raises RuntimeError with make's output when the
    build fails."""
    import fcntl
    import subprocess

    path = library_path()
    if os.path.exists(path):
        return path
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, ".lock"), "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            os.remove(tmp)  # an interrupted build's: make would call it current
        r = subprocess.run(["make", "-C", NATIVE_DIR, f"LIB={tmp}"],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"make -C {NATIVE_DIR} failed ({r.returncode}):\n"
                               f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, path)
    return path


def build_error() -> str:
    """Why the library is not loaded ("" when it is, or was never asked
    for)."""
    return _ERROR


def unavailable() -> RuntimeError:
    """The error the device engine raises when the library did not build:
    it has no host fallback."""
    return RuntimeError("--engine torch needs the port's native host library "
                        f"(mia_tpu_torch/native), which did not build: {_ERROR}")


def _load():
    """The loaded library, built on first use; None when it did not build
    (:func:`build_error` says why)."""
    global _LIB, _TRIED, _ERROR
    with _LOAD_LOCK:
        if not _TRIED:
            _TRIED = True
            try:
                _LIB = _declare(ctypes.CDLL(build_library()))
            except Exception as e:  # no compiler, a failed build, a library that will not load
                _ERROR = f"{type(e).__name__}: {e}"
    return _LIB


def _declare(lib):
    """``lib`` with the parser's argument and result types declared."""
    lib.mia_parse_reads.restype = ctypes.c_void_p
    lib.mia_parse_reads.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.mia_reads_count.restype = ctypes.c_int64
    lib.mia_reads_count.argtypes = [ctypes.c_void_p]
    for name in ("ids", "descs", "seqs", "quals"):
        fn = getattr(lib, f"mia_reads_{name}")
        fn.restype = ctypes.POINTER(ctypes.c_char)
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.mia_reads_seq_lens.restype = ctypes.POINTER(ctypes.c_int64)
    lib.mia_reads_seq_lens.argtypes = [ctypes.c_void_p]
    lib.mia_reads_qual_sums.restype = ctypes.POINTER(ctypes.c_int64)
    lib.mia_reads_qual_sums.argtypes = [ctypes.c_void_p]
    lib.mia_reads_free.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    return _load() is not None


def _blob_slice(lib, h, name: str, start: int, end: int) -> list[str]:
    """Records [start, end) of a '\\0'-separated arena, decoding ONLY that
    slice (multi-host shards must not materialise the whole file as python
    strings)."""
    n = ctypes.c_int64()
    p = getattr(lib, f"mia_reads_{name}")(h, ctypes.byref(n))
    if not n.value:
        return []
    raw = np.frombuffer(ctypes.string_at(p, n.value), np.uint8)
    seps = np.flatnonzero(raw == 0)
    lo = 0 if start == 0 else int(seps[start - 1]) + 1
    hi = int(seps[end - 1])
    return (
        raw[lo:hi].tobytes().decode("latin-1").split("\0") if end > start else []
    )


def count_reads_native(path: str) -> int | None:
    """Record count via the native parser (no python objects); None when
    the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = lib.mia_parse_reads(path.encode(), -1)
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        return int(lib.mia_reads_count(h))
    finally:
        lib.mia_reads_free(h)


def parse_reads_native(
    path: str, start: int = 0, count: int = -1
) -> list[FragSeq] | None:
    """FragSeq records [start, start+count) (count -1 = to the end); only
    the requested slice is materialised as python objects/strings."""
    lib = _load()
    if lib is None:
        return None
    h = lib.mia_parse_reads(path.encode(), -1)
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        total = lib.mia_reads_count(h)
        end = total if count < 0 else min(start + count, total)
        start = min(start, end)
        if end <= start:
            return []
        ids = _blob_slice(lib, h, "ids", start, end)
        descs = _blob_slice(lib, h, "descs", start, end)
        seqs = _blob_slice(lib, h, "seqs", start, end)
        quals = _blob_slice(lib, h, "quals", start, end)
        seq_lens = np.ctypeslib.as_array(
            lib.mia_reads_seq_lens(h), (total,)
        )[start:end].copy()
        qual_sums = np.ctypeslib.as_array(
            lib.mia_reads_qual_sums(h), (total,)
        )[start:end].copy()
    finally:
        lib.mia_reads_free(h)
    out = []
    for i in range(end - start):
        fs = FragSeq()
        fs.id = ids[i]
        fs.desc = descs[i]
        fs.seq = seqs[i]
        fs.qual = quals[i]
        fs.seq_len = int(seq_lens[i])
        fs.qual_sum = int(qual_sums[i])
        out.append(fs)
    return out


def iter_frag_seqs_fast(path: str, chunk: int = 16384) -> Iterator[FragSeq]:
    """Native-parser read stream with exact-Python fallback.

    The C++ parse runs once (arenas stay in the native handle); python
    FragSeq objects materialise per ``chunk`` so the first scoring batch
    dispatches before the whole file has been objectified, and the peak
    object count stays bounded for consumers that drop records as they
    stream."""
    lib = _load()
    if lib is None:
        from .fasta import iter_frag_seqs

        yield from iter_frag_seqs(path)
        return
    h = lib.mia_parse_reads(path.encode(), -1)
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        total = int(lib.mia_reads_count(h))
        if total == 0:
            return
        seq_lens = np.ctypeslib.as_array(
            lib.mia_reads_seq_lens(h), (total,)
        ).copy()
        qual_sums = np.ctypeslib.as_array(
            lib.mia_reads_qual_sums(h), (total,)
        ).copy()
        arenas = {}
        for name in ("ids", "descs", "seqs", "quals"):
            n = ctypes.c_int64()
            pptr = getattr(lib, f"mia_reads_{name}")(h, ctypes.byref(n))
            raw = (
                np.frombuffer(ctypes.string_at(pptr, n.value), np.uint8)
                if n.value
                else np.zeros(0, np.uint8)
            )
            arenas[name] = (raw, np.flatnonzero(raw == 0))
    finally:
        lib.mia_reads_free(h)

    def _sl(name: str, start: int, end: int) -> list[str]:
        raw, seps = arenas[name]
        lo = 0 if start == 0 else int(seps[start - 1]) + 1
        hi = int(seps[end - 1])
        return raw[lo:hi].tobytes().decode("latin-1").split("\0")

    for start in range(0, total, chunk):
        end = min(start + chunk, total)
        ids = _sl("ids", start, end)
        descs = _sl("descs", start, end)
        seqs = _sl("seqs", start, end)
        quals = _sl("quals", start, end)
        for i in range(end - start):
            fs = FragSeq()
            fs.id = ids[i]
            fs.desc = descs[i]
            fs.seq = seqs[i]
            fs.qual = quals[i]
            fs.seq_len = int(seq_lens[start + i])
            fs.qual_sum = int(qual_sums[start + i])
            yield fs


def iter_frag_seqs_range(path: str, start: int, count: int) -> Iterator[FragSeq]:
    """Stream records [start, start+count) — the multi-host shard reader.
    Native path materialises only the slice; the python fallback streams
    and discards out-of-range records (constant memory)."""
    reads = parse_reads_native(path, start, count)
    if reads is not None:
        yield from reads
        return
    import itertools

    from .fasta import iter_frag_seqs

    yield from itertools.islice(iter_frag_seqs(path), start, start + count)


def count_frag_seqs(path: str) -> int:
    """Total record count (native when available; streaming otherwise)."""
    n = count_reads_native(path)
    if n is not None:
        return n
    from .fasta import iter_frag_seqs

    return sum(1 for _ in iter_frag_seqs(path))
