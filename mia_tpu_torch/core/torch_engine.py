"""Device scoring engine of the port (pass 1 + iteration realignment).

Port of :class:`mia_tpu.core.jax_engine.Pass1Scorer`.  The phase split is
the same: the host streams reads and builds k-mer bands (native batch
engine), the device scores whole batches of **entries** with the fused
kernel (:func:`mia_tpu_torch.ops.dp_cuda.dp_entries`, or under ``-h``
:func:`~mia_tpu_torch.ops.dp_cuda.dp_entries_hp`), and the host rebuilds
the winner's traceback.  An entry is a (strand select, window start, band
intervals, read codes, PSSM select) tuple; pass 1 sends each read as a
forward and a reverse-complement entry, realignment sends each strand-known
read as one entry against the new consensus.

What changed from the TPU engine, and why:

* Entries go to the card as they are: int8 read codes [E, 256], or raw
  chars under ``-h`` (no nibble packing: the link that made packing pay is
  gone), no padding to a fixed batch (no per-shape compile to avoid), no
  length sort (each warp of the kernel stops at its own last row).  The
  ``-h`` batch is the default batch too: the TPU capped it at 2048 reads
  for its 32-row ring, which the kernel does not keep.
* Dispatch is asynchronous on the current CUDA stream: inputs are staged
  in pinned host memory and copied with ``non_blocking``; the [2, E] result
  comes back the same way, and a ``torch.cuda.Event`` per batch says when
  it has landed (:meth:`Pass1Scorer.ready`).
* There is no background compile, no warm-up and no fallback: the kernel
  library is built when the scorer is made on a card, and a failure raises.

The numpy helpers (``build_pass1_entries``, ``split_pass1_results``,
``pack_s2c``, ``diag_gapfree``) and the shape constants come from
:mod:`mia_tpu.core.jax_engine`, which imports no jax at load.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from mia_tpu.core.jax_engine import (
    L_MAX,
    MAX_INTERVALS,
    REF_BUCKET,
    WIN_W,
    build_pass1_entries,
    default_batch,
    hp_pengop_table,
    split_pass1_results,
)
from mia_tpu.utils.encoding import BASE2INX, pop_hpl_and_hps

from ..ops import dp_cuda
from ..utils.torchcfg import kernel_library, select_device


@dataclass(frozen=True)
class ScorerState:
    """What a scorer holds on its device for one reference: both padded
    strands and both PSSMs, and under ``-h`` the strands' chars and
    homopolymer run starts, the gap-open discounts and the char codes."""

    refs: torch.Tensor  # [2, WTOT] int8 strand codes, pad 4
    sms: torch.Tensor   # [2, 31, 5, 5] int32 PSSMs (slot 0 fw, slot 1 rc)
    refchr: torch.Tensor | None = None  # [2, WTOT] uint8 strand chars, pad 0
    hpcs: torch.Tensor | None = None    # [2, WTOT] int32 run start per column
    pengop: torch.Tensor | None = None  # [11] int32 hp_pengop_table()
    b2i: torch.Tensor | None = None     # [256] int8 BASE2INX

    @property
    def hp(self) -> bool:
        return self.refchr is not None


def padded_state_numpy(fw_s1c, rc_s1c, len1: int, submat, submat_b=None):
    """(refs [2, WTOT] int8, sms [2, 31, 5, 5] int32) exactly as
    jax_engine.Pass1Scorer builds them: the reference pads to a REF_BUCKET
    multiple plus WIN_W columns of code 4, so a window gather never runs off
    the end (its junk columns are masked)."""
    wtot = -(-len1 // REF_BUCKET) * REF_BUCKET + WIN_W
    refs = np.full((2, wtot), 4, np.int8)
    refs[0, :len1] = np.asarray(fw_s1c[:len1], dtype=np.int8)
    refs[1, :len1] = np.asarray(rc_s1c[:len1], dtype=np.int8)
    sms = np.stack([
        np.asarray(submat, dtype=np.int32),
        np.asarray(submat_b if submat_b is not None else submat, np.int32),
    ])
    return refs, sms


def hp_state_numpy(hp_seqs: tuple[str, str], len1: int, wtot: int):
    """(refchr [2, WTOT] uint8, hpcs [2, WTOT] int32, pengop [11] int32)
    exactly as jax_engine.Pass1Scorer builds them under ``-h``: each
    strand's chars and homopolymer run starts, zero past the strand."""
    refchr = np.zeros((2, wtot), np.uint8)
    hpcs = np.zeros((2, wtot), np.int32)
    for i, s in enumerate(hp_seqs):
        s = s[:len1]
        refchr[i, : len(s)] = np.frombuffer(s.encode("latin-1"), np.uint8)
        hpcs[i, : len(s)] = pop_hpl_and_hps(s)[1]
    return refchr, hpcs, hp_pengop_table()


def state_from_numpy(refs_np: np.ndarray, sms_np: np.ndarray, device,
                     refchr_np=None, hpcs_np=None, pengop_np=None) -> ScorerState:
    """Carry a scorer's state (e.g. jax_engine.Pass1Scorer's ``_refs_np``,
    ``_sms_np`` and, under ``-h``, ``_refchr_np``, ``_hpcs_np``,
    ``_pengop_np``) onto ``device``."""
    dev = torch.device(device)
    refs = np.ascontiguousarray(refs_np, dtype=np.int8)
    sms = np.ascontiguousarray(sms_np, dtype=np.int32)
    if refs.ndim != 2 or refs.shape[0] != 2:
        raise ValueError(f"refs: shape {refs.shape}, want [2, WTOT]")
    if sms.shape != (2, 31, 5, 5):
        raise ValueError(f"sms: shape {sms.shape}, want [2, 31, 5, 5]")

    def on(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    if refchr_np is None:
        return ScorerState(on(refs, np.int8), on(sms, np.int32))
    hp = (np.asarray(refchr_np), np.asarray(hpcs_np), np.asarray(pengop_np))
    if hp[0].shape != refs.shape or hp[1].shape != refs.shape or hp[2].shape != (11,):
        raise ValueError(f"-h state: shapes {[a.shape for a in hp]}, want "
                         f"{refs.shape}, {refs.shape}, (11,)")
    return ScorerState(on(refs, np.int8), on(sms, np.int32), on(hp[0], np.uint8),
                       on(hp[1], np.int32), on(hp[2], np.int32), on(BASE2INX, np.int8))


@dataclass
class _Batch:
    """A dispatched batch: the [2, n] result (host memory; pinned on a card)
    and, on a card, the event recorded after its copy back."""

    out: torch.Tensor | None
    n: int
    event: torch.cuda.Event | None = None


class Pass1Scorer:
    """Scores entries against up to two reference strands on one device.

    ``device`` defaults to :func:`select_device` (the card; the CPU only on
    request).  Same driving interface as the JAX engine's scorer:
    ``dispatch_entries`` / ``collect_entries`` / ``ready`` for entries,
    ``dispatch_packed`` / ``collect_arrays`` for pass-1 read batches, and
    ``batch`` / ``E`` for sizes."""

    def __init__(self, fw_s1c, rc_s1c, len1: int, submat, submat_b=None,
                 batch: int | None = None, device=None,
                 hp_seqs: tuple[str, str] | None = None):
        dev = select_device() if device is None else torch.device(device)
        refs, sms = padded_state_numpy(fw_s1c, rc_s1c, len1, submat, submat_b)
        hp = () if hp_seqs is None else hp_state_numpy(hp_seqs, len1, refs.shape[1])
        self._bind(state_from_numpy(refs, sms, dev, *hp), len1, batch)

    @classmethod
    def from_state(cls, state: ScorerState, len1: int,
                   batch: int | None = None) -> "Pass1Scorer":
        """A scorer over state already on its device (state_from_numpy)."""
        self = cls.__new__(cls)
        self._bind(state, len1, batch)
        return self

    def _bind(self, state: ScorerState, len1: int, batch: int | None) -> None:
        self.state = state
        self.hp = state.hp
        self.device = state.refs.device
        self.len1 = len1
        self.WTOT = state.refs.shape[1]
        self.batch = batch or default_batch()
        self.E = 2 * self.batch
        if self.device.type == "cuda":
            kernel_library()  # build/load now, not inside the first dispatch

    # ------------------------------------------------------------- dispatch
    def dispatch_entries(self, ref_sel, starts, ivl, s2c, lengths, smidx) -> _Batch:
        """Enqueue up to E entries; asynchronous on a card.

        ivl holds WINDOW-LOCAL [lo, hi) intervals (global band minus the
        entry's window start); entries with all-zero intervals score HIM.
        Returns a handle for :meth:`collect_entries`."""
        n = len(ref_sel)
        if n == 0:
            return _Batch(None, 0)
        if n > self.E:
            raise ValueError(f"{n} entries exceed the batch of {self.E}")
        s2c = np.asarray(s2c)
        # -h ships raw chars (pad 0), otherwise codes (pad 4)
        s2c_p = np.full((n, L_MAX), 0 if self.hp else 4, np.uint8 if self.hp else np.int8)
        s2c_p[:, : s2c.shape[1]] = s2c
        host = (
            np.ascontiguousarray(ref_sel, np.int8),
            np.ascontiguousarray(starts, np.int32),
            np.ascontiguousarray(np.asarray(ivl).reshape(n, MAX_INTERVALS, 2), np.int32),
            s2c_p,
            np.maximum(np.ascontiguousarray(lengths, np.int32), 1),
            np.ascontiguousarray(smidx, np.int8),
        )
        st = self.state
        score = (partial(dp_cuda.dp_entries_hp, st.refs, st.refchr, st.hpcs, st.sms,
                         st.pengop, st.b2i)
                 if self.hp else partial(dp_cuda.dp_entries, st.refs, st.sms))
        if self.device.type == "cpu":
            return _Batch(score(*(torch.from_numpy(a) for a in host)), n)
        args = [torch.from_numpy(a).pin_memory().to(self.device, non_blocking=True)
                for a in host]
        out_dev = score(*args)
        out = torch.empty((2, n), dtype=torch.int32, pin_memory=True)
        out.copy_(out_dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return _Batch(out, n, event)

    @staticmethod
    def ready(handle) -> bool:
        """True when the batch's results have landed (non-blocking); takes
        an entries handle or a packed pass-1 handle."""
        batch = handle[0] if isinstance(handle, tuple) else handle
        return batch.event is None or batch.event.query()

    def collect_entries(self, handle: _Batch):
        """Materialise a dispatched batch: (best, aec) int64 arrays [n];
        aec is WINDOW-LOCAL (add the entry's window start)."""
        if handle.out is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        if handle.event is not None:
            handle.event.synchronize()
        arr = handle.out.numpy()
        return arr[0].astype(np.int64), arr[1].astype(np.int64)

    # ------------------------------------------------- pass-1 (two strands)
    def dispatch_packed(self, s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags):
        """Enqueue one pass-1 read batch packed by the native host engine
        (core/hostbatch.py: BatchHost.prepare): each read becomes two
        entries (fw then rc).  Flagged reads (FLAG_SKIP / HOST_ONLY / WIDE)
        get empty intervals and garbage scores the caller ignores.  Results
        via :meth:`collect_arrays`."""
        n = len(lens)
        if n > self.batch:
            raise ValueError(f"{n} reads exceed the batch of {self.batch}")
        if n == 0:
            return _Batch(None, 0), fw_ws.copy(), rc_ws.copy()
        entries = build_pass1_entries(s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags)
        return self.dispatch_entries(*entries), fw_ws.copy(), rc_ws.copy()

    def collect_arrays(self, handle):
        """Materialise a packed pass-1 batch: (fb, fa, rb, ra) int64 [n]
        with aec in GLOBAL reference coordinates."""
        batch, fw_ws, rc_ws = handle
        best, aec = self.collect_entries(batch)
        return split_pass1_results(best, aec, fw_ws, rc_ws)
