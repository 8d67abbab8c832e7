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
* ``--dp-devices`` (the JAX package's ``_mesh_fn``: the same program under
  ``shard_map`` over a ``dp`` mesh, reference and PSSMs replicated) is a
  list of devices here: the scorer keeps one copy of its state and one CUDA
  stream per shard, deals entry i to shard i mod n (every shard gets the
  same mix of lengths, and each warp stops at its own row, so no length
  sort), launches the kernel once per shard on that shard's stream, and
  puts the results back in the caller's order.
* A pass-1 read whose band is wider than the entry window (WIDE) is scored
  on the card too, where the TPU engine sent it to the native solve to keep
  its device program count at one: each of its strands with intervals is a
  row of the general-width scorer
  (:func:`mia_tpu_torch.ops.dp_cuda.dp_last_row_strand`; under ``-h``, where
  the rows carry the reads' chars, its ``-h`` form
  :func:`~mia_tpu_torch.ops.dp_cuda.dp_last_row_hp`) over the strand's
  window (``entries.wide_rows``), launched after the batch's entries on the
  same stream, and only each row's (best, aec) comes back.  Each reads its
  windows of the strands (and under ``-h`` their chars and run starts) from
  the state itself, in three forms: ``entries.wide_rows`` puts the rows
  whose band takes at most 3,072 columns first, for the band form, which
  scores those columns only on 1, 2, 4 or 8 warps a row; the rows whose band
  takes at most 18,432 columns (whole strands) follow, for the strand form,
  a cluster of 16 CTAs a row; the rest (none under ``-h``) take the full form
  at their widest window.  Under ``--dp-devices`` all of a batch's wide rows go to the
  first shard.  Under ``-h`` a read with a strand window past 17,408
  columns (``entries.HP_WIDE_COLS``) stays with the native solve.

The numpy helpers (``build_pass1_entries``, ``split_pass1_results``,
``wide_rows``, ``merge_wide``, ``pack_s2c``, ``diag_gapfree``) and the shape
constants live in :mod:`mia_tpu_torch.core.entries`.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ..ops import dp_cuda
from ..utils.encoding import BASE2INX, pop_hpl_and_hps
from ..utils.torchcfg import kernel_library, select_device
from .entries import (
    L_MAX,
    MAX_INTERVALS,
    REF_BUCKET,
    WIN_W,
    WideRows,
    build_pass1_entries,
    default_batch,
    hp_pengop_table,
    merge_wide,
    split_pass1_results,
    wide_rows,
)


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


def score_wide(state: ScorerState, width: int, n_band: int, band_classes: tuple,
               n_strand: int, strand, win_lo, ivl, s2c, lengths) -> torch.Tensor:
    """(best, window-local aec) of wide rows as [2, R] int32 in row order:
    the last DP row's first maximum (the native solve takes the earliest
    column too, hostbatch.cc ``fill_strand``).  ``dp_cuda.dp_last_row_strand``
    (under ``-h``, where ``s2c`` holds read chars, ``dp_cuda.dp_last_row_hp``)
    reads the windows of the state's strands itself and returns only the
    pairs: the first ``n_band`` rows from its band form (``band_classes``
    rows on 1, 2, 4 and 8 warps), the next ``n_strand`` from its strand
    form, the rest from its full form at ``width`` (``entries.WideRows``).
    Every row scores with the forward PSSM, as ``mia_p1_solve`` does for
    both strands (``ctx->submat[0]``)."""
    if state.hp:
        return dp_cuda.dp_last_row_hp(state.refs, state.refchr, state.hpcs, state.sms[0],
                                      state.pengop, state.b2i, strand, win_lo, ivl, s2c,
                                      lengths, width, n_band, band_classes, n_strand)
    return dp_cuda.dp_last_row_strand(state.refs, state.sms[0], strand, win_lo, ivl, s2c,
                                      lengths, width, n_band, band_classes, n_strand)


def make_dp_devices(n_dp: int, devices=None) -> list[torch.device] | None:
    """The device list of ``--dp-devices``: the first ``n_dp`` of
    ``cuda:0 .. cuda:{count-1}`` (``-1`` = all), or None when fewer than two
    would result (the single-device path).  An explicit ``devices`` list is
    taken as it is and may name one device several times: the port's
    stand-in for XLA's virtual host devices, for tests and dry runs on one
    card or on the CPU.  The JAX package rounds the count down to a divisor
    of the batch so that its entry axis shards evenly; the shards here may
    be uneven, so no rounding is needed."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    elif n_dp == 0:
        return None
    else:
        count = torch.cuda.device_count()
        n = count if n_dp < 0 else min(n_dp, count)
        devs = [torch.device("cuda", i) for i in range(n)]
    return devs if len(devs) >= 2 else None


@dataclass
class _Shard:
    """One device's share of a scorer: its copy of the state and, on a card,
    the stream its copies and launches are enqueued on."""

    state: ScorerState
    stream: torch.cuda.Stream | None


@dataclass
class _Batch:
    """A dispatched batch: per shard the [2, n_k] result (host memory; pinned
    on a card) and, on a card, the event recorded on the shard's stream
    after its copy back.  A single-device batch has one part."""

    parts: list  # [(out, event or None)]
    n: int


class Pass1Scorer:
    """Scores entries against up to two reference strands on one device, or
    with ``devices`` (:func:`make_dp_devices`) dealt over several.

    ``device`` defaults to :func:`select_device` (the card; the CPU only on
    request).  Same driving interface as the JAX engine's scorer:
    ``dispatch_entries`` / ``collect_entries`` / ``ready`` for entries,
    ``dispatch_packed`` / ``collect_arrays`` for pass-1 read batches, and
    ``batch`` / ``E`` for sizes."""

    def __init__(self, fw_s1c, rc_s1c, len1: int, submat, submat_b=None,
                 batch: int | None = None, device=None,
                 hp_seqs: tuple[str, str] | None = None, devices=None):
        refs, sms = padded_state_numpy(fw_s1c, rc_s1c, len1, submat, submat_b)
        hp = () if hp_seqs is None else hp_state_numpy(hp_seqs, len1, refs.shape[1])
        if devices is None:
            devices = [select_device() if device is None else torch.device(device)]
        self._bind([state_from_numpy(refs, sms, d, *hp) for d in devices], len1, batch)

    @classmethod
    def from_state(cls, state, len1: int, batch: int | None = None) -> "Pass1Scorer":
        """A scorer over state already on its device (state_from_numpy), or
        over a list of states, one per shard."""
        self = cls.__new__(cls)
        self._bind(state if isinstance(state, (list, tuple)) else [state], len1, batch)
        return self

    def _bind(self, states: list[ScorerState], len1: int, batch: int | None) -> None:
        self.state = states[0]
        self.hp = self.state.hp
        self.device = self.state.refs.device
        self.len1 = len1
        self.WTOT = self.state.refs.shape[1]
        self.batch = batch or default_batch()
        self.E = 2 * self.batch
        if any(st.refs.device.type == "cuda" for st in states):
            kernel_library()  # build/load now, not inside the first dispatch
        # a single device works on the current stream; shards get a stream
        # each, so that their copies and kernels may overlap
        self.shards = [
            _Shard(st, torch.cuda.Stream(st.refs.device)
                   if len(states) > 1 and st.refs.device.type == "cuda" else None)
            for st in states
        ]

    def free(self) -> None:
        """Nothing to give back: the device state goes with the scorer (the
        resident server's scorer drops its copy there)."""

    # ------------------------------------------------------------- dispatch
    def dispatch_entries(self, ref_sel, starts, ivl, s2c, lengths, smidx) -> _Batch:
        """Enqueue up to E entries; asynchronous on a card.

        ivl holds WINDOW-LOCAL [lo, hi) intervals (global band minus the
        entry's window start); entries with all-zero intervals score HIM.
        With k shards entry i goes to shard i mod k.  Returns a handle for
        :meth:`collect_entries`."""
        n = len(ref_sel)
        if n == 0:
            return _Batch([], 0)
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
        k = len(self.shards)
        dp_cuda.shards = max(dp_cuda.shards, k)
        if k == 1:
            return _Batch([self._dispatch_shard(self.shards[0], host)], n)
        parts = []
        for j, shard in enumerate(self.shards):
            part = tuple(np.ascontiguousarray(a[j::k]) for a in host)
            parts.append(self._dispatch_shard(shard, part) if len(part[0])
                         else (None, None))
        return _Batch(parts, n)

    def _dispatch_shard(self, shard: _Shard, host: tuple, score=None):
        """Score one shard's entries on its device (or, with ``score``, the
        rows ``score(*tensors)`` takes): (result [2, m] in host memory, event
        or None).  On a card the inputs are staged in pinned memory of their
        own (never reused while a copy may still read it), and copies in,
        kernel, copy out and event all go to the shard's stream in that
        order (a single device: the current stream)."""
        st = shard.state
        dev = st.refs.device
        if score is None:
            score = (partial(dp_cuda.dp_entries_hp, st.refs, st.refchr, st.hpcs, st.sms,
                             st.pengop, st.b2i)
                     if self.hp else partial(dp_cuda.dp_entries, st.refs, st.sms))
        if dev.type == "cpu":
            return score(*(torch.from_numpy(a) for a in host)), None
        with torch.cuda.device(dev):
            stream = shard.stream or torch.cuda.current_stream(dev)
            with torch.cuda.stream(stream):
                args = [torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
                        for a in host]
                out_dev = score(*args)
                out = torch.empty(tuple(out_dev.shape), dtype=torch.int32, pin_memory=True)
                out.copy_(out_dev, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
        return out, event

    def dispatch_wide(self, rows: WideRows | None) -> _Batch | None:
        """Enqueue the general-width scorer's forms (under ``-h`` its
        ``-h`` forms) on wide rows (``entries.wide_rows``; None: nothing) on
        the first shard, behind what that shard's stream holds already.
        Results via :meth:`collect_entries`: (best, aec), aec WINDOW-LOCAL
        (add the row's ``win_lo``)."""
        if rows is None:
            return None
        host = (rows.strand, rows.win_lo, rows.ivl, rows.s2c, rows.lengths)
        host = tuple(np.ascontiguousarray(a) for a in host)
        shard = self.shards[0]
        return _Batch([self._dispatch_shard(
            shard, host, partial(score_wide, shard.state, rows.full_width, rows.n_band,
                                 rows.band_classes, rows.n_strand))],
            rows.n)

    @staticmethod
    def ready(handle) -> bool:
        """True when every shard's results have landed (non-blocking); takes
        an entries handle or a packed pass-1 handle (its wide rows too)."""
        batches = [handle]
        if isinstance(handle, tuple):
            batches = [b for b in (handle[0], handle[4]) if b is not None]
        return all(event is None or event.query()
                   for batch in batches for _, event in batch.parts)

    def collect_entries(self, handle: _Batch):
        """Materialise a dispatched batch: (best, aec) int64 arrays [n] in
        the caller's order; aec is WINDOW-LOCAL (add the entry's window
        start)."""
        if not handle.parts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        k = len(handle.parts)
        arr = np.empty((2, handle.n), np.int64)
        for j, (out, event) in enumerate(handle.parts):
            if out is None:
                continue
            if event is not None:
                event.synchronize()
            arr[:, j::k] = out.numpy()
        return arr[0], arr[1]

    # ------------------------------------------------- pass-1 (two strands)
    def dispatch_packed(self, s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags):
        """Enqueue one pass-1 read batch packed by the native host engine
        (core/hostbatch.py: BatchHost.prepare): each read becomes two
        entries (fw then rc), and each WIDE read's strands rows of the
        general-width scorer (:meth:`dispatch_wide`; under ``-h``, where
        ``s2c`` holds the reads' chars, its ``-h`` form, and a read past
        ``entries.HP_WIDE_COLS`` columns none).  The entries of flagged
        reads (FLAG_SKIP / HOST_ONLY / WIDE) get empty intervals and scores
        the caller ignores; a WIDE read's scores come from its rows.
        Results via :meth:`collect_arrays`; the handle's fourth item is the
        batch's ``entries.WideRows`` (None: no wide read taken), as the
        server client's is."""
        n = len(lens)
        if n > self.batch:
            raise ValueError(f"{n} reads exceed the batch of {self.batch}")
        if n == 0:
            return _Batch([], 0), fw_ws.copy(), rc_ws.copy(), None, None
        entries = build_pass1_entries(s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags)
        batch = self.dispatch_entries(*entries)
        rows = wide_rows(flags, lens, s2c, fw_ivg, rc_ivg, hp=self.hp)
        return batch, fw_ws.copy(), rc_ws.copy(), rows, self.dispatch_wide(rows)

    def collect_arrays(self, handle):
        """Materialise a packed pass-1 batch: (fb, fa, rb, ra) int64 [n]
        with aec in GLOBAL reference coordinates, the wide reads' included."""
        batch, fw_ws, rc_ws, rows, wbatch = handle
        best, aec = self.collect_entries(batch)
        fb, fa, rb, ra = split_pass1_results(best, aec, fw_ws, rc_ws)
        if rows is not None:
            merge_wide(fb, fa, rb, ra, rows, *self.collect_entries(wbatch))
        return fb, fa, rb, ra
