"""Wrappers of the fused entry scorer kernels (``csrc/dp_entries.cu``).

``dp_entries`` replaces ``mia_tpu/ops/dp_pallas.py::_dp_kernel`` (launched by
``pallas_last_row``) together with the XLA set-up and argmax around it in
``mia_tpu/core/jax_engine.py::_entries_core``: packed entries go in, one
(best, aec) pair per entry comes out.  ``dp_entries_hp`` is the same
kernel's ``-h`` instantiation, replacing ``dp_jax.batch_last_row_hp`` with
its set-up ``jax_engine._entries_core_hp``: reads come as raw chars, and the
homopolymer-discounted gap candidates join each row's max.  On an H100 the
kernel is bound by the integer pipe's instructions per DP cell, not bytes
(an entry reads a few hundred bytes).  So it keeps each entry's rows in the
registers of one warp (12 columns per lane), folds every add-then-max into
one of Hopper's DPX instructions and every mask into the data, reads a
cell's substitution score with one shared-memory load from a table laid out
for it, and joins the lanes with warp shuffles: 15.25 machine instructions a
cell in the row loop (35.2 before; ``python -m mia_tpu_torch.utils.sass``
counts them).  Under ``-h`` one staged row and two per-column arrays per
warp live in shared memory, lane-major so that no access conflicts; see the
source for the layout.

Tensors on the CPU go to the plain versions,
:func:`mia_tpu_torch.ops.dp_torch.entries_core_plain` and
:func:`~mia_tpu_torch.ops.dp_torch.entries_core_hp_plain`.  CUDA tensors go
to the kernel, or the call raises: there is no fallback.
The general form of the same recurrence, any width and the whole last row
out, is ``dp_last_row`` (``csrc/dp_last_row.cu``, at the end of this module):
one block per read, 34 columns a thread in registers, one barrier a row, for
rows of up to 17,408 columns; wider rows take the same file's wide form.
``dp_last_row_strand`` and, under ``-h``, ``dp_last_row_hp`` score pass
1's WIDE reads in several forms, each row's window read from the scorer's
strand state, (best, first column of the best) out: the band form
(``csrc/dp_band.cu``, 1, 2, 4 or 8 warps a row) for rows whose band takes
at most 3,072 columns (``entries.BAND_ROW_COLS``), on those columns only;
the strand form (``csrc/dp_strand.cu``, a cluster of CTAs a row, with and
without ``-h``) for bands of up to 18,432 columns (``entries.STRAND_COLS``:
whole strands); and the full form for the rest, at their widest window:
``dp_last_row`` and an argmax, under ``-h`` the ``-h`` instantiation of
``dp_last_row``'s register form, up to 17,408 columns (wider ones stay with
the native solve, ``entries.HP_WIDE_COLS``), which pass 1 no longer gives a
row: every ``-h`` row it takes fits the strand form.
``kernel_launches`` / ``plain_calls``, ``hp_kernel_launches`` /
``hp_plain_calls``, ``last_row_launches`` / ``last_row_plain_calls``,
``last_row_band_launches`` / ``last_row_band_plain_calls``,
``last_row_strand_launches`` / ``last_row_strand_plain_calls``,
``last_row_hp_launches`` / ``last_row_hp_plain_calls`` (the ``-h`` full
form), ``last_row_hp_band_launches`` / ``last_row_hp_band_plain_calls`` and
``last_row_hp_strand_launches`` / ``last_row_hp_strand_plain_calls`` count
the two routes of each (``last_row_wide_launches``: the launches of the
wide form among them; ``last_row_rows`` / ``last_row_band_rows`` /
``last_row_strand_rows`` and ``last_row_hp_rows`` /
``last_row_hp_band_rows`` / ``last_row_hp_strand_rows``: the wide rows each
form took;
``last_row_band_multi_rows`` / ``last_row_hp_band_multi_rows``: the band
rows on more than one warp); ``shards`` is the largest
number of device shards one dispatch of the scorer was dealt over
(``core.torch_engine.Pass1Scorer``, 1 on a single device).  Both kernels share one
library (``torchcfg.kernel_library``) with the consensus column counts
(``csrc/column_counts.cu``) and ccheck's Myers wavefront
(``csrc/myers_waves.cu``), whose wrappers use :func:`check_tensor` too.
"""
from __future__ import annotations

import contextlib

import torch

from ..core.entries import BAND_WARPS, HP_WIDE_COLS, L_MAX, MAX_INTERVALS

from .dp_torch import (
    batch_best_and_aec,
    batch_last_row,
    depths_for,
    entries_core_hp_plain,
    entries_core_plain,
    last_row_band_plain,
    last_row_hp_band_plain,
    last_row_hp_plain,
    last_row_hp_strand_plain,
    last_row_strand_plain,
    wide_device_inputs,
)

kernel_launches = 0
plain_calls = 0
hp_kernel_launches = 0
hp_plain_calls = 0
shards = 0
last_row_launches = 0
last_row_wide_launches = 0
last_row_plain_calls = 0
last_row_rows = 0
last_row_band_launches = 0
last_row_band_plain_calls = 0
last_row_band_rows = 0
last_row_band_multi_rows = 0
last_row_strand_launches = 0
last_row_strand_plain_calls = 0
last_row_strand_rows = 0
last_row_hp_launches = 0
last_row_hp_plain_calls = 0
last_row_hp_rows = 0
last_row_hp_band_launches = 0
last_row_hp_band_plain_calls = 0
last_row_hp_band_rows = 0
last_row_hp_band_multi_rows = 0
last_row_hp_strand_launches = 0
last_row_hp_strand_plain_calls = 0
last_row_hp_strand_rows = 0


def reset_counts() -> None:
    global kernel_launches, plain_calls, hp_kernel_launches, hp_plain_calls, shards
    global last_row_launches, last_row_wide_launches, last_row_plain_calls
    global last_row_rows, last_row_band_launches, last_row_band_plain_calls, last_row_band_rows
    global last_row_hp_launches, last_row_hp_plain_calls, last_row_hp_rows
    global last_row_hp_band_launches, last_row_hp_band_plain_calls, last_row_hp_band_rows
    global last_row_band_multi_rows, last_row_hp_band_multi_rows
    global last_row_strand_launches, last_row_strand_plain_calls, last_row_strand_rows
    global last_row_hp_strand_launches, last_row_hp_strand_plain_calls, last_row_hp_strand_rows
    kernel_launches = 0
    plain_calls = 0
    hp_kernel_launches = 0
    hp_plain_calls = 0
    shards = 0
    last_row_launches = 0
    last_row_wide_launches = 0
    last_row_plain_calls = 0
    last_row_rows = 0
    last_row_band_launches = 0
    last_row_band_plain_calls = 0
    last_row_band_rows = 0
    last_row_hp_launches = 0
    last_row_hp_plain_calls = 0
    last_row_hp_rows = 0
    last_row_hp_band_launches = 0
    last_row_hp_band_plain_calls = 0
    last_row_hp_band_rows = 0
    last_row_band_multi_rows = 0
    last_row_hp_band_multi_rows = 0
    last_row_strand_launches = 0
    last_row_strand_plain_calls = 0
    last_row_strand_rows = 0
    last_row_hp_strand_launches = 0
    last_row_hp_strand_plain_calls = 0
    last_row_hp_strand_rows = 0


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
                 device: torch.device) -> None:
    """Raise unless ``t`` has the dtype, shape and device a kernel takes and
    is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


_NO_SWITCH = contextlib.nullcontext()


def current_device(dev: torch.device):
    """Context in which ``dev`` is the current CUDA device (a launch goes to
    a stream of the current device): nothing to switch where it already is."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return _NO_SWITCH
    return torch.cuda.device(dev)


def _check_entries(refs, sms, ref_sel, starts, ivl, s2x, s2x_dtype, lengths, smidx):
    """Check one batch's state and per-entry tensors; returns (device, E, L)."""
    dev = refs.device
    E, L = s2x.shape
    check_tensor("refs", refs, torch.int8, (2, refs.shape[1]), dev)
    check_tensor("sms", sms, torch.int32, (2, 31, 5, 5), dev)
    check_tensor("ref_sel", ref_sel, torch.int8, (E,), dev)
    check_tensor("starts", starts, torch.int32, (E,), dev)
    check_tensor("ivl", ivl, torch.int32, (E, MAX_INTERVALS, 2), dev)
    check_tensor("reads", s2x, s2x_dtype, (E, L), dev)
    check_tensor("lengths", lengths, torch.int32, (E,), dev)
    check_tensor("smidx", smidx, torch.int8, (E,), dev)
    if not 1 <= L <= L_MAX:
        raise ValueError(f"reads: {L} rows, want 1..{L_MAX}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"dp_entries: no kernel for device {dev}")
    return dev, E, L


def _launch_into(name: str, out: torch.Tensor, call) -> None:
    """Launch a kernel that writes its pairs into ``out`` by ``call(library,
    stream)`` on the current stream of ``out``'s device; raise on a refused
    launch."""
    from ..utils.torchcfg import kernel_library

    lib = kernel_library()
    with current_device(out.device):
        rc = call(lib, torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _launch(name: str, dev: torch.device, E: int, call) -> torch.Tensor:
    """Allocate the [2, E] result on ``dev`` and launch the kernel by
    ``call(library, result pointer, stream)`` (:func:`_launch_into`)."""
    out = torch.empty((2, E), dtype=torch.int32, device=dev)
    if E:
        _launch_into(name, out, lambda lib, stream: call(lib, out.data_ptr(), stream))
    return out


def dp_entries(refs, sms, ref_sel, starts, ivl, s2c, lengths, smidx) -> torch.Tensor:
    """(best, aec) per entry as [2, E] int32, aec window-local.

    refs [2, WTOT] int8, sms [2, 31, 5, 5] int32, ref_sel [E] int8,
    starts [E] int32, ivl [E, 16, 2] int32, s2c [E, L] int8 (L <= 256),
    lengths [E] int32, smidx [E] int8; all on one device, contiguous."""
    global kernel_launches, plain_calls
    dev, E, L = _check_entries(refs, sms, ref_sel, starts, ivl, s2c, torch.int8,
                               lengths, smidx)
    if dev.type == "cpu":
        plain_calls += 1
        return entries_core_plain(refs, sms, ref_sel, starts, ivl, s2c, lengths,
                                  smidx)
    out = _launch("dp_entries", dev, E, lambda lib, o, stream: lib.mia_dp_entries(
        refs.data_ptr(), refs.shape[1], sms.data_ptr(), ref_sel.data_ptr(),
        starts.data_ptr(), ivl.data_ptr(), s2c.data_ptr(), L,
        lengths.data_ptr(), smidx.data_ptr(), o, E, stream,
    ))
    kernel_launches += 1
    return out


def dp_entries_hp(refs, refchr, hpcs, sms, pengop, b2i, ref_sel, starts, ivl, s2chr,
                  lengths, smidx) -> torch.Tensor:
    """``-h`` scoring: (best, aec) per entry as [2, E] int32, aec
    window-local.

    As :func:`dp_entries`, plus refchr [2, WTOT] uint8 reference chars,
    hpcs [2, WTOT] int32 reference run starts, pengop [11] int32 discounts,
    b2i [256] int8 char codes; the reads come as s2chr [E, L] uint8 raw
    chars (pad 0)."""
    global hp_kernel_launches, hp_plain_calls
    dev, E, L = _check_entries(refs, sms, ref_sel, starts, ivl, s2chr, torch.uint8,
                               lengths, smidx)
    check_tensor("refchr", refchr, torch.uint8, tuple(refs.shape), dev)
    check_tensor("hpcs", hpcs, torch.int32, tuple(refs.shape), dev)
    check_tensor("pengop", pengop, torch.int32, (11,), dev)
    check_tensor("b2i", b2i, torch.int8, (256,), dev)
    if dev.type == "cpu":
        hp_plain_calls += 1
        return entries_core_hp_plain(refs, refchr, hpcs, sms, pengop, b2i, ref_sel,
                                     starts, ivl, s2chr, lengths, smidx)
    out = _launch("dp_entries_hp", dev, E, lambda lib, o, stream: lib.mia_dp_entries_hp(
        refs.data_ptr(), refchr.data_ptr(), hpcs.data_ptr(), refs.shape[1],
        sms.data_ptr(), pengop.data_ptr(), b2i.data_ptr(), ref_sel.data_ptr(),
        starts.data_ptr(), ivl.data_ptr(), s2chr.data_ptr(), L, lengths.data_ptr(),
        smidx.data_ptr(), o, E, stream,
    ))
    hp_kernel_launches += 1
    return out


# ---- the general-width last-row scorer (csrc/dp_last_row.cu) ----

# The strand form (csrc/dp_strand.cu) runs a row on a cluster of
# STRAND_CTAS CTAs of STRAND_THREADS threads, STRAND_COLS_PER_THREAD band
# columns each (entries.STRAND_COLS in all; compile-time constants, checked
# by the loader)
STRAND_CTAS = 16
STRAND_THREADS = 2048 // STRAND_CTAS
STRAND_COLS_PER_THREAD = 9

# The register form holds LAST_ROW_COLS columns a thread and LAST_ROW_THREADS
# threads a block; wider rows go to the wide form, which may ask for
# LAST_ROW_SMEM bytes of dynamic shared memory a block and keeps still wider
# rows in a scratch buffer in global memory, for at most
# LAST_ROW_SCRATCH_BLOCKS blocks.  (Compile-time constants of
# csrc/dp_last_row.cu, checked by the loader.)
LAST_ROW_COLS = 34
LAST_ROW_THREADS = 512
LAST_ROW_SMEM = 227 * 1024 - 1024
LAST_ROW_SCRATCH_BLOCKS = 264
LAST_ROW_MAX_BLOCKS = 132 * 8


def _check_last_row(dev, B, W, L, s1c, mask, s2c, lengths, depths, submat) -> None:
    """One pass over the inputs of ``dp_last_row``."""
    i32 = torch.int32
    for name, t, dtype, shape in (
            ("s1c", s1c, i32, (W,) if s1c.dim() == 1 else (B, W)),
            ("mask", mask, torch.bool, (B, W)), ("lengths", lengths, i32, (B,)),
            ("s2c", s2c, i32, (B, L)), ("depths", depths, i32, (B, L)),
            ("submat", submat, i32, (31, 5, 5))):
        check_tensor(name, t, dtype, shape, dev)
    if not 1 <= L <= L_MAX:
        raise ValueError(f"reads: {L} rows, want 1..{L_MAX}")
    if dev.type != "cuda":
        raise ValueError(f"dp_last_row: no kernel for device {dev}")


def _last_row(s1c, mask, s2c, lengths, depths, submat, sg5: bool) -> torch.Tensor:
    """Check the tensors and launch ``dp_last_row`` on a CUDA device: the
    register form where the row fits it, else the wide form (a choice by
    shape alone)."""
    global last_row_launches, last_row_wide_launches
    dev = mask.device
    B, W = mask.shape
    L = s2c.shape[1]
    _check_last_row(dev, B, W, L, s1c, mask, s2c, lengths, depths, submat)
    from ..utils.torchcfg import kernel_library

    lib = kernel_library()
    out = torch.empty((B, W), dtype=torch.int32, device=dev)
    if B == 0 or W == 0:
        return out
    wide = W > LAST_ROW_COLS * LAST_ROW_THREADS
    args = (s1c.data_ptr(), int(s1c.dim() == 2), mask.data_ptr(), s2c.data_ptr(),
            depths.data_ptr(), submat.data_ptr(), lengths.data_ptr(), B, W, L,
            int(bool(sg5)))
    with current_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if not wide:
            rc = lib.mia_dp_last_row(*args, out.data_ptr(), stream)
        else:
            # a thread takes at least 4 consecutive columns; 1,024 threads at most
            threads = min(1024, max(32, -(-W // 128) * 32))
            block_ints = 3 * W + (W + 3) // 4
            scratch = None
            blocks = min(B, LAST_ROW_MAX_BLOCKS)
            if 4 * block_ints > LAST_ROW_SMEM:
                # rows too wide for shared memory: the kernel keeps them here
                blocks = min(B, LAST_ROW_SCRATCH_BLOCKS)
                scratch = torch.empty((blocks, block_ints), dtype=torch.int32, device=dev)
            rc = lib.mia_dp_last_row_wide(
                *args, threads, blocks, None if scratch is None else scratch.data_ptr(),
                out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dp_last_row kernel launch failed: CUDA error {rc}")
    last_row_launches += 1
    last_row_wide_launches += int(wide)
    return out


def dp_last_row(s1c, mask, s2c, lengths, depths, submat, sg5: bool = True) -> torch.Tensor:
    """The DP row at each read's last row, [B, W] int32: what
    ``dp_pallas.pallas_last_row`` and ``dp_jax.batch_last_row`` compute.

    s1c [W] (shared by the batch) or [B, W] int32 codes 0..4, mask [B, W]
    bool, s2c [B, L] int32 codes (pad 4), lengths [B] int32, depths [B, L]
    int32 PSSM depth per row, submat [31, 5, 5] int32; any W, L <= 256; all
    on one device, contiguous.  CPU tensors go to the plain version
    (:func:`.dp_torch.batch_last_row`), CUDA tensors to the kernel, or the
    call raises.  ``last_row_launches`` / ``last_row_plain_calls`` count the
    two routes; ``last_row_wide_launches`` those of the launches that took
    the kernel's wide form (W past 17,408 columns)."""
    global last_row_plain_calls
    if mask.device.type == "cpu":
        last_row_plain_calls += 1
        return batch_last_row(s1c, mask, s2c, lengths, depths, submat, sg5=sg5)
    return _last_row(s1c, mask, s2c, lengths, depths, submat, sg5)


def _band_classes(band_classes, n_band: int) -> tuple[int, int, int, int]:
    """The band rows of each warp class (1, 2, 4, 8 warps a row), checked
    against ``n_band``; empty: every band row on one warp."""
    classes = tuple(int(c) for c in band_classes) or (n_band,)
    classes = classes + (0,) * (len(BAND_WARPS) - len(classes))
    if len(classes) != len(BAND_WARPS) or min(classes) < 0 or sum(classes) != n_band:
        raise ValueError(f"band_classes {band_classes}, want {len(BAND_WARPS)} counts "
                         f"summing to n_band {n_band}")
    return classes


def _check_rows(state: tuple, rows: tuple, reads: tuple[str, torch.dtype]) -> None:
    """The scorer's state ((name, tensor, dtype, shape) each) and the rows'
    five arrays of a scorer of wide rows, the reads named and typed by
    ``reads``: shapes, types, one device, L in range."""
    dev = state[0][1].device
    strand, win_lo, ivl, s2x, lengths = rows
    R, L = s2x.shape
    for what, t, dtype, shape in (
            *state,
            ("strand", strand, torch.int8, (R,)), ("win_lo", win_lo, torch.int32, (R,)),
            ("ivl", ivl, torch.int32, (R, MAX_INTERVALS, 2)),
            (reads[0], s2x, reads[1], (R, L)),
            ("lengths", lengths, torch.int32, (R,))):
        check_tensor(what, t, dtype, shape, dev)
    if not 1 <= L <= L_MAX:
        raise ValueError(f"reads: {L} rows, want 1..{L_MAX}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")


def dp_last_row_strand(refs, submat, strand, win_lo, ivl, s2c, lengths, width: int,
                       n_band: int = 0, band_classes: tuple = (),
                       n_strand: int = 0) -> torch.Tensor:
    """Scoring of rows of a whole strand window: (best, first column of the
    best) of each row's last DP row as [2, R] int32 in row order, the column
    window-local; what ``dp_jax.batch_last_row`` (sg5 on) and
    ``dp_jax.batch_best_and_aec`` compute on each row's window.

    refs [2, WTOT] int8 codes (the scorer's state), submat [31, 5, 5] int32;
    per row strand [R] int8, win_lo [R] int32 (0 <= win_lo <= WTOT), ivl
    [R, 16, 2] int32 window-local intervals, s2c [R, L] int32 read codes
    (pad 4, L <= 256), lengths [R] int32; all on one device, contiguous.
    Three forms, each on its rows, in order:

    * the first ``n_band`` rows take the band form, which scores a row's
      band columns only (``entries.band_columns`` at most
      ``entries.BAND_ROW_COLS``; a row past that gives (HIM, -1)),
      ``band_classes`` of them on 1, 2, 4 and 8 warps a row, in that order
      (``entries.band_warps``; empty: all on one warp);
    * the next ``n_strand`` take the strand form, a cluster of CTAs a row,
      over band columns too (at most ``entries.STRAND_COLS``; past it
      (HIM, -1));
    * the rest take the full form over their first ``width`` window columns
      (hi <= width): :func:`dp_last_row` on their windows and
      :func:`.dp_torch.batch_best_and_aec`.

    CPU tensors go to the plain versions
    (:func:`.dp_torch.last_row_band_plain`,
    :func:`.dp_torch.last_row_strand_plain`, :func:`.dp_torch.batch_last_row`),
    CUDA tensors to the kernels (``csrc/dp_band.cu``, ``csrc/dp_strand.cu``,
    ``csrc/dp_last_row.cu``), or the call raises.  Without full rows no
    torch operation runs on the card: the two kernels write their pairs
    into the one result."""
    global last_row_rows, last_row_band_launches, last_row_band_plain_calls
    global last_row_band_rows, last_row_band_multi_rows
    global last_row_strand_launches, last_row_strand_plain_calls, last_row_strand_rows
    dev = refs.device
    R, L = s2c.shape
    rows = (strand, win_lo, ivl, s2c, lengths)
    _check_rows((("refs", refs, torch.int8, (2, refs.shape[1])),
                 ("submat", submat, torch.int32, (31, 5, 5))), rows, ("s2c", torch.int32))
    if not (0 <= n_band and 0 <= n_strand and n_band + n_strand <= R):
        raise ValueError(f"n_band {n_band}, n_strand {n_strand}, want both in 0..{R} "
                         "together")
    classes = _band_classes(band_classes, n_band)
    n_full = R - n_band - n_strand
    if n_full and width < 1:
        raise ValueError(f"width {width}, want at least 1")
    band, strd, full = (tuple(a[lo:hi] for a in rows) for lo, hi in (
        (0, n_band), (n_band, n_band + n_strand), (n_band + n_strand, R)))
    last_row_band_rows += n_band
    last_row_band_multi_rows += n_band - classes[0]
    last_row_strand_rows += n_strand
    last_row_rows += n_full
    rest = None
    if n_full:
        s1c, mask = wide_device_inputs(refs, width, *full[:3])
        depths = depths_for(full[4], L).to(torch.int32)
        rest = torch.stack(batch_best_and_aec(
            dp_last_row(s1c, mask, full[3], full[4], depths, submat)))
    if dev.type == "cpu":
        parts = [torch.empty((2, 0), dtype=torch.int32)]
        if n_band:
            last_row_band_plain_calls += 1
            parts.append(last_row_band_plain(refs, submat, *band))
        if n_strand:
            last_row_strand_plain_calls += 1
            parts.append(last_row_strand_plain(refs, submat, *strd))
        if rest is not None:
            parts.append(rest)
        return torch.cat(parts, 1)
    if not n_band and not n_strand:
        return rest
    # each form writes its pairs into its columns of the [2, R] result,
    # whose rows are R apart
    out = torch.empty((2, R), dtype=torch.int32, device=dev)
    head = (refs.data_ptr(), refs.shape[1])
    if n_band:
        _launch_into("dp_band", out, lambda lib, stream: lib.mia_dp_band(
            *head, *(t.data_ptr() for t in band), submat.data_ptr(), *classes, L,
            out.data_ptr(), R, stream))
        last_row_band_launches += 1
    if n_strand:
        _launch_into("dp_strand", out, lambda lib, stream: lib.mia_dp_strand(
            *head, *(t.data_ptr() for t in strd), submat.data_ptr(), n_strand, L,
            out.data_ptr() + 4 * n_band, R, stream))
        last_row_strand_launches += 1
    if rest is not None:
        out[:, n_band + n_strand:] = rest
    return out


def dp_last_row_hp(refs, refchr, hpcs, submat, pengop, b2i, strand, win_lo, ivl, s2chr,
                   lengths, width: int, n_band: int = 0, band_classes: tuple = (),
                   n_strand: int = 0) -> torch.Tensor:
    """``-h`` scoring of rows of a whole strand window: (best, first column
    of the best) of each row's last DP row as [2, R] int32 in row order, the
    column window-local; what ``dp_jax.batch_last_row_hp`` and an argmax
    compute on the window ``jax_engine._entries_core_hp`` would gather.

    refs [2, WTOT] int8 codes, refchr [2, WTOT] uint8 chars, hpcs [2, WTOT]
    int32 run starts (the scorer's state), submat [31, 5, 5] int32, pengop
    [11] int32, b2i [256] int8; per row strand [R] int8, win_lo [R] int32
    (0 <= win_lo <= WTOT), ivl [R, 16, 2] int32 window-local intervals (0 <=
    lo, hi <= 17,408), s2chr [R, L] uint8 read chars (pad 0, L <= 256),
    lengths [R] int32; all on one device, contiguous.  Three forms, each on
    its rows, in order:

    * the first ``n_band`` rows take the band form, which scores a row's
      band columns only (``entries.band_columns`` at most
      ``entries.BAND_ROW_COLS``; a row past that gives (HIM, -1)),
      ``band_classes`` of them on 1, 2, 4 and 8 warps a row, in that order
      (empty: all on one warp);
    * the next ``n_strand`` take the strand form, a cluster of CTAs a row,
      over band columns too (at most ``entries.STRAND_COLS``; past it
      (HIM, -1));
    * the rest take the full form over their first ``width`` window columns
      (1..17,408; hi <= width).

    CPU tensors go to the plain versions
    (:func:`.dp_torch.last_row_hp_band_plain`,
    :func:`.dp_torch.last_row_hp_strand_plain`,
    :func:`.dp_torch.last_row_hp_plain`), CUDA tensors to the kernels
    (the ``-h`` instantiations of ``csrc/dp_band.cu`` and
    ``csrc/dp_strand.cu``, the kHp form of ``csrc/dp_last_row.cu``), or the
    call raises."""
    global last_row_hp_launches, last_row_hp_plain_calls, last_row_hp_rows
    global last_row_hp_band_launches, last_row_hp_band_plain_calls, last_row_hp_band_rows
    global last_row_hp_band_multi_rows
    global last_row_hp_strand_launches, last_row_hp_strand_plain_calls, last_row_hp_strand_rows
    dev = refs.device
    R, L = s2chr.shape
    state = tuple(refs.shape)
    rows = (strand, win_lo, ivl, s2chr, lengths)
    _check_rows((("refs", refs, torch.int8, (2, refs.shape[1])),
                 ("refchr", refchr, torch.uint8, state), ("hpcs", hpcs, torch.int32, state),
                 ("submat", submat, torch.int32, (31, 5, 5)),
                 ("pengop", pengop, torch.int32, (11,)), ("b2i", b2i, torch.int8, (256,))),
                rows, ("s2chr", torch.uint8))
    if not (0 <= n_band and 0 <= n_strand and n_band + n_strand <= R):
        raise ValueError(f"n_band {n_band}, n_strand {n_strand}, want both in 0..{R} "
                         "together")
    classes = _band_classes(band_classes, n_band)
    n_full = R - n_band - n_strand
    if n_full and not 1 <= width <= HP_WIDE_COLS:
        raise ValueError(f"width {width}, want 1..{HP_WIDE_COLS}")
    state = (refs, refchr, hpcs, submat, pengop, b2i)
    band, strd, full = (tuple(a[lo:hi] for a in rows) for lo, hi in (
        (0, n_band), (n_band, n_band + n_strand), (n_band + n_strand, R)))
    last_row_hp_band_rows += n_band
    last_row_hp_band_multi_rows += n_band - classes[0]
    last_row_hp_strand_rows += n_strand
    last_row_hp_rows += n_full
    if dev.type == "cpu":
        parts = [torch.empty((2, 0), dtype=torch.int32)]
        if n_band:
            last_row_hp_band_plain_calls += 1
            parts.append(last_row_hp_band_plain(*state, *band))
        if n_strand:
            last_row_hp_strand_plain_calls += 1
            parts.append(last_row_hp_strand_plain(*state, *strd))
        if n_full:
            last_row_hp_plain_calls += 1
            parts.append(last_row_hp_plain(*state, *full, width))
        return torch.cat(parts, 1)
    head = [t.data_ptr() for t in (refs, refchr, hpcs)] + [refs.shape[1]]
    tail = [t.data_ptr() for t in (submat, pengop, b2i)]
    # each form writes its pairs into its columns of the [2, R] result,
    # whose rows are R apart
    out = torch.empty((2, R), dtype=torch.int32, device=dev)
    if n_full:
        # the full form writes a [2, n_full] result of its own, rows n_full
        # apart
        rest = out if n_full == R else torch.empty((2, n_full), dtype=torch.int32, device=dev)
        _launch_into("dp_last_row_hp", rest, lambda lib, stream: lib.mia_dp_last_row_hp(
            *head, *(t.data_ptr() for t in full), *tail, n_full, width, L,
            rest.data_ptr(), stream))
        last_row_hp_launches += 1
        if n_full == R:
            return out
    if n_band:
        _launch_into("dp_band_hp", out, lambda lib, stream: lib.mia_dp_band_hp(
            *head, *(t.data_ptr() for t in band), *tail, *classes, L, out.data_ptr(), R,
            stream))
        last_row_hp_band_launches += 1
    if n_strand:
        _launch_into("dp_strand_hp", out, lambda lib, stream: lib.mia_dp_strand_hp(
            *head, *(t.data_ptr() for t in strd), *tail, n_strand, L,
            out.data_ptr() + 4 * n_band, R, stream))
        last_row_hp_strand_launches += 1
    if n_full:
        out[:, n_band + n_strand:] = rest
    return out
