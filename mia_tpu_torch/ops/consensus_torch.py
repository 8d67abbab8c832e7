"""Consensus column counts on the device (the main columns of every
iteration's consensus).

Port of :mod:`mia_tpu.ops.consensus_device` (``_accum_fn``'s ``core``): one
scatter-add of the flattened observation stream into per-column one-hot
counts [n, 5], coverage [n] and PSSM-weighted candidate scores [n, 4]
(add_base, src/map_align.c:229-263), fed from the per-record arena layout of
``mia_tpu_torch.core.columns._record_arrays``:

    record r, offset k  ->  column starts[r] + k, char seq[seq_off[r] + k],
                            depth smp[smp_off[r] + k] - 'A', strand revs[r]

:func:`column_counts_plain` is the plain PyTorch version; the CUDA kernel
(``csrc/column_counts.cu``) accumulates a tile of columns per block with
int32 atomics in shared memory and adds the tile to the int64 results with
one global atomic per accumulator.  Both
are integer-exact and order-independent, so they equal the host
accumulator (``ColumnCounts.add_bases``) bit for bit.  Unlike the TPU path
there are no static shapes, observation buckets or int32 bound: sums are
int64 from the start.

:func:`column_counts` sends CPU tensors to the plain version and CUDA
tensors to the kernel, or raises: there is no fallback.
:func:`device_column_counts` is the ``device_hook`` of
``mia_tpu_torch.core.columns.consensus_assembly_string``.  ``kernel_launches`` and
``plain_calls`` count the two routes.
"""
from __future__ import annotations

import numpy as np
import torch

from .consensus import _BASE_IDX, _SUB_IDX

from .dp_cuda import check_tensor, current_device

kernel_launches = 0
plain_calls = 0


def reset_counts() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0


def column_counts_plain(seq, smp, starts, spans, seq_off, smp_off, revs, fpsm, rpsm,
                        n: int):
    """(counts [n, 5], cov [n], scores [n, 4]) int64: the observations go to
    their columns with ``index_add_``; out-of-range columns land in a trash
    column ``n`` that is dropped, as on the TPU."""
    dev = seq.device
    i64 = torch.int64
    spans = spans.to(i64)
    total = int(spans.sum())
    ridx = torch.repeat_interleave(torch.arange(len(spans), device=dev), spans)
    run0 = torch.cumsum(spans, 0) - spans
    within = torch.arange(total, device=dev) - run0[ridx]
    cols = starts.to(i64)[ridx] + within
    colc = torch.where((cols >= 0) & (cols < n), cols, torch.full_like(cols, n))
    si = (seq_off.to(i64)[ridx] + within).clamp(max=seq.numel() - 1)
    mi = (smp_off.to(i64)[ridx] + within).clamp(max=smp.numel() - 1)
    ch = seq[si].to(i64)
    d = (smp[mi].to(i64) - ord("A")).clamp(0, 30)
    s = revs[ridx].to(i64)

    cls = torch.from_numpy(_BASE_IDX.astype(np.int64)).to(dev)[ch]
    counted = cls >= 0
    counts = torch.zeros((n + 1) * 5, dtype=i64, device=dev)
    counts.index_add_(0, colc[counted] * 5 + cls[counted],
                      torch.ones(int(counted.sum()), dtype=i64, device=dev))
    cov = torch.zeros(n + 1, dtype=i64, device=dev)
    cov.index_add_(0, colc, torch.ones_like(colc))

    # lut[strand, depth, read base, candidate] per add_base's strand-specific
    # matrix choice (src/map_align.c:240-254)
    lut = torch.stack([fpsm[:, :4, :].transpose(1, 2),
                       rpsm[:, :4, :].transpose(1, 2)]).to(i64)
    sub = torch.from_numpy(_SUB_IDX.astype(np.int64)).to(dev)[ch]
    nongap = ch != ord("-")
    scores = torch.zeros((n + 1, 4), dtype=i64, device=dev)
    scores.index_add_(0, colc[nongap], lut[s[nongap], d[nongap], sub[nongap]])
    return counts.reshape(n + 1, 5)[:n], cov[:n], scores[:n]


_TABLES: dict = {}


def _char_tables(dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """_BASE_IDX and _SUB_IDX as int8 tensors on ``dev`` (made once)."""
    if dev not in _TABLES:
        _TABLES[dev] = tuple(torch.from_numpy(t.astype(np.int8)).to(dev)
                             for t in (_BASE_IDX, _SUB_IDX))
    return _TABLES[dev]


def _check_inputs(dev, R, seq, smp, starts, spans, seq_off, smp_off, revs, fpsm,
                  rpsm) -> None:
    """One pass over the inputs: each must have the dtype, shape and device
    the kernel takes and be contiguous (:func:`check_tensor` names the first
    that does not), and the arenas must not be empty."""
    i32, u8 = torch.int32, torch.uint8
    for name, t, dtype, shape in (
            ("seq", seq, u8, (seq.shape[0],)), ("smp", smp, u8, (smp.shape[0],)),
            ("starts", starts, i32, (R,)), ("spans", spans, i32, (R,)),
            ("seq_off", seq_off, i32, (R,)), ("smp_off", smp_off, i32, (R,)),
            ("revs", revs, torch.bool, (R,)), ("fpsm", fpsm, i32, (31, 5, 5)),
            ("rpsm", rpsm, i32, (31, 5, 5))):
        check_tensor(name, t, dtype, shape, dev)
    if seq.shape[0] == 0 or smp.shape[0] == 0:
        raise ValueError("column_counts: empty arena")


def column_counts(seq, smp, starts, spans, seq_off, smp_off, revs, fpsm, rpsm, n: int):
    """(counts [n, 5], cov [n], scores [n, 4]) int64 tensors on the inputs'
    device.  From the kernel the three are contiguous views of one
    allocation of 10 n values (zeroed by one fill): they share storage.

    seq [S] and smp [M] uint8 arenas (non-empty), starts, spans, seq_off,
    smp_off [R] int32, revs [R] bool, fpsm and rpsm [31, 5, 5] int32; all
    on one device, contiguous."""
    global kernel_launches, plain_calls
    dev = seq.device
    R = spans.shape[0]
    _check_inputs(dev, R, seq, smp, starts, spans, seq_off, smp_off, revs, fpsm, rpsm)
    if dev.type == "cpu":
        plain_calls += 1
        return column_counts_plain(seq, smp, starts, spans, seq_off, smp_off, revs,
                                   fpsm, rpsm, n)
    if dev.type != "cuda":
        raise ValueError(f"column_counts: no kernel for device {dev}")
    from ..utils.torchcfg import kernel_library

    lib = kernel_library()
    acc = torch.zeros(10 * n, dtype=torch.int64, device=dev)
    counts, cov, scores = acc.split_with_sizes((5 * n, n, 4 * n))
    counts, scores = counts.view(n, 5), scores.view(n, 4)
    out = acc.data_ptr()
    base_idx, sub_idx = _char_tables(dev)
    with current_device(dev):
        rc = lib.mia_column_counts(
            seq.data_ptr(), seq.shape[0], smp.data_ptr(), smp.shape[0],
            starts.data_ptr(), spans.data_ptr(), seq_off.data_ptr(),
            smp_off.data_ptr(), revs.data_ptr(), R, fpsm.data_ptr(),
            rpsm.data_ptr(), base_idx.data_ptr(), sub_idx.data_ptr(), n,
            out, out + 40 * n, out + 48 * n,  # counts, cov, scores (8-byte values)
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"column_counts kernel launch failed: CUDA error {rc}")
    kernel_launches += 1
    return counts, cov, scores


def _split_records(spans: np.ndarray, k: int) -> list[tuple[int, int]]:
    """Contiguous record ranges [lo, hi), one per shard, each holding about
    the same number of observations: the greedy fill of the JAX package's
    mesh form (a shard closes when the next record would pass its share),
    without its padding record, since the kernel takes any length."""
    share = -(-int(spans.sum()) // k)
    bounds, lo, acc, g = [], 0, 0, 0
    for r, span in enumerate(spans):
        if g < k - 1 and acc + int(span) > share and r > lo:
            bounds.append((lo, r))
            lo, acc, g = r, 0, g + 1
        acc += int(span)
    bounds.append((lo, len(spans)))
    return bounds + [(len(spans), len(spans))] * (k - len(bounds))


def device_column_counts(seq_arena, smp_arena, starts, spans, seq_off, smp_off, revs,
                         fpsm, rpsm, n, device=None, devices=None):
    """``device_hook`` for ``consensus_assembly_string``: the record arrays
    of ``columns._record_arrays`` go to ``device`` (default:
    torchcfg.select_device()), are counted there, and come back as
    (counts, cov, scores) int64 ndarrays, bit-equal to
    ``ColumnCounts.add_bases`` over the same observations.

    With ``devices`` (a list, ``core.torch_engine.make_dp_devices``) the
    records are split into one contiguous group per device by observation
    count, each group is counted on its device into accumulators of its own
    (the arenas go to every device: the offsets are global), and the
    accumulators are added on the first device: the JAX package's
    ``shard_map`` + ``psum`` form."""
    from ..utils.torchcfg import select_device

    def on(a, dtype, dev):
        t = torch.from_numpy(np.require(a, dtype, ["C", "W"]))
        return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t

    def count_on(dev, lo, hi):
        per_record = [on(a[lo:hi], t, dev) for a, t in (
            (starts, np.int32), (spans, np.int32), (seq_off, np.int32),
            (smp_off, np.int32), (revs, np.bool_))]
        return column_counts(
            on(seq_arena, np.uint8, dev), on(smp_arena, np.uint8, dev), *per_record,
            on(fpsm, np.int32, dev), on(rpsm, np.int32, dev), int(n),
        )

    if devices is None:
        dev = select_device() if device is None else torch.device(device)
        out = count_on(dev, 0, len(spans))
    else:
        devs = [torch.device(d) for d in devices]
        spans = np.asarray(spans)
        # a shard without records is skipped (the first never is)
        parts = [count_on(dev, lo, hi)
                 for k, (dev, (lo, hi)) in enumerate(zip(devs, _split_records(spans, len(devs))))
                 if hi > lo or k == 0]
        out = [torch.stack([p[i].to(devs[0]) for p in parts]).sum(0) for i in range(3)]
    return tuple(t.cpu().numpy() for t in out)
