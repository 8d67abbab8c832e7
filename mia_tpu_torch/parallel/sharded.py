"""Multi-device execution: data-parallel read scoring + summed consensus.

Port of :mod:`mia_tpu.parallel.sharded`.  The mapping is the same: the
reference's per-read loop is embarrassingly parallel, so reads shard across
devices on a ``dp`` axis while the reference codes and PSSMs replicate;
per-column counts accumulate on each device and are added up over ``dp``;
the consensus call then runs on ``sp`` column blocks, and the blocks are
concatenated into the next reference.

What changed from the TPU version, and why: there is no ``shard_map`` and
no compiled program.  A mesh is a [n_dp, n_sp] grid of ``torch.device``\\ s,
and the step is a single-controller loop over it (as ``mia_tpu`` is
single-controller too): each dp shard launches its kernels on its own
device, the ``all_gather`` a concatenation on the first device.  A grid
may name one device several times (the stand-in for XLA's virtual host
devices); the copies are then same-device copies.  The ``psum`` is no
separate step: each sp block's consensus call reads every dp shard's
counts of its columns and sums them.

Three hand-written kernels carry a step on a card: the general-width
last-row scorer (``csrc/dp_last_row.cu``, :func:`..ops.dp_cuda.dp_last_row`),
the pileup counts (``csrc/pileup_counts.cu``, :func:`pileup_counts`: a block
per tile of columns sums in shared memory and stores its tile, so a call is
one launch into memory that nobody zeroed) and the consensus call over
the dp shards' partial counts (``csrc/consensus_call.cu``,
:func:`consensus_call`: pointers to a block's columns of every part go to
one launch by value, and the kernel sums them).  Each has its plain
PyTorch version here or in ``ops/dp_torch.py``; a wrapper takes it only
for CPU tensors, launches the kernel for CUDA tensors, or raises.
``pileup_launches`` / ``pileup_plain_calls`` and ``consensus_launches`` /
``consensus_plain_calls`` count the routes.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import MIN_SCORE_CONS, PERC4GAP
from ..ops import dp_cuda
from ..ops.dp_cuda import check_tensor
from ..ops.dp_torch import batch_best_and_aec

pileup_launches = 0
pileup_plain_calls = 0
consensus_launches = 0
consensus_plain_calls = 0


def reset_counts() -> None:
    global pileup_launches, pileup_plain_calls, consensus_launches, consensus_plain_calls
    pileup_launches = 0
    pileup_plain_calls = 0
    consensus_launches = 0
    consensus_plain_calls = 0


def make_mesh(n_dp: int | None = None, n_sp: int = 1, devices=None) -> np.ndarray:
    """[n_dp, n_sp] grid of ``torch.device``: ``dp`` shards read batches,
    ``sp`` shards consensus columns.  ``devices`` defaults to every CUDA
    device and may name one device several times."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_dp is None:
        n_dp = len(devices) // n_sp
    if n_dp < 1 or n_sp < 1 or len(devices) < n_dp * n_sp:
        raise ValueError(f"a {n_dp} x {n_sp} mesh needs {n_dp * n_sp} devices, "
                         f"got {len(devices)}")
    mesh = np.empty((n_dp, n_sp), dtype=object)
    for i, d in enumerate(devices[: n_dp * n_sp]):
        mesh[i // n_sp, i % n_sp] = d
    return mesh


def consensus_from_counts(counts: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """find_consensus (cons_code 1) over columns: counts [W, 5] (A, C, G, T,
    gap), scores [W, 4] int32; returns uint8 consensus chars (semantics of
    src/map_align.c:294-391).  The coverage and the gap test's products are
    int32 and wrap, as the JAX package's are."""
    cov = counts.sum(dim=1, dtype=torch.int32)
    gap_frac_ok = counts[:, 4] * 100 >= PERC4GAP * cov
    top0 = scores[:, 0]
    max_base = torch.full_like(cov, ord("A"))
    for b, ch in ((1, ord("C")), (2, ord("G")), (3, ord("T"))):
        promote = scores[:, b] >= top0  # a tie promotes the later base
        top0 = torch.where(promote, scores[:, b], top0)
        max_base = torch.where(promote, torch.full_like(cov, ch), max_base)
    n = torch.full_like(cov, ord("N"))
    base = torch.where(top0 >= MIN_SCORE_CONS, max_base, n)
    out = torch.where(cov == 0, n, torch.where(gap_frac_ok, torch.full_like(cov, ord("-")),
                                               base))
    return out.to(torch.uint8)


def consensus_from_parts(counts, scores) -> torch.Tensor:
    """The consensus of summed partial accumulators: the int32 sum of the
    lists ``counts`` ([n, 5] each) and ``scores`` ([n, 4] each), wrapping
    as the JAX package's ``psum`` over dp does, then
    :func:`consensus_from_counts`.  The plain version of
    :func:`consensus_call`."""
    total_c, total_s = counts[0], scores[0]
    for c, s in zip(counts[1:], scores[1:]):
        total_c, total_s = total_c + c, total_s + s
    return consensus_from_counts(total_c, total_s)


# the most parts one call sums (csrc/consensus_call.cu kMaxParts, checked by
# the loader): 32 pairs of pointers are 512 B of the launch's parameters
CONSENSUS_MAX_PARTS = 32


def consensus_call(counts, scores, cols: slice = slice(None)) -> torch.Tensor:
    """:func:`consensus_from_parts` on the tensors' device, over the columns
    ``cols`` (a slice with step 1, default all) of every part.  ``counts``
    is one [W, 5] int32 tensor or a list of 1 to
    :data:`CONSENSUS_MAX_PARTS` of them, ``scores`` the matching [W, 4]
    tensor or list; every part contiguous, on one device -> [len(cols)]
    uint8.  The kernel reads the columns in place (pointers into the parts,
    no copy).  One part is :func:`consensus_from_counts` itself."""
    global consensus_launches, consensus_plain_calls
    if isinstance(counts, torch.Tensor):
        counts, scores = [counts], [scores]
    if not 1 <= len(counts) <= CONSENSUS_MAX_PARTS or len(scores) != len(counts):
        raise ValueError(f"consensus_call: {len(counts)} counts and {len(scores)} scores, "
                         f"want 1 to {CONSENSUS_MAX_PARTS} of each")
    dev = counts[0].device
    W = counts[0].shape[0]
    for p, (c, s) in enumerate(zip(counts, scores)):
        check_tensor(f"counts[{p}]", c, torch.int32, (W, 5), dev)
        check_tensor(f"scores[{p}]", s, torch.int32, (W, 4), dev)
    start, stop, step = cols.indices(W)
    if step != 1:
        raise ValueError(f"consensus_call: columns {cols}, want a step of 1")
    n = max(stop - start, 0)
    if dev.type == "cpu":
        consensus_plain_calls += 1
        return consensus_from_parts([c[start:stop] for c in counts],
                                    [s[start:stop] for s in scores])
    if dev.type != "cuda":
        raise ValueError(f"consensus_call: no kernel for device {dev}")
    from ..utils.torchcfg import kernel_library

    lib = kernel_library()
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    ptrs = ctypes.c_void_p * len(counts)
    with dp_cuda.current_device(dev):
        rc = lib.mia_consensus_call(ptrs(*(c.data_ptr() + 20 * start for c in counts)),
                                    ptrs(*(s.data_ptr() + 16 * start for s in scores)),
                                    len(counts), n, out.data_ptr(),
                                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"consensus_call kernel launch failed: CUDA error {rc}")
    consensus_launches += 1
    return out


def block_parts(counts, scores, dev, cols: slice) -> tuple[list, list, slice]:
    """The arguments of a :func:`consensus_call` on ``dev`` over the columns
    ``cols`` of the parts: the parts and ``cols`` themselves when every part
    is on ``dev`` (the kernel reads the block in place), else each part's
    rows ``cols`` copied to ``dev`` and every column of those, so that only
    the block's columns cross between devices."""
    if all(t.device == dev for t in (*counts, *scores)):
        return counts, scores, cols
    return [c[cols].to(dev) for c in counts], [s[cols].to(dev) for s in scores], slice(None)


def _pileup_counts(s2c, lengths, starts, depths, strands, fpsm, rpsm, W: int):
    """Scatter-add ungapped pileup contributions into per-column counts
    [W, 5] and PSSM-weighted scores [W, 4] (int32): the device half of
    add_base (src/map_align.c:229-263), with ``index_add_``.  Rows past a
    read's length and columns outside [0, W) add nothing; code 4 counts in
    the fifth column and scores ``psm[d, x, 4]``.  The plain version of
    :func:`pileup_counts`."""
    B, L = s2c.shape
    dev = s2c.device
    i64 = torch.int64
    rows = torch.arange(L, device=dev)[None, :]
    cols = starts.to(i64)[:, None] + rows
    base = s2c.to(i64)
    valid = ((rows < lengths.to(i64)[:, None]) & (cols >= 0) & (cols < W)
             & (base >= 0) & (base <= 4))
    cols_v, base_v = cols[valid], base[valid]
    counts = torch.zeros(W * 5, dtype=torch.int32, device=dev)
    counts.index_add_(0, cols_v * 5 + base_v,
                      torch.ones(cols_v.shape[0], dtype=torch.int32, device=dev))
    # psm[depth, x, base] for x in 0..3, strand-selected
    psm = torch.stack([fpsm, rpsm]).to(torch.int32)
    s = strands.to(i64)[:, None].expand(B, L)[valid]
    d = depths.to(i64).clamp(0, 30)[valid]
    contrib = psm[s, d, :4, base_v]
    scores = torch.zeros((W, 4), dtype=torch.int32, device=dev)
    scores.index_add_(0, cols_v, contrib)
    return counts.reshape(W, 5), scores


# compile-time constants of csrc/pileup_counts.cu (checked by the loader):
# reads a block lists per round, and its widest tile of columns
PILEUP_ROUND = 2048
PILEUP_TILE = 128


def _check_pileup(dev, B, L, s2c, depths, lengths, starts, strands, fpsm, rpsm) -> None:
    """One pass over the inputs: each must have the dtype, shape and device
    the kernel takes and be contiguous (:func:`check_tensor` names the first
    that does not)."""
    i32 = torch.int32
    for name, t, dtype, shape in (
            ("s2c", s2c, i32, (B, L)), ("depths", depths, i32, (B, L)),
            ("lengths", lengths, i32, (B,)), ("starts", starts, i32, (B,)),
            ("strands", strands, torch.bool, (B,)), ("fpsm", fpsm, i32, (31, 5, 5)),
            ("rpsm", rpsm, i32, (31, 5, 5))):
        check_tensor(name, t, dtype, shape, dev)


def pileup_counts(s2c, lengths, starts, depths, strands, fpsm, rpsm, W: int):
    """:func:`_pileup_counts` on the tensors' device: s2c, depths [B, L]
    int32, lengths, starts [B] int32, strands [B] bool, fpsm, rpsm
    [31, 5, 5] int32, contiguous -> (counts [W, 5], scores [W, 4]) int32.
    From the kernel the two are views of one allocation of 9 W values, every
    one of them written by the launch (no fill): they share storage."""
    global pileup_launches, pileup_plain_calls
    dev = s2c.device
    B, L = s2c.shape
    _check_pileup(dev, B, L, s2c, depths, lengths, starts, strands, fpsm, rpsm)
    if dev.type == "cpu":
        pileup_plain_calls += 1
        return _pileup_counts(s2c, lengths, starts, depths, strands, fpsm, rpsm, W)
    if dev.type != "cuda":
        raise ValueError(f"pileup_counts: no kernel for device {dev}")
    from ..utils.torchcfg import kernel_library

    lib = kernel_library()
    acc = torch.empty(9 * W, dtype=torch.int32, device=dev)
    counts, scores = acc.as_strided((W, 5), (5, 1), 0), acc.as_strided((W, 4), (4, 1), 5 * W)
    if W == 0:
        return counts, scores
    out = acc.data_ptr()
    with dp_cuda.current_device(dev):
        rc = lib.mia_pileup_counts(
            s2c.data_ptr(), depths.data_ptr(), lengths.data_ptr(), starts.data_ptr(),
            strands.data_ptr(), fpsm.data_ptr(), rpsm.data_ptr(), B, L, W,
            out, out + 20 * W,  # counts, scores (4-byte values)
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"pileup_counts kernel launch failed: CUDA error {rc}")
    pileup_launches += 1
    return counts, scores


def make_assembly_step(mesh: np.ndarray, sg5: bool = True):
    """Build the sharded one-iteration assembly step over a
    :func:`make_mesh` grid.

    Per step: (1) every dp shard scores its rows of the read batch against
    the replicated reference with the last-row kernel; (2) its reads pile
    into per-column counts and score sums, ungapped, ending at ``aec``, on
    the forward strand; (3) the consensus call runs on ``sp`` column blocks
    of ``W // sp`` columns, each on its shard's device, and on the tail past
    them on the first device, each call taking every dp shard's counts and
    scores of its columns and adding them up over ``dp`` itself; (4) the
    blocks are concatenated on the first device.

    Returns ``step(s1c [W], mask [B, W], s2c [B, L], lengths [B],
    depths [B, L], fpsm, rpsm) -> (best [B], aec [B], cons [W] uint8)`` over
    numpy arrays (or tensors), with the results as tensors on the first
    device.  The batch splits into ``n_dp`` contiguous runs of rows, as
    ``shard_map`` splits a ``P("dp")`` axis.  ``n_dp`` is at most
    :data:`CONSENSUS_MAX_PARTS`."""
    n_dp, n_sp = mesh.shape
    first = mesh[0, 0]
    if n_dp > CONSENSUS_MAX_PARTS:
        raise ValueError(f"a step sums at most {CONSENSUS_MAX_PARTS} dp shards, got {n_dp}")

    def on(a, dtype, dev):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=dev, dtype=dtype).contiguous()

    def step(s1c, mask, s2c, lengths, depths, fpsm, rpsm):
        B, W = mask.shape
        i32 = torch.int32
        bounds = [(B * k) // n_dp for k in range(n_dp + 1)]
        bests, aecs, counts, scores = [], [], [], []
        for k in range(n_dp):
            dev = mesh[k, 0]
            rows = slice(bounds[k], bounds[k + 1])
            s2c_k, len_k = on(s2c[rows], i32, dev), on(lengths[rows], i32, dev)
            dep_k, fpsm_k = on(depths[rows], i32, dev), on(fpsm, i32, dev)
            last = dp_cuda.dp_last_row(on(s1c, i32, dev), on(mask[rows], torch.bool, dev),
                                       s2c_k, len_k, dep_k, fpsm_k, sg5=sg5)
            best, aec = batch_best_and_aec(last)  # earliest column on ties
            # ungapped placement ending at aec; strand fixed fw for the
            # device pileup (the host pipeline refines via traceback)
            starts = aec - len_k + 1
            strands = torch.zeros(len(len_k), dtype=torch.bool, device=dev)
            c_k, s_k = pileup_counts(s2c_k, len_k, starts, dep_k, strands, fpsm_k,
                                     on(rpsm, i32, dev), W)
            bests.append(best.to(first))
            aecs.append(aec.to(first))
            counts.append(c_k)
            scores.append(s_k)

        # sequence-parallel consensus: each sp shard calls one column block,
        # the first device the tail; each dp shard's columns of the block go
        # to the call's device (read in place where they already are), and
        # the kernel sums them as it reads them
        blk = W // n_sp
        calls = [(mesh[0, j], slice(j * blk, (j + 1) * blk)) for j in range(n_sp)]
        cons = [consensus_call(*block_parts(counts, scores, dev, cols)).to(first)
                for dev, cols in calls + [(first, slice(n_sp * blk, W))]]
        return torch.cat(bests), torch.cat(aecs), torch.cat(cons)

    return step
