"""Myers O(ND) wavefront of ccheck: the plain PyTorch version and the
aligner around it.

Port of :mod:`mia_tpu.ops.myers_jax`.  :func:`waves_plain` is a line-by-line
port of ``myers_jax._waves``: the same run-length table R[k, x] (length of
the IUPAC-matching run starting at (x, y = x - k)), the same wave loop over
one lane per diagonal, and the same sentinel ``_NEG`` in lanes outside the
valid range, so its history equals the JAX program's value for value.  R is
built in chunks of diagonals: ``torch.cummin`` returns int64 indices beside
its values, and one pass over ccheck's 3,323 x 16,619 table would need well
over 1 GB on the CPU.

:func:`myers_diff_torch` is ``myers_jax.myers_diff_jax`` on the port: the
waves run on the device (``ops.myers_cuda.waves``: the plain version for a
CPU tensor, the hand-written kernel ``csrc/myers_waves.cu`` for a CUDA
tensor), and the host walks the history back with
``mia_tpu_torch.ops.myers._backtrace``, so (distance, bt_a, bt_b) are
string-identical to :func:`mia_tpu_torch.ops.myers.myers_diff`.
"""
from __future__ import annotations

import numpy as np
import torch

from .myers import UINT_MAX, Mode, _backtrace
from ..utils.encoding import bitmap_seq

_NEG = -(2**30)
R_CHUNK = 256  # diagonals of R built at once


def _run_table(bm_a: torch.Tensor, bm_b: torch.Tensor, len_a: int, len_b: int,
               ks: torch.Tensor) -> torch.Tensor:
    """R [n_diag, LB] int32: the matching-run length starting at (x, y = x - k),
    0 where out of range or mismatched (reversed cummin of the next mismatch)."""
    LB = bm_b.shape[0]
    xs = torch.arange(LB, dtype=torch.int32, device=bm_b.device)[None, :]
    R = torch.empty((ks.shape[0], LB), dtype=torch.int32, device=bm_b.device)
    for c0 in range(0, ks.shape[0], R_CHUNK):
        ys = xs - ks[c0 : c0 + R_CHUNK, None]
        in_rng = (xs < len_b) & (ys >= 0) & (ys < len_a)
        ys_c = ys.clamp(0, bm_a.shape[0] - 1)
        match = in_rng & ((bm_b[None, :] & bm_a[ys_c]) != 0)
        nxt = torch.where(match, torch.full_like(xs, LB), xs)
        next0 = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values, [1])
        R[c0 : c0 + R_CHUNK] = next0 - xs
    return R


def waves_plain(bm_a: torch.Tensor, bm_b: torch.Tensor, len_a: int, len_b: int, *,
                maxd: int, mode_is_prefix: bool, mode_has_prefix: bool):
    """Run up to ``maxd`` waves; returns (found_d, found_k, hist).

    bm_a [max(len_a, 1)], bm_b [max(len_b, 1)]: IUPAC bitmaps
    (``bitmap_seq``) of any integer dtype, on one device.  hist
    [maxd + 1, 2 maxd + 1] int32 on that device: hist[d, k + maxd] = furthest
    x on diagonal k after wave d, ``_NEG`` (or a sentinel step above it) where
    the diagonal is out of range; found_d == maxd means no alignment."""
    dev = bm_a.device
    bm_a = bm_a.to(torch.int32)
    bm_b = bm_b.to(torch.int32)
    n_diag = 2 * maxd + 1
    ks = torch.arange(-maxd, maxd + 1, dtype=torch.int32, device=dev)
    LB = bm_b.shape[0]
    R = _run_table(bm_a, bm_b, len_a, len_b, ks)
    neg = torch.full((n_diag,), _NEG, dtype=torch.int32, device=dev)
    neg1 = neg[:1]

    def snake(x):
        # extend each diagonal's x by its match run (one gather per lane)
        xc = x.clamp(0, LB - 1)
        run = torch.gather(R, 1, xc[:, None].long())[:, 0]
        ok = (x >= 0) & (x < LB)
        return torch.where(ok, x + run, x)

    def accept(x, d):
        # reference accept rule + the y <= len_a guard (mia_tpu_torch.ops.myers)
        y = x - ks
        valid = (ks >= max(-d, -len_a)) & (ks <= min(d, len_b))
        ok_a = (y == len_a) | mode_is_prefix
        ok_b = (x == len_b) | mode_has_prefix
        return valid & ok_a & ok_b & (y <= len_a)

    def first(acc):
        # smallest accepting diagonal, or None
        hit = torch.nonzero(acc)
        return int(hit[0, 0]) - maxd if hit.numel() else None

    hist = torch.full((maxd + 1, n_diag), _NEG, dtype=torch.int32, device=dev)

    # wave 0: x = snake from 0 on diagonal 0
    x0 = torch.where(ks == 0, torch.zeros_like(neg), neg)
    x0 = torch.where(ks == 0, snake(x0), x0)
    hist[0] = x0
    k0 = first(accept(x0, 0))
    found_d, found_k = (0, k0) if k0 is not None else (maxd, maxd + 1)

    d, v = 1, x0
    while found_d >= maxd and d < maxd:
        # candidates from the previous wave (myers_jax._waves): down =
        # v[k-1] + 1, up = v[k+1], straight = v[k] + 1
        up = torch.cat([v[1:], neg1])
        down = torch.cat([neg1, v[:-1]])
        inner = (ks > -d) & (ks < d)
        x = torch.maximum(
            torch.where(ks > -d, down + 1, neg),
            torch.maximum(torch.where(ks < d, up, neg), torch.where(inner, v + 1, neg)),
        )
        valid = (ks >= max(-d, -len_a)) & (ks <= min(d, len_b))
        x = snake(torch.where(valid, x, neg))
        hist[d] = x
        k = first(accept(x, d))
        if k is not None:
            found_d, found_k = d, k
        d, v = d + 1, x
    return found_d, found_k, hist


def bitmaps(seq_a: str, seq_b: str) -> tuple[np.ndarray, np.ndarray]:
    """Both sequences' uint8 IUPAC bitmaps, an empty one padded to one zero
    (as ``myers_diff_jax`` pads it)."""
    out = []
    for s in (seq_a, seq_b):
        bm = np.asarray(bitmap_seq(s), np.uint8)
        out.append(bm if len(bm) else np.zeros(1, np.uint8))
    return out[0], out[1]


def myers_diff_torch(seq_a: str, mode: Mode, seq_b: str, maxd: int, device=None):
    """Drop-in replacement for :func:`mia_tpu_torch.ops.myers.myers_diff` with the
    waves on ``device`` (default :func:`~mia_tpu_torch.utils.torchcfg.select_device`);
    identical return values."""
    from ..utils.torchcfg import select_device
    from . import myers_cuda

    len_a, len_b = len(seq_a), len(seq_b)
    maxd = min(maxd, len_a + len_b)
    if maxd <= 0:
        return UINT_MAX, "", ""
    dev = select_device() if device is None else torch.device(device)
    bm_a, bm_b = (torch.from_numpy(b).to(dev) for b in bitmaps(seq_a, seq_b))
    d, k, hist = myers_cuda.waves(
        bm_a, bm_b, len_a, len_b, maxd=int(maxd),
        mode_is_prefix=(mode == Mode.IS_PREFIX),
        mode_has_prefix=(mode == Mode.HAS_PREFIX),
    )
    if d == maxd:
        return UINT_MAX, "", ""
    hist = hist[: d + 1].cpu().numpy()
    # vee[d] layout on host: index k+d over 2d+1 entries
    vee = [hist[dd, maxd - dd : maxd + dd + 1] for dd in range(d + 1)]
    x = int(hist[d, k + maxd])
    return d, *_backtrace(seq_a, seq_b, vee, d, k, x, x - k)
