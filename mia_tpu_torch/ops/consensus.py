"""PSSM-weighted consensus calling as vectorised scatter-adds.

The reference recomputes per-column BaseCounts by rescanning every read for
every column (add_base/find_consensus, src/map_align.c:229-391;
consensus loop src/mia.c:551-599) — O(ref_len * num_reads).  Here one pass
flattens all (read, offset) pairs and scatter-adds counts and PSSM score
contributions per column: O(total aligned bases), and the per-column count
tensors are exactly the arrays a multi-host run psum-merges
(:mod:`mia_tpu_torch.parallel.sharded`).

Column state layout (per column): counts[A,C,G,T,gap], cov, score[A,C,G,T].
Decision rules replicate find_consensus exactly, including the 'later base
wins score ties' promotion chain and the >=50% gap rule.
"""
from __future__ import annotations

import math

import numpy as np

from ..constants import MIN_SC_DIFF_CONS, MIN_SCORE_CONS, PERC4GAP

_A, _C, _G, _T = 0, 1, 2, 3
_BASE_IDX = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    _BASE_IDX[ord(_b)] = _i
_BASE_IDX[ord("-")] = 4
_SUB_IDX = np.full(256, 4, dtype=np.int8)  # base2inx: everything else -> 4
for _i, _b in enumerate("ACGT"):
    _SUB_IDX[ord(_b)] = _i


class ColumnCounts:
    """Dense per-column consensus accumulators over ``n`` columns."""

    def __init__(self, n: int):
        self.n = n
        self.counts = np.zeros((n, 5), dtype=np.int64)  # A C G T gap
        self.cov = np.zeros(n, dtype=np.int64)
        self.scores = np.zeros((n, 4), dtype=np.int64)

    def add_bases(
        self,
        col: np.ndarray,
        chars: np.ndarray,
        depths: np.ndarray,
        strands: np.ndarray,
        fpsm: np.ndarray,
        rpsm: np.ndarray,
    ) -> None:
        """Scatter-add a batch of observations (add_base,
        src/map_align.c:229-263).

        col: int column index; chars: uint8 base chars; depths: PSSM depth
        0..30; strands: bool (True=revcom -> rpsm).
        """
        bi = _BASE_IDX[chars]
        counted = bi >= 0
        n5 = self.n * 5
        self.counts += np.bincount(
            col[counted].astype(np.int32) * 5 + bi[counted].astype(np.int32),
            minlength=n5,
        ).reshape(self.n, 5)
        self.cov += np.bincount(col, minlength=self.n)
        nongap = chars != ord("-")
        if np.any(nongap):
            sub = _SUB_IDX[chars[nongap]].astype(np.int32)
            d = depths[nongap].astype(np.int32)
            s = strands[nongap].astype(np.int32)
            c = col[nongap]
            # one fancy-index gather from a [2, 31, 5, 4] strand/depth/sub LUT
            # (transposed so the candidate-base axis comes out last)
            lut = np.stack(
                (fpsm[:, :4, :].transpose(0, 2, 1), rpsm[:, :4, :].transpose(0, 2, 1))
            )
            contrib = lut[s, d, sub]  # [n, 4] int
            # bincount-with-weights is exact here (|score sums| << 2^53)
            for k in range(4):
                self.scores[:, k] += np.bincount(
                    c, weights=contrib[:, k], minlength=self.n
                ).astype(np.int64)


def find_consensus_cols(cc: ColumnCounts, cons_code: int):
    """Vectorised find_consensus (src/map_align.c:294-391) over all columns.

    Returns (cons_chars uint8 [n], frac_agree float64 [n]).
    """
    n = cc.n
    cov = cc.cov
    counts = cc.counts
    scores = cc.scores

    out = np.full(n, ord("N"), dtype=np.uint8)
    frac = np.zeros(n, dtype=np.float64)

    zero_cov = cov == 0
    safe_cov = np.where(zero_cov, 1, cov)
    gap_frac = counts[:, 4] / safe_cov
    is_gap = ~zero_cov & (gap_frac >= PERC4GAP / 100.0)

    # promotion chain over A,C,G,T with >= (later base wins ties)
    top0 = scores[:, _A].copy()
    top1 = np.full(n, -(2**31), dtype=np.int64)
    max_base = np.full(n, ord("A"), dtype=np.uint8)
    fr = counts[:, _A] / safe_cov

    for b, ch in ((_C, ord("C")), (_G, ord("G")), (_T, ord("T"))):
        s = scores[:, b]
        promote = s >= top0
        if b == _C:
            # C's else-branch unconditionally overwrites top1
            top1 = np.where(promote, top0, s)
        else:
            top1 = np.where(promote, top0, np.maximum(top1, np.where(s >= top1, s, top1)))
        top0 = np.where(promote, s, top0)
        max_base = np.where(promote, ch, max_base)
        fr = np.where(promote, counts[:, b] / safe_cov, fr)

    if cons_code == 2:
        ok = (top0 >= 0) | ((top0 - MIN_SC_DIFF_CONS) > top1)
    else:
        ok = top0 >= MIN_SCORE_CONS
    base_out = np.where(ok, max_base, ord("N")).astype(np.uint8)

    out = np.where(is_gap, ord("-"), np.where(zero_cov, ord("N"), base_out)).astype(np.uint8)
    frac = np.where(is_gap, gap_frac, np.where(zero_cov, 0.0, fr))
    return out, frac


def find_phred_qscore(scores4: np.ndarray) -> int:
    """Phred-style consensus quality from per-base aggregate scores
    (src/map_align.c:152-206)."""
    sA, sC, sG, sT = (int(x) for x in scores4)
    if sA >= sC and sA >= sG and sA >= sT:
        best, rest = sA, (sC, sG, sT)
    elif sC >= sG and sC >= sT:
        best, rest = sC, (sA, sG, sT)
    elif sG >= sT:
        best, rest = sG, (sA, sC, sT)
    else:
        best, rest = sT, (sA, sC, sG)
    p_best = math.pow(2.0, best / 100.0)
    denom = sum(math.pow(2.0, r / 100.0) for r in rest)
    p_correct = p_best / denom
    if p_correct >= 1.7976931348623157e308:
        p_correct = 1.7976931348623157e308
    return int(10 * math.log10(p_correct))
