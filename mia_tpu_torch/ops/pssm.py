"""Position-specific substitution matrices (PSSM) as dense arrays.

The reference stores a PSSM as ``int sm[31][5][5]`` (src/types.h:145-159):
depth slots 0..14 score the first 15 bases of a read, slot 15 ("MIDDLE") the
interior, slots 16..30 the last 15 bases.  Index order is
``sm[depth][ref_base][read_base]`` with A,C,G,T,N = 0..4.

Here a PSSM is a ``[31, 5, 5] int32`` ndarray; all transforms are pure
functions so they jit cleanly and batch over strands/depths at once.
"""
from __future__ import annotations

import numpy as np

from ..constants import (
    FLAT_MATCH,
    FLAT_MISMATCH,
    N_SCORE,
    NR_SCORE,
    PSSM_DEPTH,
)

N_DEPTH = 2 * PSSM_DEPTH + 1  # 31


def init_flatsubmat() -> np.ndarray:
    """Flat default matrix (src/pssm.c:96-126): match=200, mismatch=-600,
    read-N column=-100, ref-N row=-10 at every depth."""
    sm = np.full((N_DEPTH, 5, 5), FLAT_MISMATCH, dtype=np.int32)
    for b in range(4):
        sm[:, b, b] = FLAT_MATCH
    sm[:, :, 4] = N_SCORE
    sm[:, 4, :] = NR_SCORE
    return sm


def revcom_submat(sm: np.ndarray) -> np.ndarray:
    """Reverse-complement transform (src/pssm.c:53-93).

    Depth axis is mirrored (d -> 30-d); base axes are complemented
    (A<->T, C<->G) for rows and columns 0..3 while the N column/row keeps its
    lane: ``rc[30-d][i][j] = sm[d][comp(i)][comp(j)]`` with comp(4)=4 except
    that the N *row* complement maps j over columns (cf. the explicit table in
    the reference, where sm[d][4][j] -> rc[30-d][4][comp(j)]).
    """
    comp = np.array([3, 2, 1, 0, 4])
    out = sm[::-1][:, comp][:, :, comp]
    return np.ascontiguousarray(out)


def find_sm_depth(row: int, length: int) -> int:
    """Depth slot for read position ``row`` in a read of ``length``
    (src/pssm.c:36-46)."""
    if row < PSSM_DEPTH:
        return row
    if length - (row + 1) < PSSM_DEPTH:
        return 2 * PSSM_DEPTH - (length - (row + 1))
    return PSSM_DEPTH


def depth_vector(length: int) -> np.ndarray:
    """Vector of depth slots for every row of a read of ``length``.

    Depth depends only on (row, length) so the per-row matrix gather in the DP
    kernel becomes a single precomputed [length] index map.
    """
    rows = np.arange(length)
    from_back = length - (rows + 1)
    return np.where(
        rows < PSSM_DEPTH,
        rows,
        np.where(from_back < PSSM_DEPTH, 2 * PSSM_DEPTH - from_back, PSSM_DEPTH),
    ).astype(np.int32)


def sub_mat_score(s1i: int, s2i: int, sm: np.ndarray, row: int, length: int) -> int:
    return int(sm[find_sm_depth(row, length), s1i, s2i])
