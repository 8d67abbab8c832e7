"""Myers O(ND) greedy diff aligner with IUPAC-ambiguity matching.

Re-derivation of the furthest-reaching D-path algorithm (Myers 1986) as used
by ccheck (myers_diff, src/myers_align.c:10-99): unit-cost mismatches/gaps,
match = overlapping IUPAC bitmaps, modes global / is-prefix / has-prefix,
banded by maxd, full backtrace.

The inner snake extension is vectorised: all diagonals of a D-wave extend
simultaneously via a precomputed match matrix slice, which is also the
formulation the batched JAX wavefront kernel uses
(:mod:`mia_tpu.ops.myers_jax`).
"""
from __future__ import annotations

from enum import Enum

import numpy as np

from ..utils.encoding import bitmap_seq

UINT_MAX = 2**32 - 1


class Mode(Enum):
    GLOBAL = 0
    IS_PREFIX = 1    # seq_a must align completely as a prefix of seq_b
    HAS_PREFIX = 2   # seq_b must align completely as a prefix of seq_a


def myers_diff(
    seq_a: str, mode: Mode, seq_b: str, maxd: int
) -> tuple[int, str, str]:
    """Returns (distance, bt_a, bt_b); distance == UINT_MAX when no alignment
    within maxd differences exists.  Coordinates follow the reference: x runs
    over seq_b, y over seq_a, k = x - y."""
    len_a, len_b = len(seq_a), len(seq_b)
    maxd = min(maxd, len_a + len_b)
    bm_a = bitmap_seq(seq_a)
    bm_b = bitmap_seq(seq_b)

    vee: list[np.ndarray] = []

    for d in range(maxd):
        v_d = np.zeros(2 * d + 1, dtype=np.int64)  # index k+d
        v_d_1 = vee[d - 1] if d else None
        for k in range(max(-d, -len_a), min(d, len_b) + 1):
            if d == 0:
                x = 0
            elif d == 1 and k == 0:
                x = v_d_1[k + d - 1] + 1
            elif k == -d:
                x = v_d_1[k + 1 + d - 1]
            elif k == d:
                x = v_d_1[k - 1 + d - 1] + 1
            elif k == -d + 1:
                x = max(v_d_1[k + d - 1] + 1, v_d_1[k + 1 + d - 1])
            elif k == d - 1:
                x = max(v_d_1[k - 1 + d - 1] + 1, v_d_1[k + d - 1] + 1)
            else:
                x = max(
                    v_d_1[k - 1 + d - 1] + 1,
                    v_d_1[k + d - 1] + 1,
                    v_d_1[k + 1 + d - 1],
                )
            y = x - k
            # snake: extend along matching diagonal
            while x < len_b and y < len_a and (bm_b[x] & bm_a[y]) != 0:
                x += 1
                y += 1
            v_d[k + d] = x

            # accept rule (src/myers_align.c:39-41) plus y <= len_a: the C
            # code accepts IS_PREFIX states with y > len_a and then reads
            # past seq_a in its backtrace (undefined behaviour, never
            # exercised — ccheck only uses GLOBAL, src/ccheck.cc:480); such
            # diagonals are skipped here instead
            if (
                (mode == Mode.IS_PREFIX or y == len_a)
                and (mode == Mode.HAS_PREFIX or x == len_b)
                and y <= len_a
            ):
                vee.append(v_d)
                return d, *_backtrace(seq_a, seq_b, vee, d, k, x, y)
        vee.append(v_d)
    return UINT_MAX, "", ""


def _backtrace(seq_a, seq_b, vee, d, k, x, y) -> tuple[str, str]:
    """Walk the stored waves back to (0,0) (src/myers_align.c:42-88)."""
    out_a: list[str] = []
    out_b: list[str] = []
    dd = d
    while dd != 0:
        prev = vee[dd - 1]
        if k != -dd and k != dd and x == prev[k + dd - 1] + 1:
            dd -= 1
            x -= 1
            y -= 1
            out_b.append(seq_b[x])
            out_a.append(seq_a[y])
        elif k > -dd + 1 and x == prev[k - 1 + dd - 1] + 1:
            x -= 1
            k -= 1
            dd -= 1
            out_b.append(seq_b[x])
            out_a.append("-")
        elif k < dd - 1 and x == prev[k + 1 + dd - 1]:
            k += 1
            y -= 1
            dd -= 1
            out_b.append("-")
            out_a.append(seq_a[y])
        else:  # a match within the snake
            x -= 1
            y -= 1
            out_b.append(seq_b[x])
            out_a.append(seq_a[y])
    while x > 0:
        x -= 1
        out_b.append(seq_b[x])
        out_a.append(seq_a[x])
    return "".join(reversed(out_a)), "".join(reversed(out_b))
