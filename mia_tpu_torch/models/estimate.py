"""PSSM estimation: fit position-specific substitution matrices from data.

The reference ships three externally fitted aDNA matrices but no way to make
new ones.  This closes the loop: given an assembly (maln), count ref->read
substitutions per PSSM depth slot and strand, convert the conditional
frequencies to the reference's score convention, and write a matrix file
that `mia -s` parses (read_pssm, src/io.c:408-503).

Score convention: matrices behave like scaled log-odds; we use
score = round(100 * log2( P(read_base | ref_base) / 0.25 )), clipped to the
range the shipped matrices use, with Laplace pseudocounts.  Scores feed both
alignment and consensus directly, so a matrix fitted on one run can be used
for the next — an EM-style damage calibration loop.
"""
from __future__ import annotations

import math

import numpy as np

from ..constants import PSSM_DEPTH
from ..core.types import MapAlignment

N_DEPTH = 2 * PSSM_DEPTH + 1
_BASE_IDX = {b: i for i, b in enumerate("ACGT")}


def count_substitutions(maln: MapAlignment) -> np.ndarray:
    """[31, 4, 4] counts of (depth, ref_base, read_base) over aligned,
    non-dropped reads (revcom reads contribute to the mirrored depth with
    complemented bases, so damage stays anchored to the molecular end)."""
    counts = np.zeros((N_DEPTH, 4, 4), dtype=np.int64)
    ref = maln.ref.seq
    comp = {0: 3, 1: 2, 2: 1, 3: 0}
    for a in maln.aln_seqs:
        if a.dropped:
            continue
        span = min(a.end - a.start + 1, len(a.seq), len(a.smp))
        for off in range(span):
            rb = _BASE_IDX.get(ref[a.start + off] if a.start + off < len(ref) else "N")
            qb = _BASE_IDX.get(a.seq[off])
            if rb is None or qb is None:
                continue
            depth = ord(a.smp[off]) - ord("A")
            if not (0 <= depth < N_DEPTH):
                continue
            if a.revcom:
                depth = N_DEPTH - 1 - depth
                rb, qb = comp[rb], comp[qb]
            counts[depth, rb, qb] += 1
    return counts


def fit_pssm(counts: np.ndarray, pseudocount: float = 0.5,
             lo: int = -1000, hi: int = 300) -> np.ndarray:
    """Counts [31,4,4] -> scores [31,4,4] int (4x4 part of a PSSM)."""
    c = counts.astype(np.float64) + pseudocount
    p = c / c.sum(axis=2, keepdims=True)
    scores = np.rint(100.0 * np.log2(p / 0.25)).astype(np.int64)
    return np.clip(scores, lo, hi)


def write_matrix_file(path: str, scores: np.ndarray) -> None:
    """Write scores [31,4,4] in the reference's matrix-file layout (15 begin
    blocks, MIDDLE, 15 end blocks) so `mia -s` can load it."""
    def block(f, title, mat):
        f.write(f"# Matrix for position: {title}\n")
        for r in range(4):
            f.write("\t".join(str(int(v)) for v in mat[r]) + "\t\n")
        f.write("\n")

    with open(path, "w") as f:
        for d in range(PSSM_DEPTH):
            block(f, str(d + 1), scores[d])
        block(f, "MIDDLE", scores[PSSM_DEPTH])
        for d in range(PSSM_DEPTH + 1, N_DEPTH):
            block(f, str(d - N_DEPTH), scores[d])


def estimate_from_maln(maln: MapAlignment, out_path: str | None = None,
                       pseudocount: float = 0.5) -> np.ndarray:
    """One-call damage-model fit; returns the [31,4,4] score array and
    optionally writes a loadable matrix file."""
    scores = fit_pssm(count_substitutions(maln), pseudocount)
    if out_path:
        write_matrix_file(out_path, scores)
    return scores
