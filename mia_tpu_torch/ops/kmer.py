"""K-mer seeding / banding (src/kmer.c).

The reference builds a direct-address table of 4^k position lists (<=128
positions per k-mer, k <= 14) over the wrapped forward and revcom reference
strands, then per read unmask a +/-ALIGN_MASK_BUFFER band around every shared
k-mer hit; >= KMER_SATURATE total hits opens the whole mask
(new_kmer_filter, src/kmer.c:239-331).

Here the table build is fully vectorised: 2-bit pack via a sliding dot with
powers of 4, validity via a boolean convolution, then one lexsort groups
positions by k-mer index.
"""
from __future__ import annotations

import numpy as np

from ..constants import ALIGN_MASK_BUFFER, KMER_SATURATE, MAX_KMER_LEN, MAX_KMER_POS

_CODE = np.full(256, -1, dtype=np.int64)
for _i, _b in enumerate("ACGT"):
    _CODE[ord(_b)] = _i
    _CODE[ord(_b.lower())] = _i
_ISLOWER = np.zeros(256, dtype=bool)
for _c in range(ord("a"), ord("z") + 1):
    _ISLOWER[_c] = True


def _windows_valid(values: np.ndarray, k: int) -> np.ndarray:
    """For bool array `values`, windows of length k that are all True."""
    c = np.cumsum(np.concatenate(([0], values.astype(np.int64))))
    return (c[k:] - c[:-k]) == k


def kmer_codes(seq: str, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(codes, valid) for every window start; code is the 2-bit packing of
    kmer2inx (src/kmer.c:18-48), valid=False when any char is not ACGT."""
    b = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    n = len(b)
    if n < k:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    code = _CODE[b]
    ok = code >= 0
    valid = _windows_valid(ok, k)
    # sliding 2-bit pack: cumulative base-4 polynomial trick
    weights = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    safe = np.where(ok, code, 0)
    win = np.lib.stride_tricks.sliding_window_view(safe, k)
    codes = win @ weights
    return codes, valid


class KmerPosArray:
    """Direct-address k-mer -> positions index (init_kpa/populate_kpa,
    src/kmer.c:90-168), stored CSR-style."""

    def __init__(self, seq: str, k: int, soft_mask: bool = False):
        if k > MAX_KMER_LEN:
            raise ValueError(f"Cannot use kmer length greater than {MAX_KMER_LEN}")
        self.k = k
        codes, valid = kmer_codes(seq, k)
        if soft_mask and len(codes):
            b = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
            anylower = ~_windows_valid(~_ISLOWER[b], k)
            valid = valid & ~anylower
        pos = np.flatnonzero(valid).astype(np.int64)
        codes = codes[pos] if len(pos) else codes[:0]
        # stable sort by code keeps positions in ascending order per k-mer,
        # matching the reference's insertion order
        order = np.argsort(codes, kind="stable")
        codes_s, pos_s = codes[order], pos[order]
        # cap at MAX_KMER_POS entries per k-mer (first MAX_KMER_POS kept,
        # src/kmer.c:75-77)
        if len(codes_s):
            first = np.flatnonzero(np.concatenate(([True], codes_s[1:] != codes_s[:-1])))
            runpos = np.arange(len(codes_s)) - np.repeat(first, np.diff(np.append(first, len(codes_s))))
            keep = runpos < MAX_KMER_POS
            codes_s, pos_s = codes_s[keep], pos_s[keep]
        self.codes = codes_s
        self.positions = pos_s
        # CSR offsets over distinct codes via searchsorted at query time
        self.uniq, self.starts = np.unique(self.codes, return_index=True)
        self.counts = np.diff(np.append(self.starts, len(self.codes)))

    def lookup(self, code: int) -> np.ndarray:
        i = np.searchsorted(self.uniq, code)
        if i >= len(self.uniq) or self.uniq[i] != code:
            return self.positions[:0]
        return self.positions[self.starts[i] : self.starts[i] + self.counts[i]]

    def lookup_many(self, codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorised lookup: returns (hit_counts, flat positions grouped per
        query in order)."""
        i = np.searchsorted(self.uniq, codes)
        i = np.clip(i, 0, max(len(self.uniq) - 1, 0))
        found = len(self.uniq) > 0
        hit = (self.uniq[i] == codes) if found else np.zeros(len(codes), bool)
        cnts = np.where(hit, self.counts[i] if found else 0, 0)
        return hit, cnts, i


def _expand_hits(kpa: KmerPosArray, codes: np.ndarray, frag_pos: np.ndarray):
    """All (ref_pos, frag_pos) hit pairs for the given k-mer codes, in scan
    order.  Returns (ref_positions, frag_positions, total_hits)."""
    if len(codes) == 0 or len(kpa.uniq) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 0
    idx = np.searchsorted(kpa.uniq, codes)
    idx_c = np.clip(idx, 0, len(kpa.uniq) - 1)
    hit = kpa.uniq[idx_c] == codes
    reps = np.where(hit, kpa.counts[idx_c], 0)
    total = int(reps.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 0
    sel = reps > 0
    reps_s = reps[sel]
    starts_rep = np.repeat(kpa.starts[idx_c[sel]], reps_s)
    base = np.repeat(np.cumsum(reps_s) - reps_s, reps_s)
    offs = np.arange(total) - base
    ref_pos = kpa.positions[starts_rep + offs]
    fp = np.repeat(frag_pos[sel], reps_s)
    return ref_pos, fp, total


def _union_intervals(mask: np.ndarray, lo: np.ndarray, hi: np.ndarray, n: int):
    """mask[lo_i : hi_i+1] = 1 for all intervals, via a difference array."""
    if len(lo) == 0:
        return
    diff = np.zeros(n + 1, dtype=np.int64)
    np.add.at(diff, lo, 1)
    np.add.at(diff, np.minimum(hi + 1, n), -1)
    mask[:n] = np.where(np.cumsum(diff[:n]) > 0, 1, mask[:n])


def new_kmer_filter(
    seq: str,
    frag_len: int,
    fkpa: KmerPosArray | None,
    rkpa: KmerPosArray | None,
    kmer_len: int,
    fw_mask: np.ndarray,
    rc_mask: np.ndarray,
    fw_len1: int,
    rc_len1: int,
) -> int:
    """Populate per-strand column masks for one read; returns nonzero iff the
    read shares any k-mer with the reference (src/kmer.c:239-331).

    Vectorised: all of the read's k-mers look up at once (searchsorted over
    the CSR index), hit bands union through a difference array, and the
    saturation rule collapses to 'total hits >= KMER_SATURATE opens the full
    mask' (the reference saturates at the first prefix reaching the cap and
    later bands add nothing, so the final mask is identical)."""
    if kmer_len < 0:
        fw_mask[:fw_len1] = 1
        # reference quirk: second memset also writes fwa's mask
        # (src/kmer.c:252-253); lengths are equal in practice
        fw_mask[:rc_len1] = 1
        return 1

    fw_mask[:fw_len1] = 0
    rc_mask[:rc_len1] = 0

    if frag_len < kmer_len:
        return 0

    codes, valid = kmer_codes(seq[:frag_len], kmer_len)
    fpos = np.flatnonzero(valid)
    codes_v = codes[fpos]

    num_f = num_r = 0
    if fkpa is not None:
        ref_pos, fp, num_f = _expand_hits(fkpa, codes_v, fpos)
        if num_f >= KMER_SATURATE:
            fw_mask[:fw_len1] = 1
        elif num_f:
            lo = np.maximum(ref_pos - fp - ALIGN_MASK_BUFFER, 0)
            hi = np.minimum(ref_pos + (frag_len - fp) + ALIGN_MASK_BUFFER, fw_len1 - 1)
            _union_intervals(fw_mask, lo, hi, fw_len1)
    if rkpa is not None:
        ref_pos, fp, num_r = _expand_hits(rkpa, codes_v, fpos)
        if num_r >= KMER_SATURATE:
            rc_mask[:rc_len1] = 1
        elif num_r:
            lo = np.maximum(ref_pos - fp - ALIGN_MASK_BUFFER, 0)
            hi = np.minimum(ref_pos + frag_len - fp - 1 + ALIGN_MASK_BUFFER, rc_len1 - 1)
            _union_intervals(rc_mask, lo, hi, rc_len1)
    return num_f + num_r
