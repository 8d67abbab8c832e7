"""Base encodings, reverse complement, IUPAC bitmaps and homopolymer maps.

Mirrors the behaviour of ``base2inx`` (src/map_align.c:16-29), ``revcom_char``
(src/map_align.c:418-432), ``char_to_bitmap`` (src/myers_align.h:40-65) and
``pop_hpl_and_hps`` (src/mia.c:1193-1234), re-expressed as vectorised lookup
tables so full sequences encode in one NumPy gather.
"""
from __future__ import annotations

import numpy as np

# --- base -> substitution-matrix index -------------------------------------
# A=0 C=1 G=2 T=3 everything-else=4 (src/map_align.c:16-29)
BASE2INX = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    BASE2INX[ord(_b)] = _i

_INX2BASE = "ACGTN"


def base2inx(base: str) -> int:
    return int(BASE2INX[ord(base)])


def encode_seq(seq: str | bytes) -> np.ndarray:
    """Encode a sequence string as int8 codes 0..4 (A,C,G,T,other)."""
    buf = np.frombuffer(seq.encode() if isinstance(seq, str) else seq, dtype=np.uint8)
    return BASE2INX[buf]


# --- reverse complement -----------------------------------------------------
# IUPAC-aware complement table, mirrors revcom_char (src/map_align.c:418-432):
#   tbl = "TVGH\0\0CD\0\0M\0KN\0\0\0YSAABWXR\0" indexed by letter-'A';
#   gap '-' maps to itself; unknowns map to 'N'.
_RC_TBL = "TVGH\0\0CD\0\0M\0KN\0\0\0YSAABWXR\0"
REVCOM = np.zeros(256, dtype=np.uint8)
for _c in range(256):
    ch = chr(_c)
    if ch == "-":
        rc = "-"
    elif "A" <= ch <= "Z":
        rc = _RC_TBL[_c - ord("A")]
        rc = rc if rc != "\0" else "N"
    elif "a" <= ch <= "z":
        # C computes tbl[c-'a']+32 before the zero test, so a missing entry
        # yields chr(32) == ' ' (truthy), not 'N' (src/map_align.c:426-429).
        rc = chr(ord(_RC_TBL[_c - ord("a")]) + 32)
    else:
        rc = "N"
    REVCOM[_c] = ord(rc)


_RC_BYTES = bytes(REVCOM.tolist())


def revcom_char(base: str) -> str:
    return chr(REVCOM[ord(base)])


def revcom(seq: str) -> str:
    """Reverse complement of an IUPAC sequence string (bytes.translate: for
    the typical 60-120 bp read this is ~5x the numpy round-trip)."""
    return seq.encode("latin-1").translate(_RC_BYTES)[::-1].decode("latin-1")


# --- IUPAC ambiguity bitmaps ------------------------------------------------
# A=1 C=2 G=4 T=U=8 plus ambiguity codes (src/myers_align.h:40-65).
_BITMAP = {
    "A": 1, "C": 2, "G": 4, "T": 8, "U": 8,
    "S": 6, "W": 9, "R": 5, "Y": 10, "K": 12, "M": 3,
    "B": 14, "D": 13, "H": 11, "V": 7, "N": 15,
}
IUPAC_BITMAP = np.zeros(256, dtype=np.uint8)
for _c in range(256):
    IUPAC_BITMAP[_c] = _BITMAP.get(chr(_c & ~32) if 32 <= _c < 127 else "", 0)


def char_to_bitmap(x: str) -> int:
    return int(IUPAC_BITMAP[ord(x)])


def compatible(x: str, y: str) -> bool:
    """True if the IUPAC codes share at least one concrete base."""
    return (IUPAC_BITMAP[ord(x)] & IUPAC_BITMAP[ord(y)]) != 0


def bitmap_seq(seq: str) -> np.ndarray:
    buf = np.frombuffer(seq.encode(), dtype=np.uint8)
    return IUPAC_BITMAP[buf]


# --- homopolymer structure --------------------------------------------------

def pop_hpl_and_hps(seq: str) -> tuple[np.ndarray, np.ndarray]:
    """Per-position homopolymer (length, start) arrays.

    For ``seq='ACCGTGGTAC'``: hpl=[1,2,2,1,1,2,2,1,1,1], hps=[0,1,1,3,4,5,5,7,8,9]
    (cf. src/mia.c:1180-1234).  Vectorised with run-boundary cumsums.
    """
    n = len(seq)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    a = np.frombuffer(seq.encode(), dtype=np.uint8)
    new_run = np.ones(n, dtype=bool)
    new_run[1:] = a[1:] != a[:-1]
    run_id = np.cumsum(new_run) - 1
    starts = np.flatnonzero(new_run)
    run_len = np.diff(np.append(starts, n)).astype(np.int32)
    hps = starts[run_id].astype(np.int32)
    hpl = run_len[run_id]
    return hpl, hps


def to_upper(seq: str) -> str:
    return seq.upper()
