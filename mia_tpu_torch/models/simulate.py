"""Ancient-DNA read simulator for benchmarks and integration tests.

Produces shotgun fragments from a (circular) reference with the aDNA damage
model, sequencing errors and fastq qualities — the generator behind
BASELINE.json configs 3 and 5 (100k/1M simulated damaged reads).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.encoding import revcom
from .damage import DamageModel

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_reference(length: int, seed: int = 0, gc: float = 0.44) -> str:
    rng = np.random.default_rng(seed)
    p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return _BASES[rng.choice(4, size=length, p=p)].tobytes().decode()


@dataclass
class SimConfig:
    num_reads: int = 1000
    mean_len: float = 60.0
    min_len: int = 20
    max_len: int = 150
    err_rate: float = 0.002
    # sequencing indels per base (insertions and deletions each at half
    # this rate); 0 reproduces the historical gap-free-only workloads
    indel_rate: float = 0.0
    circular: bool = True
    seed: int = 0


def simulate_reads(ref: str, cfg: SimConfig, damage: DamageModel | None = None):
    """Yield (name, seq, qual) tuples of damaged fragments of ``ref``."""
    rng = np.random.default_rng(cfg.seed)
    damage = damage or DamageModel()
    refc = np.frombuffer(ref.encode(), dtype=np.uint8)
    code = np.full(256, 0, dtype=np.int8)
    for i, b in enumerate("ACGT"):
        code[ord(b)] = i
    ref_codes = code[refc]
    n = len(ref)

    lengths = np.clip(
        rng.poisson(cfg.mean_len, cfg.num_reads), cfg.min_len, cfg.max_len
    )
    starts = rng.integers(0, n, cfg.num_reads)
    strands = rng.random(cfg.num_reads) < 0.5

    for i in range(cfg.num_reads):
        L = int(lengths[i])
        s = int(starts[i])
        if cfg.circular:
            idx = (s + np.arange(L)) % n
        else:
            s = min(s, n - L)
            idx = s + np.arange(L)
        frag = ref_codes[idx]
        if strands[i]:
            frag = (3 - frag)[::-1]  # reverse complement in code space
        frag = damage.apply(frag, rng)
        # sequencing errors
        err = rng.random(L) < cfg.err_rate
        if err.any():
            frag = frag.copy()
            frag[err] = (frag[err] + rng.integers(1, 4, err.sum())) % 4
        if cfg.indel_rate > 0:
            # per-base indels: delete the base, or insert a random base
            # before it (read length drifts accordingly)
            r = rng.random(len(frag))
            out = []
            for j, c in enumerate(frag):
                if r[j] < cfg.indel_rate / 2:
                    continue  # deletion
                if r[j] < cfg.indel_rate:
                    out.append(int(rng.integers(0, 4)))  # insertion
                out.append(int(c))
            if len(out) >= 2:
                frag = np.array(out, dtype=frag.dtype)
        L = len(frag)
        seq = _BASES[frag].tobytes().decode()
        qual = "".join(
            chr(33 + q) for q in np.clip(rng.normal(35, 4, L).astype(int), 2, 40)
        )
        strand = "-" if strands[i] else "+"
        yield f"sim{i}_{s}_{strand}", seq, qual


def write_fasta(path: str, reads) -> None:
    with open(path, "w") as f:
        for name, seq, _ in reads:
            f.write(f">{name}\n{seq}\n")


def write_fastq(path: str, reads) -> None:
    with open(path, "w") as f:
        for name, seq, qual in reads:
            f.write(f"@{name}\n{seq}\n+{name}\n{qual}\n")
