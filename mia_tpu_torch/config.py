"""Per-run configuration: everything mia's getopt CLI exposes
(src/mia_main.c:477-594) as one dataclass, runtime-tunable."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .constants import DEF_N, DEF_S, NEANDERTAL_ADAPTER


@dataclass
class MiaConfig:
    ref_fn: str = ""
    frag_fn: str = ""
    maln_root: str = "assembly.maln.iter"
    submat_fn: Optional[str] = None          # -s
    circular: bool = False                   # -c
    iterate: bool = True                     # -i / -n
    final_only: bool = False                 # -F
    cons_code: int = 1                       # -p
    hard_cut: int = 0                        # -H
    slope: float = DEF_S                     # -S
    intercept: float = DEF_N                 # -N
    score_cut_set: bool = False
    repeat_filt: bool = False                # -u
    repeat_qual_filt: bool = False           # -U
    just_outer_coords: bool = True           # -A clears this
    collapse: bool = False                   # -C
    tolerance: int = 0                       # -C<tol>
    adapter: str = NEANDERTAL_ADAPTER        # -a
    do_adapter_trimming: bool = False        # -T
    kmer_filt_len: int = -1                  # -k
    soft_mask: bool = False                  # -M
    distant_ref: bool = False                # -D
    hp_special: bool = False                 # -h
    ids_file: Optional[str] = None           # -I
    make_fastq: bool = False                 # -q
    fastq_out_fn: str = ""
    # engine selection (byte-identical outputs on every path):
    #   "jax"    (default) — batched device scoring with host traceback.
    #     Never slower than the native engine: batches are WORK-STOLEN by
    #     the threaded C++ solver until the device program is warm
    #     (core/assembler.py), and a resident scoring server
    #     (mia_tpu.serve) removes the per-process backend init entirely.
    #   "native" — threaded batched C++ host engine only.
    #   "numpy"  — exact per-read host path (oracle).
    engine: str = "jax"
    # data-parallel device count for --engine jax: entries shard over a
    # ("dp",) mesh; 0 = single device, -1 = all local devices
    dp_devices: int = 0
    # --profile: phase timers + counters dumped as one JSON line on stderr
    profile: bool = False
