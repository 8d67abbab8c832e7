#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mia_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

(``--kernels`` runs phases 1-5, 6a, 9, 12 and 13 only, for work on the
kernels, and prints their numbers but no result line.  ``--census [CELL
...]`` runs phases 1-2 and then each cell's traffic at its own size through
the port, counting its WIDE rows by the form and class of the scorer that
took each; no result line.  ``--band-ab ROOT [REPS]`` runs phases 1-2 and
then times the band form's one-warp rows bare with ``ROOT``'s kernel
library (a ``git archive`` of an earlier commit) and this tree's, in turns;
no result line.  ``--myers-ab FILE``
runs phases 1-2 and then times the Myers kernel of ``FILE``, an earlier
``myers_waves.cu`` with the same C interface, beside this tree's, built
also at 256 and 512 threads, on phase 9's pairs: each build held to the
plain version (found and the whole history), then the bare launches in
turns, earlier first and last; no result line.  ``--ccheck-ab FILE [PAIRS]``
runs phases 1-2 and then ccheck (``-a``, ``--engine torch``) on phase 11's
sample with ``FILE``, an earlier ``mia_tpu_torch/core/contamination.py``,
in place of this tree's, and with this tree's, in turns: PAIRS pairs
(default 10), each order in every other pair, every run held to
``--engine native``'s stdout; no result line.  ``--hp-ab ROOT [PAIRS]``
runs phases 1-2 and then whole mia ``-h`` runs (``--engine torch``) on the
``-h`` cell's traffic at seed 41 with the port of ``ROOT``, a ``git
archive`` of an earlier commit, and this tree's, in turns as ``--wide-ab``
does: every run's maln held to this tree's first, ``pass1``,
``pass1.native_finish``, the cull's and consensus's phases, the wide reads'
counters and the ``-h`` scorers' launches of both trees; no result line.
``--merge-ab ROOT [PAIRS]`` does the same for mia (``--engine
torch``) on the ``mia-hsmt-100k`` cell's traffic at seed 41 with the pass-1
merge and realignment host layer of ``ROOT`` (its ``core/entries.py``,
``core/driver.py`` and ``core/assembler.py``): pass 1, its merge, the
realignment and the realignment's classify, drain and merge for both, every
run's maln and counts held to the earlier layer's; no result line.
``--wide-ab ROOT [PAIRS]`` runs phases 1-2 and then whole mia runs
(``--engine torch``) of phase 7b's workload, the scorers of wide rows
timed by CUDA events around each call (``wide_calls_ms``), in turns with the port of
``ROOT``, a ``git archive`` of an earlier commit whose ``mia_tpu_torch``
is imported beside this tree's under another name, its own kernel and
native libraries built from its own sources: every run's maln held to this
tree's first, the wide reads' counters, ``pass1`` and its parts, and one
sampled run of each; no result line.  ``--prep-ab ROOT [PAIRS]`` does the
same on that workload for pass 1's banding, every run's maln held to this
tree's ``--engine native``: ``pass1``, ``pass1.pack_prepare`` and
``pass1.prep_wait`` of each run, then the threads of this tree's pass-1
prepare swept in turns, one sampled run of each tree, and two pairs at the
cell's 100,000 reads; no result line.)

Phases, each printing its own lines; any failure exits non-zero before the
result line.  Every reference is the port's own: its plain PyTorch versions,
its host code (``--engine native``, the host aligner, the host consensus
counts) and the committed goldens.

1. device: a CUDA card must be present; prints nvidia-smi's name and power
   limit.
2. build: the port's native host library (``mia_tpu_torch/native/``, built
   into ``mia_tpu_torch/_build/`` by ``mia_tpu_torch.io.native``) and the
   CUDA kernel library
   (``mia_tpu_torch/csrc``, one nvcc per source, all at once); prints ptxas's
   registers, spills and shared memory.
3. kernel: the fused entry scorer against its plain PyTorch version at the
   production shape (E=16384 entries, 384 columns, 256 rows), exact int32
   equality, and 32 entries against the exact host DP (dp_numpy.solve_sg);
   prints both versions' time per batch.
4. -h kernel: the same for the homopolymer (``-h``) scorer on
   homopolymer-rich reads and reference, runs of 32+ bases included.
5. consensus kernel: the column counts of >= 1M observations over 16,569
   columns (gaps, N, out-of-range columns, both strands) against the plain
   version and the host accumulator, exact; prints the three times.
6. golden: the ``kmer``, ``hp`` and ``hp_k`` golden configs under
   ``--engine torch`` must match ``tests/golden/`` byte for byte (header line
   excluded).
6a. edges: the entry scorers and the consensus counts against their plain
   versions on the adversarial inputs of ``mia_tpu_torch.testing``
   (``edge_entries``, ``edge_hp_entries``, ``edge_records``: closed windows,
   one-column bands, lane-sized intervals, the shortest and longest reads,
   ties, the ``-h`` run lengths around the row reach, records across every
   tile border, a column whose sums pass 2^32), exact; the counts also
   against the host accumulator.  Also the general-width scorer and the
   pileup counts on ``edge_last_row_inputs`` (rows of 1 to 2,300 columns,
   lengths 0 to L + 1, closed rows, bands over every thread and warp border,
   ties; shared and per-read reference, ``sg5`` on and off) and
   ``edge_pileup_inputs`` (every tile border, starts off both ends, a batch
   larger than a block's list, sums that wrap, codes outside 0..4), exact;
   both band forms on ``band_inputs`` and ``hp_band_inputs`` (each form's
   column limit and one past it, bands at columns 0 and 1, 16 one-column
   intervals, no open column, a band over both ends of a circular strand),
   exact; the strand forms on ``strand_inputs`` and ``hp_strand_inputs``
   (under ``-h`` reference runs across a 1,152-column slice border and at a
   slice's first column, a source not open, a run longer than a slice,
   read runs of 31-33); one call of ``dp_last_row_strand`` on
   ``mixed_wide_inputs`` in ``wide_rows``' order, band rows of every class,
   whole strands and rows past 18,432 band columns (the full form's route:
   its windows, the register or wide kernel, the argmax), and one of
   ``dp_last_row_hp`` on ``mixed_hp_wide_inputs`` (band rows of every
   class, strand rows, full rows), each equal to the same call on the CPU
   with exactly one launch of each form and no plain call.
   And the Myers kernel on ``edge_myers_pairs`` (lengths 0 to 65 around its
   8- and 16-base snake steps and padding, N runs, bitmap-0 characters, snakes
   ending at either or both ends, maxd 1 and clipped, all three modes,
   bitmaps past shared memory): found and the whole history against the
   plain version, ``myers_diff_torch`` against the host aligner, one launch
   a pair.
7. end to end: 20,000 simulated reads on a 16,569-column circular reference
   with ``-c -u -k 12 -s ancient.submat.solexa.pe.txt``: the port under
   ``--engine torch`` (in this process, launch counts reset just before)
   must write the same maln bytes as its own ``--engine native``, with
   scorer and consensus kernel launches, pass-1 device reads and realign
   device entries > 0, no call of a plain version and no host fallback of
   the consensus.  Both engines are timed in this process (warm) and as a
   new process; the new ``--engine torch`` process must count
   ``pass1.in_process`` (every phase but 16b runs with
   ``MIA_TORCH_SERVER=0``).
7b. wide reads: the ``mia-hsmt-100k`` cell's traffic cut to 20,000 reads at
   seed 1 (``benchmark.cells``), the port in this process with every count
   set to 0 just before and read just after: maln bytes equal to its own
   ``--engine native``, pass 1's WIDE reads on the general-width scorer,
   ``dp_last_row_strand`` (K1g: the band form for rows whose band takes at
   most 3,072 columns, on 1, 2, 4 or 8 warps a row,
   ``dp.last_row_band_launches`` > 0; the strand form for wider bands up to
   18,432 columns, whole strands, ``dp.last_row_strand_launches`` > 0; the
   full form for none, ``dp.last_row_launches`` 0; no plain call of any
   kernel, ``pass1.native_solved_wide_reads`` 0); then what phase 8c prints
   for ``-h``: rows and launches of each form and rows of each class (the
   band form's warps a row, strand, full) with their cells, rows over 384,
   512 and 3,072 band columns and whole strands, cells three ways, device
   time of the calls and of each form, each form's largest call held to its
   plain version (exact), timed through the wrapper and alone, and bound
   (the band and strand forms' over band cells, the own-window bound beside
   it); and the first maximum on the card (``batch_best_and_aec`` on tied
   rows).
7c. banding threads: the ``mia-hsmt-100k`` cell's traffic cut to one batch
   (8,192 reads at seed 1) through ``BatchHost.prepare`` on one thread, as
   pass 1 calls it, and on the default count: all six arrays equal; prints
   both times and the CPUs the process sees.
8. -h end to end: the same workload with ``-h``, in this process only,
   against ``--engine native -h``, the ``-h`` scorer's launches in place of
   the scorer's, and pass 1's WIDE reads on the general-width ``-h`` scorer
   (``dp.last_row_hp_band_launches`` and ``dp.last_row_hp_strand_launches``
   > 0, ``dp.last_row_hp_launches`` 0, every plain call 0,
   ``pass1.native_solved_wide_reads`` 0).
8c. -h wide reads: that run's ``dp_last_row_hp`` calls (K4g): rows and
   launches of each form (the band form for rows whose band takes at most
   3,072 columns, on 1, 2, 4 or 8 warps a row, the strand form for whole
   strands, the full form for none) and of each class, widths, cells
   counted as launched, over each row's own window and over its band, and
   device time (CUDA events around each call and each form's launches),
   Gcells/s; each form's largest call held to its plain version (exact),
   timed, and its bound at the DP's 14 operations a cell (the band and
   strand forms' over their band cells, with the own-window count beside
   it), as phase 7b does; the strand form must have run and the full form
   not (this workload's ``-h`` wide rows hold whole strands), and the full
   form is held and timed on the largest strand call's rows, which it took
   before.
8a. workload shapes: the largest scorer batch of phase 7, the largest of
   phase 8 and the largest consensus record set of the two, kept as the runs
   went through the wrappers: each kernel against its plain version on them
   (exact), then its time through the wrapper and alone
   (``workload_ms``, ``workload_kernel_only_ms``).
9. Myers kernel: ccheck's wavefront at full size, mt311 (16,619 columns)
   against three ~16.6 kb sequences (an mt311-derived sample with ~1%
   divergence, one with ~5%, an unrelated random one that runs every wave
   and finds no alignment), maxd = max(len) / 10: the kernel's
   (found_d, found_k, whole history) against the plain version's, exact,
   and ``myers_diff_torch`` on the card against the host ``myers_diff``
   (distance and both backtrace strings); prints per pair the waves run,
   the kernel alone (ms and us a wave), through its wrapper, the plain
   version's ms, the host aligner's s and the bound.
10. ccheck golden: the port's ccheck (``--engine torch``, in this process)
    on ``tests/golden/ccheck`` must print ``prose.txt`` and, under
    ``-T -a``, ``table_a.txt`` byte for byte, each run with one Myers
    kernel launch, scorer launches, device-realigned reads and no call of a
    plain version.
11. ccheck end to end: 9,000 reads of an mt311-derived sample and 1,000 of
    a contaminant (another resolution of mt311), assembled by the port's mia
    (``-c -u -k 12 -s ancient.submat.solexa.pe.txt``, the resolved mt311 as
    reference); ccheck on the final maln with the builtin mt311, ``-a`` and
    ``-T -a``: the port under ``--engine torch`` must print what it prints
    under ``--engine native``, byte for byte, with the launch conditions of
    phase 10 (counts set to 0 just before each run and read just after);
    prints the distance, both engines' wall times and the port's Myers and
    realignment times.
12. last-row kernel: the general-width scorer (``dp_last_row``) against its
    plain version at the JAX bench's full-width shape (B=512 reads of 30-119
    bases, W=17,024 columns, L=256 rows), reference shared by the batch and
    one per read, the whole [B, W] row exact; 32 rows against
    dp_numpy.solve_sg; prints both versions' times and the bare launch's.
13. pileup and consensus-call kernels against their plain versions at
    B=2,048, W=17,024, L=256, exact, with times; beside the pileup kernel
    the two ``index_add_`` calls of its plain version together (indices and
    terms made beforehand: ``library_ms``) and, on an earlier line, the
    ``index_add_`` of the score terms alone.  The consensus call sums dp
    parts: four pileups (whole and from column 3), one part, ``tie_counts``
    whole and cut into four parts whose running sums wrap, four parts whose
    own sums wrap, each against ``consensus_from_parts``; timed with four
    parts and one, through the wrapper and alone, and beside the step's
    earlier tail (six adds, then one part).
14. assembly step: dp=4, sp=2 with every shard on cuda:0, B=2,048 reads drawn
    from a 17,024-column reference with 5% of their bases redrawn: (best, aec)
    equal to the single-device scorer's, whose rows for the first dp shard
    equal the plain version's on these inputs, the consensus equal to a numpy
    rebuild; the three kernels' launch counts set to 0 just before and read
    just after; a second step, its ATen operations logged, holds no add over
    the dp shards' accumulators (the consensus kernel sums them).  Then the
    warm step's time and the device time of its four
    ``dp_last_row`` launches, with the scorer's register form and with its
    wide form (the kernel it had before).
15. sharded scorer and consensus counts: E=16,384 entries over 4 shards equal
    to the single scorer; the record set of phase 5 over 4 shards equal to
    one shard and to the host counts.
16. sharded end to end: the 20k-read assembly of phase 7 with a list of 4
    devices (all cuda:0) byte-identical to the single-device run, with
    ``dp.shards`` = 4, four launches where the single run had one, and no
    plain call.
16a. multi-host on one card: two processes of the port's mia CLI
   (``MIA_TORCH_*`` variables on a free local port, ``--engine torch
   --profile``, both on cuda:0) on phase 7's workload, started together on a
   cold kernel-library build: rank 0's malns equal phase 7's single-process
   run, rank 1 writes none, and each rank's profile shows device-scored
   reads, scorer and consensus launches and no plain call.  Then the same
   with ``-C2 -q out.fastq`` against one process of the port, maln and fastq
   byte for byte.  Prints each rank's wall time, ``dist.collectives`` and
   ``dist.collective_s`` beside the single-process time.
16b. resident server: ``python -m mia_tpu_torch.cli.serve`` as a new
   process on ``.smoke/srv.sock`` (time from launch to its first
   ``hello``, which must name the card, this checkout's ``build_id`` and a
   kernel library); phase 7's workload three times, each as a new client process
   of the port's mia (``--engine torch --profile``, ``MIA_TORCH_SERVER`` on
   that socket) whose import system refuses torch, jax and ``mia_tpu``:
   each writes phase 7's malns, shows ``pass1.using_server`` and
   device-scored reads, no native wide solve, and raises the server's
   ``hello`` counts of scorer, band-form (``dp_last_row_strand``) and
   consensus launches with no plain call.
   Then once with ``-h`` (phase 8's malns, ``-h`` scorer and
   ``dp_last_row_hp`` launches of the band and strand forms, none of the
   full form), two clients at once (both
   phase 7's bytes), and ``--engine native`` as a new process with torch
   refused.  Prints every wall beside phase 7's new-process walls, stops
   the server with SIGTERM and checks that its socket is gone.
17. dry run: ``mia_tpu_torch.entry.dryrun_multichip(4)``.

The last lines are a JSON line of per-kernel numbers (``ms``, the time of a
call of the kernel's wrapper, for every kernel; the plain version's time; the
bound, with padded per-read arrays counted up to each read's own length, and
what bounds it; a library call's time where one computes the same scatter;
``kernel_only_ms``, the bare launch, for every kernel; for ``myers_waves``
the 1% pair's numbers and, under ``pairs``, all three pairs' with their
waves and us a wave; for ``consensus_call`` four parts', one part's
beside them), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.  Imports nothing of JAX and nothing of
the JAX package.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import io
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")
SUBMAT = os.path.join("mia_tpu_torch", "data", "matrices", "ancient.submat.solexa.pe.txt")
E_BATCH, L_ROWS = 16384, 256
N_COLS, N_RECORDS = 16569, 20000
FW_B, FW_W = 512, 17024      # the JAX bench's full-width shape
STEP_B = 2048                # reads of one assembly step
N_SHARDS = 4

# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet): 3.35 TB/s of
# device memory; int32 outside the tensor cores at half the float32 lanes
# (64 of 128 per SM), one operation each where the sheet's 67 TFLOP/s counts
# a fused multiply-add as two: 67 / 2 / 2 = 16.75 T int32 operations a second.
PEAK_BYTES_S = 3.35e12
PEAK_INT32_S = 16.75e12
DP_OPS_PER_CELL = 14         # the JAX package's count (dp_pallas.py, cost_estimate)


def bound(bytes_moved: int, int_ops: int) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and integer operations over the int32 peak."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_S * 1e3, int_ops / PEAK_INT32_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*arrays) -> int:
    return sum(int(a.numel() * a.element_size()) if hasattr(a, "element_size")
               else int(a.nbytes) for a in arrays)


def read_bytes(lengths, *padded) -> int:
    """Bytes of the [B, L] arrays ``padded`` that lie inside a read: a row
    counts up to its read's own length, the padding after it not at all."""
    import numpy as np

    inside = int(np.clip(np.asarray(lengths, np.int64), 0, padded[0].shape[1]).sum())
    return inside * sum(int(a.element_size()) for a in padded)


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def maln_bytes(root: str) -> dict[str, bytes]:
    """Iteration files of one assembly, each without its timestamp line."""
    d, base = os.path.split(root)
    out = {}
    for fn in sorted(os.listdir(d)):
        if fn.startswith(base + "."):
            with open(os.path.join(d, fn), "rb") as f:
                out[fn[len(base):]] = b"\n".join(f.read().split(b"\n")[1:])
    return out


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn() over ``iters`` runs (CUDA events)."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def reset_counts() -> None:
    from mia_tpu_torch.cli import ccheck
    from mia_tpu_torch.ops import consensus_torch
    from mia_tpu_torch.parallel import sharded

    ccheck.reset_counts()  # Myers, scorers, ccheck's realignment
    consensus_torch.reset_counts()
    sharded.reset_counts()


def phase_build() -> None:
    from mia_tpu_torch.io import native
    from mia_tpu_torch.utils.torchcfg import build_kernels, kernel_library, ptxas_report

    t0 = time.time()
    if not native.native_available():
        raise RuntimeError(f"native library did not build: {native.build_error()}")
    t1 = time.time()
    path = build_kernels()
    kernel_library()
    t2 = time.time()
    say(f"build: native library {t1 - t0:.3f} s -> "
        f"{os.path.relpath(native.library_path(), REPO)}, CUDA kernels {t2 - t1:.3f} s -> "
        f"{os.path.relpath(path, REPO)}")
    for line in ptxas_report(path):
        say(f"build: {line}")


def check_equal(what: str, got, want) -> int:
    """Raise unless the int tensors are equal; returns max |got - want|."""
    import torch

    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        bad = torch.nonzero((got != want).flatten()).flatten()[:5]
        raise AssertionError(f"{what}: max |diff| {err} at flat indices {bad.tolist()}")
    return err


def time_pair(kernel, plain, cells: int, what: str) -> dict:
    """Kernel and plain times per batch (CUDA events, warmed up)."""
    cuda_ms(kernel, 3)
    ms = cuda_ms(kernel, 20)
    plain()
    plain_ms = cuda_ms(plain, 3)
    say(f"{what}: {ms:.4f} ms per batch ({cells / ms / 1e6:.3f} Gcells/s), plain "
        f"version {plain_ms:.4f} ms per batch ({cells / plain_ms / 1e6:.3f} Gcells/s); "
        f"{cells} cells")
    return {"ms": ms, "plain_ms": plain_ms}


def raw_dp_entries(args, hp: bool):
    """``call(library, stream)`` launching the entry scorer (its ``-h``
    instantiation under ``hp``) on a wrapper's arguments into a result
    buffer made here."""
    import torch

    E, L = args[9 if hp else 5].shape
    out = torch.empty((2, E), dtype=torch.int32, device=args[0].device)
    p = [a.data_ptr() for a in args]
    if hp:  # HP_ENTRY_KEYS: refs refchr hpcs sms pengop b2i ref_sel starts ivl s2chr lengths smidx
        return lambda lib, stream: lib.mia_dp_entries_hp(
            p[0], p[1], p[2], args[0].shape[1], p[3], p[4], p[5], p[6], p[7], p[8], p[9], L,
            p[10], p[11], out.data_ptr(), E, stream)
    return lambda lib, stream: lib.mia_dp_entries(
        p[0], args[0].shape[1], p[1], p[2], p[3], p[4], p[5], L, p[6], p[7],
        out.data_ptr(), E, stream)


def raw_column_counts(args, n: int):
    """``call(library, stream)`` launching the consensus counts on a
    wrapper's arguments into accumulators made here (never zeroed again:
    the sums are not read)."""
    import torch

    from mia_tpu_torch.ops.consensus_torch import _char_tables

    dev = args[0].device
    acc = torch.zeros(10 * n, dtype=torch.int64, device=dev)
    tables = _char_tables(dev)
    p = [a.data_ptr() for a in args]
    return lambda lib, stream: lib.mia_column_counts(
        p[0], args[0].numel(), p[1], args[1].numel(), p[2], p[3], p[4], p[5], p[6],
        args[3].shape[0], p[7], p[8], tables[0].data_ptr(), tables[1].data_ptr(), n,
        acc.data_ptr(), acc[5 * n :].data_ptr(), acc[6 * n :].data_ptr(), stream)


def phase_kernel(dev) -> dict:
    import numpy as np
    import torch

    from mia_tpu_torch import testing as T
    from mia_tpu_torch.ops import dp_cuda
    from mia_tpu_torch.ops.dp_torch import entries_core_plain

    d = T.random_entries(E_BATCH, L_ROWS, seed=11)
    args = [torch.from_numpy(d[k]).to(dev) for k in T.ENTRY_KEYS]
    got = dp_cuda.dp_entries(*args)
    want = entries_core_plain(*args)
    torch.cuda.synchronize()
    err = check_equal(f"dp_entries != plain at E={E_BATCH}", got, want)
    say(f"kernel: dp_entries == entries_core_plain on E={E_BATCH} L={L_ROWS} "
        f"(exact int32 equality; max |diff| {err})")

    o = T.oracle_entries(32, L_ROWS, seed=12)
    out = dp_cuda.dp_entries(*[torch.from_numpy(o[k]).to(dev) for k in T.ENTRY_KEYS])
    out = out.cpu().numpy()
    for e in range(32):
        ref = T.solve_sg_entry(o, e)
        if ref != (out[0, e], out[1, e]):
            raise AssertionError(f"kernel != solve_sg on oracle entry {e}: "
                                 f"{(int(out[0, e]), int(out[1, e]))} vs {ref}")
    say("kernel: dp_entries == dp_numpy.solve_sg on 32 oracle entries")
    t = time_pair(lambda: dp_cuda.dp_entries(*args), lambda: entries_core_plain(*args),
                  T.dp_cells(d["lengths"]), "kernel")
    say(f"kernel: mean read length {float(np.mean(d['lengths'])):.1f}")
    t["kernel_only_ms"] = time_raw_launch(raw_dp_entries(args, hp=False), "kernel", t["ms"], 50)
    moved = nbytes(*args[:5], *args[6:], got) + read_bytes(d["lengths"], args[5])
    return {"max_abs_err": err, **t, "library_ms": None,
            **bound(moved, DP_OPS_PER_CELL * T.dp_cells(d["lengths"]))}


def phase_hp_kernel(dev) -> dict:
    import numpy as np
    import torch

    from mia_tpu_torch import testing as T
    from mia_tpu_torch.core.entries import hp_routes_to_host
    from mia_tpu_torch.ops import dp_cuda
    from mia_tpu_torch.ops.dp_torch import entries_core_hp_plain

    d = T.random_hp_entries(E_BATCH, L_ROWS, seed=13)
    long_runs = sum(hp_routes_to_host(bytes(d["s2chr"][e, : d["lengths"][e]]).decode())
                    for e in range(E_BATCH))
    args = [torch.from_numpy(d[k]).to(dev) for k in T.HP_ENTRY_KEYS]
    got = dp_cuda.dp_entries_hp(*args)
    want = entries_core_hp_plain(*args)
    torch.cuda.synchronize()
    err = check_equal(f"dp_entries_hp != plain at E={E_BATCH}", got, want)
    say(f"hp kernel: dp_entries_hp == entries_core_hp_plain on E={E_BATCH} L={L_ROWS} "
        f"(exact int32 equality; max |diff| {err}; {long_runs} reads with a run of 32+)")

    o = T.oracle_hp_entries(32, L_ROWS, seed=14)
    out = dp_cuda.dp_entries_hp(*[torch.from_numpy(o[k]).to(dev) for k in T.HP_ENTRY_KEYS])
    out = out.cpu().numpy()
    for e in range(32):
        ref = T.solve_sg_entry(o, e)
        if ref != (out[0, e], out[1, e]):
            raise AssertionError(f"hp kernel != solve_sg on oracle entry {e}: "
                                 f"{(int(out[0, e]), int(out[1, e]))} vs {ref}")
    say("hp kernel: dp_entries_hp == dp_numpy.solve_sg (-h) on 32 oracle entries")
    t = time_pair(lambda: dp_cuda.dp_entries_hp(*args), lambda: entries_core_hp_plain(*args),
                  T.dp_cells(d["lengths"]), "hp kernel")
    say(f"hp kernel: mean read length {float(np.mean(d['lengths'])):.1f}")
    t["kernel_only_ms"] = time_raw_launch(raw_dp_entries(args, hp=True), "hp kernel", t["ms"], 50)
    # the same 14 operations a cell as the plain scorer: the bound reads the
    # DP's work, not the -h candidates on top of it
    moved = nbytes(*args[:9], *args[10:], got) + read_bytes(d["lengths"], args[9])
    return {"max_abs_err": err, **t, "library_ms": None,
            **bound(moved, DP_OPS_PER_CELL * T.dp_cells(d["lengths"]))}


def phase_consensus_kernel(dev) -> dict:
    import numpy as np
    import torch

    from mia_tpu_torch.core.columns import _record_arrays, main_column_counts
    from mia_tpu_torch import testing as T
    from mia_tpu_torch.ops import consensus_torch

    maln = T.random_records(N_COLS, N_RECORDS, seed=15)
    _, spans, starts, revs, seq, smp, seq_off, smp_off = _record_arrays(maln, True)
    n_obs = int(spans.sum())
    if n_obs < 1_000_000:
        raise AssertionError(f"consensus phase: only {n_obs} observations")
    args = [torch.from_numpy(np.require(a, t, ["C", "W"])).to(dev) for a, t in (
        (seq, np.uint8), (smp, np.uint8), (starts, np.int32), (spans, np.int32),
        (seq_off, np.int32), (smp_off, np.int32), (revs, np.bool_),
        (maln.fpsm, np.int32), (maln.rpsm, np.int32))]
    got = consensus_torch.column_counts(*args, N_COLS)
    want = consensus_torch.column_counts_plain(*args, N_COLS)
    torch.cuda.synchronize()
    err = max(check_equal(f"column_counts != plain ({name})", g, w)
              for name, g, w in zip(("counts", "cov", "scores"), got, want))
    t0 = time.time()
    host = main_column_counts(maln, exclude_dropped=True)
    host_ms = (time.time() - t0) * 1e3
    for name, g, h in zip(("counts", "cov", "scores"), got,
                          (host.counts, host.cov, host.scores)):
        if not np.array_equal(g.cpu().numpy(), h):
            raise AssertionError(f"column_counts != host main_column_counts ({name})")
    out_of_range = int(((starts < 0) | (starts + spans > N_COLS)).sum())
    say(f"consensus kernel: column_counts == column_counts_plain == host "
        f"main_column_counts on {n_obs} observations, {len(spans)} records "
        f"({out_of_range} running off the reference), {N_COLS} columns (exact)")
    cuda_ms(lambda: consensus_torch.column_counts(*args, N_COLS), 3)
    # a call is host work of a few tens of microseconds: enough of them that
    # one pause of the interpreter does not decide the mean
    ms = cuda_ms(lambda: consensus_torch.column_counts(*args, N_COLS), 200)
    plain_ms = cuda_ms(lambda: consensus_torch.column_counts_plain(*args, N_COLS), 3)
    hook_args = (seq, smp, starts, spans, seq_off, smp_off, revs, maln.fpsm, maln.rpsm,
                 N_COLS)
    consensus_torch.device_column_counts(*hook_args, device=dev)
    t0 = time.time()
    for _ in range(5):
        consensus_torch.device_column_counts(*hook_args, device=dev)
    hook_ms = (time.time() - t0) * 1e3 / 5
    say(f"consensus kernel: {ms:.4f} ms ({n_obs / ms / 1e6:.3f} G observations/s), "
        f"plain version {plain_ms:.4f} ms, host main_column_counts {host_ms:.3f} ms "
        f"(host clock, records to counts); the hook with its copies "
        f"{hook_ms:.3f} ms (host clock)")
    # one library call does the scatter alone: index_add_ of the score terms,
    # columns and terms worked out beforehand (the lookups are not in it)
    cols = torch.randint(0, N_COLS, (n_obs,), device=dev)
    terms = torch.randint(-600, 200, (n_obs, 4), device=dev)
    acc = torch.zeros((N_COLS, 4), dtype=torch.int64, device=dev)
    library_ms = cuda_ms(lambda: acc.index_add_(0, cols, terms), 200)
    say(f"consensus kernel: index_add_ of {n_obs} x 4 score terms alone "
        f"{library_ms:.4f} ms (the scatter without the lookups)")
    kernel_only_ms = time_raw_launch(raw_column_counts(args, N_COLS), "consensus kernel", ms)
    # a maln's records come sorted by start, so the ones that hit a tile sit
    # together: the same records in that order (the arenas stay, the offsets
    # are global)
    order = torch.argsort(args[2], stable=True)
    by_start = [*args[:2], *(a[order].contiguous() for a in args[2:7]), *args[7:]]
    for g, w in zip(consensus_torch.column_counts(*by_start, N_COLS), got):
        check_equal("column_counts on records sorted by start != in the given order", g, w)
    by_start_ms = cuda_ms(lambda: consensus_torch.column_counts(*by_start, N_COLS), 200)
    time_raw_launch(raw_column_counts(by_start, N_COLS),
                    "consensus kernel, records sorted by start", by_start_ms)
    # an observation is up to 6 integer adds
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "kernel_only_ms": kernel_only_ms,
            **bound(nbytes(*args, *got), 6 * n_obs)}


def phase_step_edges(dev) -> None:
    """The general-width scorer, its two band forms, its two strand forms and
    the pileup counts against their plain versions on their adversarial
    inputs, exact."""
    import numpy as np
    import torch

    from mia_tpu_torch import testing as T
    from mia_tpu_torch.core.entries import band_columns, wide_order
    from mia_tpu_torch.ops import dp_cuda
    from mia_tpu_torch.ops.dp_torch import (
        batch_last_row,
        last_row_band_plain,
        last_row_hp_band_plain,
        last_row_hp_strand_plain,
        last_row_strand_plain,
    )
    from mia_tpu_torch.parallel import sharded

    n = 0
    for seed in (0, 1):
        for shared in (True, False):
            for name, d, sg5 in T.edge_last_row_inputs(seed, shared, wide=True):
                args = [torch.from_numpy(d[k]).to(dev) for k in T.LAST_ROW_KEYS]
                check_equal(f"dp_last_row != plain on edge rows ({name}, seed {seed}, "
                            f"shared {shared}, sg5 {sg5})",
                            dp_cuda.dp_last_row(*args, sg5=sg5),
                            batch_last_row(*args, sg5=sg5))
                n += 1
    say(f"edges: dp_last_row == batch_last_row on {n} adversarial batches of 16 reads (rows "
        f"of 1 to 2,300 columns, lengths 0 to L + 1, closed rows, one-column bands, bands "
        f"over every thread and warp border, ties; shared and per read, sg5 on and off; "
        f"exact)")
    # both band forms on their edge rows, every row given to the band form
    # in wide_rows' order, by the warps each takes, the rows past 3,072
    # columns on eight (they give (HIM, -1), as the plain versions do)
    def by_warps(d: dict, keys: tuple) -> tuple[list, tuple]:
        order, classes, _ = wide_order(band_columns(d["ivl"])[1])
        rest = len(order) - sum(classes)
        return ([torch.from_numpy(np.ascontiguousarray(d[k][order] if k in keys[-5:]
                                                       else d[k])).to(dev) for k in keys],
                (*classes[:3], classes[3] + rest))

    for seed, L in ((0, 48), (1, 256)):
        d = T.band_inputs(L, seed)
        args, classes = by_warps(d, T.BAND_KEYS)
        R = len(d["lengths"])
        check_equal(f"dp_last_row_strand's band form != plain on edge rows (seed {seed})",
                    dp_cuda.dp_last_row_strand(*args, 0, R, classes),
                    last_row_band_plain(*args))
        h = T.hp_band_inputs(L, seed)
        hargs, hclasses = by_warps(h, T.HP_WIDE_KEYS)
        check_equal(f"dp_last_row_hp's band form != plain on edge rows (seed {seed})",
                    dp_cuda.dp_last_row_hp(*hargs, 0, len(h["lengths"]), hclasses),
                    last_row_hp_band_plain(*hargs))
        # the strand form on whole strands of a human-mt-sized strand
        st = T.strand_inputs(L, seed, base=16569)
        sargs = [torch.from_numpy(st[k]).to(dev) for k in T.BAND_KEYS]
        check_equal(f"dp_last_row_strand's strand form != plain on edge rows (seed {seed})",
                    dp_cuda.dp_last_row_strand(*sargs, 0, 0, (), len(st["lengths"])),
                    last_row_strand_plain(*sargs))
        # the -h strand form on its edges, whole strands of the same size
        hs = T.hp_strand_inputs(L, seed, base=16569)
        hsargs = [torch.from_numpy(hs[k]).to(dev) for k in T.HP_WIDE_KEYS]
        check_equal(f"dp_last_row_hp's strand form != plain on edge rows (seed {seed})",
                    dp_cuda.dp_last_row_hp(*hsargs, 0, 0, (), len(hs["lengths"])),
                    last_row_hp_strand_plain(*hsargs))
    # one call of every form, as pass 1 orders a call's rows: the band form's
    # four classes, the strand form's whole strands and the full form's rows
    # past 18,432 band columns, at the full rows' widest window
    m = T.mixed_wide_inputs(64, 1)
    order, mclasses, m_strand = wide_order(band_columns(m["ivl"])[1])
    margs = [torch.from_numpy(np.ascontiguousarray(m[k][order] if k in T.BAND_KEYS[2:]
                                                   else m[k])) for k in T.BAND_KEYS]
    m_band = sum(mclasses)
    m_width = int(margs[4][m_band + m_strand:, :, 1].max())
    if not (all(mclasses) and m_strand and m_band + m_strand < len(order)):
        raise AssertionError(f"edges: the mixed call lacks a form: {mclasses}, {m_strand}")
    before = {k: getattr(dp_cuda, k) for k in (
        "last_row_band_launches", "last_row_strand_launches", "last_row_launches",
        "last_row_wide_launches", "last_row_plain_calls", "last_row_band_plain_calls",
        "last_row_strand_plain_calls")}
    got = dp_cuda.dp_last_row_strand(*(a.to(dev) for a in margs), m_width, m_band, mclasses,
                                     m_strand)
    rise = {k: getattr(dp_cuda, k) - v for k, v in before.items()}
    if (rise["last_row_band_launches"], rise["last_row_strand_launches"],
            rise["last_row_launches"]) != (1, 1, 1) or any(
            rise[k] for k in rise if k.endswith("plain_calls")):
        raise AssertionError(f"edges: the mixed call's launches {rise}")
    # the same call on the CPU takes the plain versions, as it should: its
    # plain calls are the reference's, not the card's, and are not kept
    plain_counts = {k: getattr(dp_cuda, k) for k in before if k.endswith("plain_calls")}
    want = dp_cuda.dp_last_row_strand(*margs, m_width, m_band, mclasses, m_strand)
    for k, v in plain_counts.items():
        setattr(dp_cuda, k, v)
    check_equal("dp_last_row_strand != its CPU call on a call of every form", got.cpu(), want)
    say(f"edges: dp_last_row_strand on one call of every form == the same call on the CPU "
        f"(exact; {len(order)} rows: band classes {mclasses}, {m_strand} strand rows, "
        f"{len(order) - m_band - m_strand} full rows at width {m_width}, L = 64); one launch "
        f"each of the band, strand and full forms ({rise['last_row_wide_launches']} of them "
        f"the wide kernel), no plain call")
    # the same under -h: the band form's four classes, the strand form's
    # rows and full rows, one call
    hm = T.mixed_hp_wide_inputs(64, 1)
    hmargs = [torch.from_numpy(hm[k]) for k in T.HP_WIDE_KEYS]
    hsplit = (hm["width"], hm["n_band"], hm["band_classes"], hm["n_strand"])
    hp_keys = ("last_row_hp_band_launches", "last_row_hp_strand_launches", "last_row_hp_launches",
               "last_row_hp_plain_calls", "last_row_hp_band_plain_calls",
               "last_row_hp_strand_plain_calls")
    before = {k: getattr(dp_cuda, k) for k in hp_keys}
    got = dp_cuda.dp_last_row_hp(*(a.to(dev) for a in hmargs), *hsplit)
    rise = {k: getattr(dp_cuda, k) - v for k, v in before.items()}
    if tuple(rise[k] for k in hp_keys) != (1, 1, 1, 0, 0, 0):
        raise AssertionError(f"edges: the mixed -h call's launches {rise}")
    plain_counts = {k: getattr(dp_cuda, k) for k in hp_keys if k.endswith("plain_calls")}
    want = dp_cuda.dp_last_row_hp(*hmargs, *hsplit)
    for k, v in plain_counts.items():
        setattr(dp_cuda, k, v)
    check_equal("dp_last_row_hp != its CPU call on a call of every form", got.cpu(), want)
    say(f"edges: dp_last_row_hp on one call of every form == the same call on the CPU "
        f"(exact; {len(hm['lengths'])} rows: band classes {list(hm['band_classes'])}, "
        f"{hm['n_strand']} strand rows, {len(hm['lengths']) - hm['n_band'] - hm['n_strand']} "
        f"full rows at width {hm['width']}, L = 64); one launch each of the band, strand and "
        f"full forms, no plain call")
    say(f"edges: both band forms == their plain versions on 2 x {R} / "
        f"{len(h['lengths'])} edge rows (band "
        f"columns at 1, 2 and 8 warps' limit and one past it, open columns at one warp's, "
        f"bands at columns 0 and 1, touching, overlapping and empty intervals, 16 one-column "
        f"intervals, gaps of 1 and 2, no open column, past the state, reads of 1 and 2, a "
        f"band over both ends of a circular strand; -h: hp_col sources across intervals, "
        f"gaps and warps; L = 48 and 256; exact), the strand form on 2 x "
        f"{len(st['lengths'])} whole-strand rows (16,569 columns and the wrap: one and 16 "
        f"intervals, across the origin, ties, no open column, a read of 1, past the state), "
        f"the -h strand form on 2 x {len(hs['lengths'])} rows (reference runs across a "
        f"1,152-column slice border and at a slice's first column, a source not open, a run "
        f"longer than a slice with read runs of 31-33, across the origin, a tie, past the "
        f"state)")
    names = []
    for seed in (0, 1):
        for name, d, W, _ in T.edge_pileup_inputs(seed):
            args = [torch.from_numpy(d[k]).to(dev) for k in T.PILEUP_KEYS]
            for what, g, w in zip(("counts", "scores"), sharded.pileup_counts(*args, W),
                                  sharded._pileup_counts(*args, W)):
                check_equal(f"pileup_counts != plain on edge reads ({name}, {what}, "
                            f"seed {seed})", g, w)
            names.append(name)
    say(f"edges: pileup_counts == _pileup_counts on {len(names)} adversarial batches "
        f"({', '.join(names[: len(names) // 2])}; exact)")
    if (dp_cuda.last_row_plain_calls or dp_cuda.last_row_band_plain_calls
            or dp_cuda.last_row_hp_band_plain_calls or dp_cuda.last_row_hp_strand_plain_calls
            or dp_cuda.last_row_hp_plain_calls or sharded.pileup_plain_calls):
        raise AssertionError("edges: a plain version was called through a wrapper on the card")


def phase_myers_edges(dev) -> None:
    """The Myers kernel against its plain version (found and the whole
    history) and ``myers_diff_torch`` against the host aligner on
    ``edge_myers_pairs``, one launch a pair through the wrapper."""
    import torch

    from mia_tpu_torch import testing as T
    from mia_tpu_torch.ops import myers_cuda
    from mia_tpu_torch.ops.myers import Mode, myers_diff
    from mia_tpu_torch.ops.myers_torch import bitmaps, myers_diff_torch, waves_plain

    myers_cuda.reset_counts()
    n = 0
    for seed in (0, 1):
        for name, a, mode, b, maxd in T.edge_myers_pairs(seed):
            maxd = min(maxd, len(a) + len(b))
            if maxd <= 0:
                continue
            args = [torch.from_numpy(x).to(dev) for x in bitmaps(a, b)] + [len(a), len(b)]
            flags = dict(maxd=maxd, mode_is_prefix=mode == Mode.IS_PREFIX,
                         mode_has_prefix=mode == Mode.HAS_PREFIX)
            kd, kk, khist = myers_cuda.waves(*args, **flags)
            pd, pk, phist = waves_plain(*args, **flags)
            if (kd, kk) != (pd, pk):
                raise AssertionError(f"myers_waves != plain on edge pair {name} (seed {seed}): "
                                     f"found {(kd, kk)} vs {(pd, pk)}")
            check_equal(f"myers_waves history != plain on edge pair {name} (seed {seed})",
                        khist, phist)
            if myers_diff_torch(a, mode, b, maxd, device=dev) != myers_diff(a, mode, b, maxd):
                raise AssertionError(f"myers_diff_torch != host myers_diff on edge pair {name}")
            n += 1
    if (myers_cuda.kernel_launches, myers_cuda.plain_calls) != (2 * n, 0):
        raise AssertionError(f"edges: {myers_cuda.kernel_launches} Myers launches for {n} "
                             f"pairs, {myers_cuda.plain_calls} plain calls")
    say(f"edges: myers_waves == waves_plain (found, the whole history) and myers_diff_torch "
        f"== host myers_diff on {n} adversarial pairs (lengths 0-65 around the 8- and 16-base "
        f"steps, N runs, bitmap-0 characters, snakes ending at either or both ends, maxd 1 "
        f"and clipped, all three modes, 120 kb bitmaps past shared memory; exact), "
        f"{myers_cuda.kernel_launches} kernel launches")


def phase_edges(dev) -> None:
    """The redesigned kernels against their plain versions on the
    adversarial inputs of ``mia_tpu_torch.testing``, exact."""
    import numpy as np
    import torch

    from mia_tpu_torch import testing as T
    from mia_tpu_torch.core.columns import _record_arrays, main_column_counts
    from mia_tpu_torch.ops import consensus_torch, dp_cuda
    from mia_tpu_torch.ops.dp_torch import entries_core_hp_plain, entries_core_plain

    for seed in (0, 1):
        d = T.edge_entries(seed)
        args = [torch.from_numpy(d[k]).to(dev) for k in T.ENTRY_KEYS]
        check_equal(f"dp_entries != plain on edge entries (seed {seed})",
                    dp_cuda.dp_entries(*args), entries_core_plain(*args))
        h = T.edge_hp_entries(seed)
        hargs = [torch.from_numpy(np.ascontiguousarray(h[k])).to(dev) for k in T.HP_ENTRY_KEYS]
        check_equal(f"dp_entries_hp != plain on edge entries (seed {seed})",
                    dp_cuda.dp_entries_hp(*hargs), entries_core_hp_plain(*hargs))
    say(f"edges: dp_entries and dp_entries_hp == their plain versions on 2 x "
        f"{len(d['lengths'])} adversarial entries each (closed windows, one-column bands, "
        f"lane-sized and 16 intervals, column 0, reads of 0..257 rows, ties; -h runs of "
        f"1, 2, 31, 32, 33 rows, windows that start inside a reference run; exact)")
    for seed, big, bits in ((0, False, 20), (1, True, 30), (2, True, 20)):
        maln = T.edge_records(seed, big=big, bits=bits)
        n = maln.ref.seq_len
        _, spans, starts, revs, seq, smp, seq_off, smp_off = _record_arrays(maln, True)
        args = [torch.from_numpy(np.require(a, t, ["C", "W"])).to(dev) for a, t in (
            (seq, np.uint8), (smp, np.uint8), (starts, np.int32), (spans, np.int32),
            (seq_off, np.int32), (smp_off, np.int32), (revs, np.bool_),
            (maln.fpsm, np.int32), (maln.rpsm, np.int32))]
        got = consensus_torch.column_counts(*args, n)
        host = main_column_counts(maln, exclude_dropped=True)
        for name, g, w, hst in zip(("counts", "cov", "scores"), got,
                                   consensus_torch.column_counts_plain(*args, n),
                                   (host.counts, host.cov, host.scores)):
            check_equal(f"column_counts != plain on edge records ({name}, big={big})", g, w)
            if not np.array_equal(g.cpu().numpy(), hst):
                raise AssertionError(f"column_counts != host on edge records ({name})")
        if big and int(got[2].abs().max()) <= 2**32:
            raise AssertionError("edge records: no sum past 2^32")
    say(f"edges: column_counts == plain == host main_column_counts on {len(spans)} "
        f"adversarial records (every tile border, both ends, span 0, all gaps, all N; one "
        f"column's sums past 2^32, largest |score| {int(got[2].abs().max())}; exact)")
    phase_step_edges(dev)
    phase_myers_edges(dev)


class Capture:
    """Keeps the arguments of the largest call of each of the three
    wrappers while a run goes through them (the calls themselves, and
    their launch counts, are the wrappers' own)."""

    NAMES = ("dp_entries", "dp_entries_hp", "column_counts")

    def __init__(self):
        self.args: dict = {}
        self._saved: dict = {}

    def __enter__(self):
        from mia_tpu_torch.ops import consensus_torch, dp_cuda

        for name in self.NAMES:
            mod = consensus_torch if name == "column_counts" else dp_cuda
            fn = getattr(mod, name)
            self._saved[name] = (mod, fn)
            setattr(mod, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        import torch

        def size(args):  # entries, or records' observations
            return int(args[3].sum()) if name == "column_counts" else args[-1].shape[0]

        def wrapped(*args):
            if name not in self.args or size(args) > size(self.args[name]):
                self.args[name] = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                        for a in args)
            return fn(*args)

        return wrapped

    def __exit__(self, *exc):
        for name, (mod, fn) in self._saved.items():
            setattr(mod, name, fn)


def phase_workload_shapes(captured: dict) -> dict:
    """The three kernels' times at the 20k-read run's own shapes: the
    largest scorer batch of the run (and of the -h run) and its largest
    consensus; each held against its plain version first."""
    import numpy as np

    from mia_tpu_torch import testing as T
    from mia_tpu_torch.ops import consensus_torch, dp_cuda
    from mia_tpu_torch.ops.dp_torch import entries_core_hp_plain, entries_core_plain

    out = {}
    for name, fn, plain, hp in (("dp_entries", dp_cuda.dp_entries, entries_core_plain, False),
                                ("dp_entries_hp", dp_cuda.dp_entries_hp,
                                 entries_core_hp_plain, True)):
        args = captured[name]
        lengths = args[-2].cpu().numpy()
        check_equal(f"{name} != plain at the workload's batch", fn(*args), plain(*args))
        cuda_ms(lambda: fn(*args), 3)
        ms = cuda_ms(lambda: fn(*args), 20)
        cells = T.dp_cells(lengths)
        say(f"workload shapes: {name} on the 20k run's largest batch, E={len(lengths)} "
            f"L={args[-3].shape[1]}, mean read length {float(np.mean(lengths)):.1f}, "
            f"{cells} cells: {ms:.4f} ms ({cells / ms / 1e6:.3f} Gcells/s), == plain (exact); "
            f"bound {bound(0, DP_OPS_PER_CELL * cells)['bound_ms']:.4f} ms (operations)")
        raw = time_raw_launch(raw_dp_entries(args, hp), f"workload shapes: {name}", ms, 50)
        out[name] = {"workload_ms": ms, "workload_kernel_only_ms": raw}
    args = captured["column_counts"]
    n, n_obs = args[-1], int(args[3].sum())
    for g, w in zip(consensus_torch.column_counts(*args),
                    consensus_torch.column_counts_plain(*args)):
        check_equal("column_counts != plain at the workload's consensus", g, w)
    cuda_ms(lambda: consensus_torch.column_counts(*args), 3)
    ms = cuda_ms(lambda: consensus_torch.column_counts(*args), 200)
    say(f"workload shapes: column_counts on the 20k run's largest consensus, "
        f"{args[3].shape[0]} records, {n_obs} observations, {n} columns: {ms:.4f} ms, "
        f"== plain (exact)")
    raw = time_raw_launch(raw_column_counts(args[:-1], n), "workload shapes: column_counts", ms)
    out["column_counts"] = {"workload_ms": ms, "workload_kernel_only_ms": raw}
    return out


def run_mia(args: list[str], maln_root: str, engine: str, profile: bool = False) -> dict:
    """The port's mia CLI in this process; returns its profile (phases and
    counters) under ``profile``."""
    from mia_tpu_torch.cli.mia import main
    from mia_tpu_torch.utils import profiling

    extra = ["--profile"] if profile else []
    if main([*args, "-m", maln_root, "--engine", engine, *extra]) != 0:
        raise RuntimeError(f"mia --engine {engine} failed")
    return profiling.report(out=io.StringIO()) if profile else {}


def run_port(args: list[str], maln_root: str, profile: bool = False) -> dict:
    """The port's CLI in this process under ``--engine torch``."""
    return run_mia(args, maln_root, "torch", profile)


def phase_golden() -> None:
    fx = os.path.join(REPO, "tests", "fixtures")
    for name, flags in (("kmer", ["-k", "12"]), ("hp", ["-h"]), ("hp_k", ["-h", "-k", "12"])):
        root = os.path.join(WORK, name, "out.maln")
        os.makedirs(os.path.dirname(root))
        run_port(["-r", os.path.join(fx, "tr1.fna"), "-f", os.path.join(fx, "tf.fna"),
                  *flags], root)
        got = maln_bytes(root)
        want = maln_bytes(os.path.join(REPO, "tests", "golden", name, "out.maln"))
        if got != want:
            raise AssertionError(f"{name} golden differs: {sorted(got)} vs {sorted(want)}")
        say(f"golden: {name} config byte-identical to tests/golden/{name} "
            f"({len(got)} files)")


def e2e_workload() -> list[str]:
    """Writes the 20k-read workload; returns the mia arguments for it."""
    from mia_tpu_torch.models.simulate import SimConfig, random_reference, simulate_reads

    d = os.path.join(WORK, "e2e")
    os.makedirs(d)
    ref = random_reference(16569, seed=7)
    ref_fn, frag_fn = os.path.join(d, "mt.fna"), os.path.join(d, "r20k.fastq")
    with open(ref_fn, "w") as f:
        f.write(">mt_sim simulated\n")
        for i in range(0, len(ref), 70):
            f.write(ref[i : i + 70] + "\n")
    with open(frag_fn, "w") as f:
        for name, seq, qual in simulate_reads(
            ref, SimConfig(num_reads=20000, mean_len=60, seed=3)
        ):
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")
    return ["-r", ref_fn, "-f", frag_fn, "-c", "-u", "-k", "12",
            "-s", os.path.join(REPO, SUBMAT)]


def run_e2e(tag: str, args: list[str], hp: bool, new_process: bool,
            captured: dict) -> tuple[dict, dict]:
    """One e2e path: the port in this process with every count set to 0 just
    before it and read just after, checked byte for byte against the port's
    own --engine native.  Returns the launch counts of the run and its wall
    seconds by engine and process (``torch_inproc``, ``torch`` ...)."""
    from mia_tpu_torch.ops import consensus_torch, dp_cuda

    d = os.path.join(WORK, tag)
    engines = ["torch_inproc", "native_inproc"] + (["native", "torch"] if new_process else [])
    for e in engines:
        os.makedirs(os.path.join(d, e))

    reset_counts()
    t0 = time.time()
    with Capture() as cap:
        prof = run_port(args, os.path.join(d, "torch_inproc", "out.maln"), profile=True)
    t_torch_warm = time.time() - t0
    captured.update({k: v for k, v in cap.args.items() if k not in captured})
    counters = prof["counters"]
    counts = {
        "dp.kernel_launches": dp_cuda.kernel_launches,
        "dp.plain_calls": dp_cuda.plain_calls,
        "dp.hp_kernel_launches": dp_cuda.hp_kernel_launches,
        "dp.hp_plain_calls": dp_cuda.hp_plain_calls,
        "dp.last_row_launches": dp_cuda.last_row_launches,
        "dp.last_row_plain_calls": dp_cuda.last_row_plain_calls,
        "dp.last_row_band_launches": dp_cuda.last_row_band_launches,
        "dp.last_row_band_plain_calls": dp_cuda.last_row_band_plain_calls,
        "dp.last_row_rows": dp_cuda.last_row_rows,
        "dp.last_row_band_rows": dp_cuda.last_row_band_rows,
        **wide_counts(dp_cuda),
        "dp.last_row_hp_launches": dp_cuda.last_row_hp_launches,
        "dp.last_row_hp_plain_calls": dp_cuda.last_row_hp_plain_calls,
        "dp.last_row_hp_band_launches": dp_cuda.last_row_hp_band_launches,
        "dp.last_row_hp_band_plain_calls": dp_cuda.last_row_hp_band_plain_calls,
        "dp.last_row_hp_rows": dp_cuda.last_row_hp_rows,
        "dp.last_row_hp_band_rows": dp_cuda.last_row_hp_band_rows,
        "cons.kernel_launches": consensus_torch.kernel_launches,
        "cons.plain_calls": consensus_torch.plain_calls,
    }
    t0 = time.time()
    native_prof = run_mia(args, os.path.join(d, "native_inproc", "out.maln"), "native",
                          profile=True)
    t_native_warm = time.time() - t0
    walls = {"torch_inproc": t_torch_warm, "native_inproc": t_native_warm}
    if new_process:
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))

        def cli(engine: str) -> float:
            t0 = time.time()
            r = subprocess.run([sys.executable, "-m", "mia_tpu_torch.cli.mia", *args, "-m",
                                os.path.join(d, engine, "out.maln"), "--engine", engine,
                                "--profile"],
                               env=env, check=True, capture_output=True, timeout=900)
            wall = time.time() - t0
            counters = json.loads([ln for ln in r.stderr.decode().splitlines()
                                   if ln.startswith("MIA_PROFILE ")][-1].split(" ", 1)[1])
            counters = counters["counters"]
            # the yardstick of phase 16b's clients: a run that scored in
            # its own new process, through no server
            if engine == "torch" and not (counters.get("pass1.in_process") == 1
                                          and "pass1.using_server" not in counters):
                raise AssertionError(f"{tag}: the new process did not score itself: {counters}")
            return wall

        walls["torch"], walls["native"] = cli("torch"), cli("native")
    times = (f"wall s in this process (warm): torch {walls['torch_inproc']:.3f}, "
             f"native {walls['native_inproc']:.3f}")
    if new_process:
        times += (f"; as a new process: torch {walls['torch']:.3f}, "
                  f"native {walls['native']:.3f}")

    want = maln_bytes(os.path.join(d, "native_inproc", "out.maln"))
    for e in engines:
        got = maln_bytes(os.path.join(d, e, "out.maln"))
        if not want or got != want:
            diff = [k for k in sorted(set(got) | set(want)) if got.get(k) != want.get(k)]
            raise AssertionError(f"20k assembly {tag} ({e}) differs from native: {diff}")
    scorer = "dp.hp_kernel_launches" if hp else "dp.kernel_launches"
    checks = {
        **counts,
        "pass1.device_scored_reads": counters.get("pass1.device_scored_reads", 0),
        "reiterate.device_entries": counters.get("reiterate.device_entries", 0),
        "consensus.device_calls": counters.get("consensus.device_calls", 0),
        "consensus.device_fallbacks": counters.get("consensus.device_fallbacks", 0),
    }
    checks["pass1.native_solved_wide_reads"] = counters.get("pass1.native_solved_wide_reads", 0)
    checks["pass1.device_scored_wide_reads"] = counters.get("pass1.device_scored_wide_reads", 0)
    if not (counts[scorer] > 0 and counts["cons.kernel_launches"] > 0
            and checks["pass1.native_solved_wide_reads"] == 0
            # the WIDE reads went through the general-width scorer's band
            # form (K1g; under -h K4g) and never its full form (whole
            # strands take the strand form: phase 7b's check, and under -h
            # this workload's whole strands, phase 8c's)
            and counts["dp.last_row_hp_band_launches" if hp
                       else "dp.last_row_band_launches"] > 0
            and (not hp or counts["dp.last_row_hp_strand_launches"] > 0)
            and counts["dp.last_row_launches"] == counts["dp.last_row_hp_launches"] == 0
            and checks["pass1.device_scored_wide_reads"] > 0
            and counts["dp.plain_calls"] == counts["dp.hp_plain_calls"] == 0
            and counts["dp.last_row_plain_calls"] == counts["dp.last_row_hp_plain_calls"] == 0
            and counts["dp.last_row_band_plain_calls"] == 0
            and counts["dp.last_row_strand_plain_calls"] == 0
            and counts["dp.last_row_hp_band_plain_calls"] == 0
            and counts["dp.last_row_hp_strand_plain_calls"] == 0
            and counts["cons.plain_calls"] == 0
            and checks["pass1.device_scored_reads"] > 0
            and checks["reiterate.device_entries"] > 0
            and checks["consensus.device_fallbacks"] == 0):
        raise AssertionError(f"device path not taken ({tag}): {checks}")
    say(f"{tag}: 20k reads, {len(want)} maln files byte-identical to "
        f"--engine native; {json.dumps(checks)}")
    say(f"{tag}: {times}")
    say(f"{tag}: profile " + json.dumps(counters, sort_keys=True))
    say(f"{tag}: phases s, torch " + json.dumps(prof["phases_s"], sort_keys=True))
    say(f"{tag}: phases s, native " + json.dumps(native_prof["phases_s"], sort_keys=True))
    return counts, walls

def wide_counts(dp_cuda) -> dict:
    """The strand forms' counters and the band rows on more than one warp
    (``dp_cuda``'s), under their profile names."""
    return {f"dp.{k}": getattr(dp_cuda, k) for k in (
        "last_row_strand_launches", "last_row_strand_plain_calls", "last_row_strand_rows",
        "last_row_hp_strand_launches", "last_row_hp_strand_plain_calls",
        "last_row_hp_strand_rows", "last_row_band_multi_rows", "last_row_hp_band_multi_rows")}


# the forms of the scorers of wide rows, in the order of a call's rows:
# the band form's classes (1, 2, 4 and 8 warps a row), the strand form, the
# full form
WIDE_CLASSES = ("band1", "band2", "band4", "band8", "strand", "full")


def last_row_call(args, name: str = "dp_last_row") -> dict:
    """Rows, padded width, read rows and the DP cells a call of ``name``
    (``dp_last_row``, ``dp_last_row_strand`` or ``dp_last_row_hp``) with
    ``args`` needs: each row up to its read's length and its own window.
    For the two scorers of wide rows also the call's rows of each form
    (``n_band`` with its warp classes, ``n_strand``: its last arguments)
    and of each class (``WIDE_CLASSES``, with their cells as launched and
    over each row's band: the union of its intervals,
    ``entries.band_columns``), its cells as launched (a band row at its
    warps' 384 columns each, a strand row at its band columns, a full row
    at the call's width) and over each row's band, its rows whose band
    (with the two columns before each run, what the split counts) takes
    more than 384, 512 and 3,072 columns, and its whole strands (a band
    past 3,072 columns that is the row's whole window)."""
    import torch

    if name == "dp_last_row":
        _, mask, s2c, lengths = args[:4]
        width = mask.shape[1]
        own_width = width - torch.argmax(mask.flip(1).to(torch.int8), 1)
        cells = int(((lengths.to(torch.int64) - 1).clamp(min=0) * own_width).sum())
        return {"rows": s2c.shape[0], "width": int(width), "L": s2c.shape[1], "cells": cells}
    from mia_tpu_torch.core.entries import BAND_COLS, BAND_ROW_COLS, BAND_WARPS, band_columns

    # dp_last_row_hp: ... ivl, s2chr, lengths, width, n_band, band_classes, n_strand;
    # dp_last_row_strand: refs, submat, strand, win_lo, ivl, s2c, lengths, width, n_band,
    # band_classes, n_strand
    hp = name == "dp_last_row_hp"
    at = 8 if hp else 4
    ivl, s2c, lengths, width = args[at:at + 4]
    rest = list(args[at + 4:]) + [0, (), 0][len(args) - at - 4:]
    n_band, classes, n_strand = int(rest[0]), tuple(rest[1]) or (int(rest[0]),), int(rest[2])
    classes = classes + (0,) * (len(BAND_WARPS) - len(classes))
    R = s2c.shape[0]
    counts = [*classes, n_strand, R - n_band - n_strand]
    own_width = ivl[:, :, 1].max(1).values.to(torch.int64).cpu().numpy()
    rows = (lengths.to(torch.int64) - 1).clamp(min=0).cpu().numpy()
    open_cols, band_cols = band_columns(ivl.cpu().numpy())
    launched, band_cells, lo = {}, {}, 0
    for form, n in zip(WIDE_CLASSES, counts):
        part = slice(lo, lo + n)
        lo += n
        w = (BAND_COLS * int(form[4:]) if form.startswith("band")
             else band_cols[part] if form == "strand" else int(width))
        launched[form] = int((rows[part] * w).sum())
        band_cells[form] = int((rows[part] * open_cols[part]).sum())
    return {"rows": R, "band_rows": n_band, "strand_rows": n_strand,
            "full_rows": R - n_band - n_strand, "band_classes": classes,
            "class_rows": dict(zip(WIDE_CLASSES, counts)), "width": int(width),
            "L": s2c.shape[1], "cells": int((rows * own_width).sum()),
            "band_cells": int((rows * open_cols).sum()),
            "launched": sum(launched.values()), "class_launched": launched,
            "class_band_cells": band_cells,
            "over_384": int((band_cols > 384).sum()), "over_512": int((band_cols > 512).sum()),
            "over_3072": int((band_cols > BAND_ROW_COLS).sum()),
            "whole_strands": int(((band_cols > BAND_ROW_COLS)
                                  & (band_cols == own_width)).sum())}


def wide_totals(calls: list[dict]) -> tuple[dict, dict]:
    """A run's calls of a scorer of wide rows (:func:`last_row_call` each):
    its totals of cells (as launched, over each row's own window, over its
    band), of rows over 384, 512 and 3,072 band columns and of whole
    strands; and per class (``WIDE_CLASSES``) its rows, the calls that hold
    any, and its cells as launched and over the rows' bands."""
    tot = {k: sum(c[k] for c in calls)
           for k in ("launched", "cells", "band_cells", "over_384", "over_512", "over_3072",
                     "whole_strands")}
    per_class = {c: {"rows": sum(k["class_rows"][c] for k in calls),
                     "calls": sum(1 for k in calls if k["class_rows"][c]),
                     "launched_cells": sum(k["class_launched"][c] for k in calls),
                     "band_cells": sum(k["class_band_cells"][c] for k in calls)}
                 for c in WIDE_CLASSES}
    return tot, per_class


class LastRowTimer:
    """Wraps ``dp_cuda.dp_last_row`` (or ``name``: ``dp_last_row_strand``,
    ``dp_last_row_hp``) while a run goes through it: CUDA events on the
    current stream around each call (the wrapper's checks, its allocation
    and the launch, which follow the batch's entries on that stream), each
    call's rows, padded width, read rows and cells (:func:`last_row_call`),
    and the arguments of the largest call; for the two scorers of wide rows
    every call's arguments instead, and it also times each form's launches
    apart (events around the library's entries, ``FORMS``).  The calls and
    their launch counts are the wrapper's own."""

    FORMS = {"dp_last_row_strand": {"band": "mia_dp_band", "strand": "mia_dp_strand",
                                    "full": "mia_dp_last_row"},
             "dp_last_row_hp": {"band": "mia_dp_band_hp", "strand": "mia_dp_strand_hp",
                                "full": "mia_dp_last_row_hp"}}

    def __init__(self, name: str = "dp_last_row"):
        self.name = name
        self.forms = self.FORMS.get(name, {})

    def __enter__(self):
        import torch

        from mia_tpu_torch.ops import dp_cuda
        from mia_tpu_torch.utils.torchcfg import kernel_library

        self._mod, self._fn = dp_cuda, getattr(dp_cuda, self.name)
        self.events: list = []
        self.calls: list = []
        self.kept: list = []
        self.largest = None
        self.form_events: dict = {form: [] for form in self.forms}

        def events():
            return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

        def wrapped(*args):
            start, stop = events()
            start.record()
            out = self._fn(*args)
            stop.record()
            self.events.append((start, stop))
            call = last_row_call(args, self.name)
            self.calls.append(call)
            if self.forms or self.largest is None or (
                    call["rows"] * call["width"]
                    > self.largest[0]["rows"] * self.largest[0]["width"]):
                kept = (call, tuple(a.clone() if hasattr(a, "clone") else a for a in args))
                if self.forms:
                    self.kept.append(kept)
                else:
                    self.largest = kept
            return out

        setattr(dp_cuda, self.name, wrapped)
        self._lib, self._entries = kernel_library(), {}
        for form, entry in self.forms.items():
            fn = getattr(self._lib, entry)

            def timed(*a, _fn=fn, _form=form):
                start, stop = events()
                start.record()
                rc = _fn(*a)
                stop.record()
                self.form_events[_form].append((start, stop))
                return rc

            self._entries[entry] = fn
            setattr(self._lib, entry, timed)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self.name, self._fn)
        for entry, fn in self._entries.items():
            setattr(self._lib, entry, fn)

    def device_ms(self) -> list[float]:
        import torch

        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]

    def form_ms(self) -> dict[str, list[float]]:
        """Device ms of each form's launches (the scorers of wide rows)."""
        import torch

        torch.cuda.synchronize()
        return {form: [a.elapsed_time(b) for a, b in ev]
                for form, ev in self.form_events.items()}


def wide_workload(d: str, seed: int = 1, reads: int | None = 20000,
                  cell_name: str = "mia-hsmt-100k") -> dict:
    """A cell's traffic (``benchmark.cells``; the ``mia-hsmt-100k`` cell's)
    cut to ``reads`` reads (None: the cell's own), written under ``d``: its
    inputs dict."""
    from types import SimpleNamespace

    from benchmark import cells
    from benchmark.run import load_benchmark, load_config

    cell = next(w for w in load_benchmark()["workloads"] if w["name"] == cell_name)
    os.makedirs(d)
    scale = 1.0 if reads is None else reads / cell["traffic"]["reads"]
    return cells.make_inputs(SimpleNamespace(seed=seed, scale=scale, work=d), cell,
                             load_config(cell))


def phase_wide(dev) -> dict:
    """Phase 7b: pass 1's WIDE reads on the card, on the 100k cell's traffic
    cut to 20k reads at seed 1, through ``dp_last_row_strand`` (K1g's band
    and strand forms): maln bytes equal to ``--engine native``, the band
    and strand forms launched and the full form not, no plain call, no
    native wide solve; then :func:`wide_forms`.  Returns the ``kernels``
    line's entries of the full, band and strand forms."""
    import torch

    from mia_tpu_torch.ops import consensus_torch, dp_cuda
    from mia_tpu_torch.ops.dp_torch import batch_best_and_aec

    d = os.path.join(WORK, "wide")
    inputs = wide_workload(d)
    say(f"wide reads: {inputs['held']}")
    os.makedirs(os.path.join(d, "torch"))
    os.makedirs(os.path.join(d, "native"))
    reset_counts()
    t0 = time.time()
    with LastRowTimer("dp_last_row_strand") as timer, contextlib.redirect_stderr(io.StringIO()):
        prof = run_port(inputs["args"], os.path.join(d, "torch", "out.maln"), profile=True)
    wall = time.time() - t0
    counts = {
        "dp.kernel_launches": dp_cuda.kernel_launches,
        "dp.plain_calls": dp_cuda.plain_calls,
        "dp.last_row_launches": dp_cuda.last_row_launches,
        "dp.last_row_wide_launches": dp_cuda.last_row_wide_launches,
        "dp.last_row_plain_calls": dp_cuda.last_row_plain_calls,
        "dp.last_row_band_launches": dp_cuda.last_row_band_launches,
        "dp.last_row_band_plain_calls": dp_cuda.last_row_band_plain_calls,
        "dp.last_row_rows": dp_cuda.last_row_rows,
        "dp.last_row_band_rows": dp_cuda.last_row_band_rows,
        **wide_counts(dp_cuda),
        "cons.kernel_launches": consensus_torch.kernel_launches,
        "cons.plain_calls": consensus_torch.plain_calls,
    }
    c = prof["counters"]
    for k in ("pass1.device_scored_reads", "pass1.device_scored_wide_reads",
              "pass1.native_solved_wide_reads", "pass1.finish_host_reads"):
        counts[k] = c.get(k, 0)
    t0 = time.time()
    with contextlib.redirect_stderr(io.StringIO()):
        native_prof = run_mia(inputs["args"], os.path.join(d, "native", "out.maln"), "native",
                              profile=True)
    native_wall = time.time() - t0
    got = maln_bytes(os.path.join(d, "torch", "out.maln"))
    want = maln_bytes(os.path.join(d, "native", "out.maln"))
    if not want or got != want:
        raise AssertionError(f"wide reads: maln differs from --engine native: "
                             f"{[k for k in sorted(set(got) | set(want)) if got.get(k) != want.get(k)]}")
    # this workload's wide rows hold narrow bands and whole strands: the band
    # and strand forms run, the full form (rows past 18,432 band columns) not
    if not (counts["dp.last_row_band_launches"] > 0
            and counts["dp.last_row_strand_launches"] > 0
            and counts["dp.last_row_launches"] == 0
            and counts["dp.kernel_launches"] > 0 and counts["cons.kernel_launches"] > 0
            and counts["dp.plain_calls"] == counts["dp.last_row_plain_calls"] == 0
            and counts["dp.last_row_band_plain_calls"] == 0
            and counts["dp.last_row_strand_plain_calls"] == 0
            and counts["cons.plain_calls"] == 0
            and counts["pass1.device_scored_wide_reads"] > 0
            and counts["pass1.native_solved_wide_reads"] == 0):
        raise AssertionError(f"wide reads: the card did not score them: {counts}")
    say(f"wide reads: {len(want)} maln files byte-identical to --engine native; "
        + json.dumps(counts))
    say(f"wide reads: wall s torch {wall:.3f}, native {native_wall:.3f}; pass1 torch "
        f"{prof['phases_s'].get('pass1', 0):.3f}, native "
        f"{native_prof['phases_s'].get('pass1', 0):.3f}")
    say("wide reads: phases s, torch " + json.dumps(prof["phases_s"], sort_keys=True))
    forms = wide_forms("wide reads", timer, counts, hp=False)

    # the first maximum on the card, as the native solve's strict '>' scan
    tied = torch.full((4, 1000), 7, dtype=torch.int32, device=dev)
    tied[1, 300:] = 9
    tied[2, [10, 900]] = 11
    tied[3] = -(2**30)
    _, aec = batch_best_and_aec(tied)
    if aec.cpu().tolist() != [0, 300, 10, 0]:
        raise AssertionError(f"wide reads: argmax on the card is not the first maximum: "
                             f"{aec.cpu().tolist()}")
    say("wide reads: batch_best_and_aec on the card takes the first of tied maxima")
    return forms


def wide_forms(label: str, timer: "LastRowTimer", counts: dict, hp: bool) -> dict:
    """Phases 7b and 8c: a scorer of wide rows (``dp_last_row_strand``, K1g;
    under ``hp`` ``dp_last_row_hp``, K4g) as a run went through it
    (``timer``): its calls' rows and launches per form (band, strand, full)
    and per class (the band form's 1, 2, 4 and 8 warps a row), widths, rows
    over 384, 512 and 3,072 band columns and whole strands, cells counted
    three ways (as launched, over each row's own window, over its band) and
    per class, and device time (CUDA events around each call and around
    each form's launches), Gcells/s; then each form that launched, at the
    run's largest call of that form (the most rows of the form; the full
    form: the most full-row columns), held to its plain version (exact),
    timed through the wrapper and alone, and its bound at the DP's 14
    operations a cell: the band and strand forms' over band cells, with
    the own-window count's beside it.  Returns the ``kernels`` line's
    entries of each form, by form (a form that did not launch: its run's
    counts only)."""
    import numpy as np
    import torch

    from mia_tpu_torch.ops import dp_cuda
    from mia_tpu_torch.ops.dp_torch import (
        batch_best_and_aec,
        batch_last_row,
        depths_for,
        last_row_band_plain,
        last_row_hp_band_plain,
        last_row_hp_plain,
        last_row_hp_strand_plain,
        last_row_strand_plain,
        wide_device_inputs,
    )

    pre = "dp.last_row_hp" if hp else "dp.last_row"
    forms = ("band", "strand", "full")
    launch_key = {f: f"{pre}_{f}_launches" for f in ("band", "strand")}
    launch_key["full"] = f"{pre}_launches"
    rows_key = {f: f"{pre}_{f}_rows" for f in ("band", "strand")}
    rows_key["full"] = f"{pre}_rows"
    wrapper = dp_cuda.dp_last_row_hp if hp else dp_cuda.dp_last_row_strand
    name = "dp_last_row_hp" if hp else "dp_last_row_strand"
    ms = timer.device_ms()
    form_ms = timer.form_ms()
    if not ms or any(len(form_ms[f]) != counts[launch_key[f]] for f in forms):
        raise AssertionError(f"{label}: {len(ms)} timed calls, launches timed "
                             f"{ {k: len(v) for k, v in form_ms.items()} }, counts {counts}")
    calls = timer.calls
    form_rows = {f: [k[f"{f}_rows"] for k in calls] for f in forms}
    if any(sum(form_rows[f]) != counts[rows_key[f]] for f in forms):
        raise AssertionError(f"{label}: rows {form_rows}, counts {counts}")
    tot, per_class = wide_totals(calls)
    run_ms = {form: sum(v) for form, v in form_ms.items()}
    say(f"{label}: {len(ms)} {name} calls; "
        + "; ".join(f"{f} form {len(form_ms[f])} launches, rows {form_rows[f]}" for f in forms)
        + f"; widths {[k['width'] for k in calls]}; rows over 384 band columns "
        f"{[k['over_384'] for k in calls]}, over 512 {[k['over_512'] for k in calls]}, over "
        f"3,072 {[k['over_3072'] for k in calls]}, whole strands "
        f"{[k['whole_strands'] for k in calls]}; counts "
        + json.dumps({k: v for k, v in counts.items() if k.startswith(pre)}))
    say(f"{label}: rows by class (band form's warps a row, strand, full): "
        + json.dumps(per_class))
    say(f"{label}: cells as launched {tot['launched']}, in each row's own window "
        f"{tot['cells']}, in each row's band {tot['band_cells']}")
    say(f"{label}: device ms (events around each call) {sum(ms):.4f} in all, "
        + ", ".join(f"{x:.4f}" for x in ms) + "; "
        + ", ".join(f"{f} form {run_ms[f]:.4f} (" + ", ".join(f"{x:.4f}" for x in form_ms[f])
                    + ")" for f in forms) + "; "
        f"{tot['band_cells'] / max(sum(ms), 1e-9) / 1e6:.3f} Gcells/s over band cells, "
        f"{tot['cells'] / max(sum(ms), 1e-9) / 1e6:.3f} over own-window cells")

    n_state = 6 if hp else 2  # the scorer's state, then the rows' five arrays

    def held(form: str, call: dict, args: tuple, what: str = "the run's largest call") -> dict:
        """One form's rows of a kept call: held to the plain version,
        timed through the wrapper and alone, bound."""
        state, rows = args[:n_state], args[n_state:n_state + 5]
        nb, ns = call["band_rows"], call["strand_rows"]
        lo, hi = {"band": (0, nb), "strand": (nb, nb + ns),
                  "full": (nb + ns, call["rows"])}[form]
        part = tuple(a[lo:hi] for a in rows)
        width = call["width"]
        classes = call["band_classes"]
        call_args = {"band": (*state, *part, 0, nb, classes),
                     "strand": (*state, *part, 0, 0, (), ns),
                     "full": (*state, *part, width, 0)}[form]
        R, L = part[3].shape
        if not hp and form == "full":
            # the full form's inputs, made once for the plain version and
            # the kernel alone
            s1c, mask = wide_device_inputs(state[0], width, *part[:3])
            depths = depths_for(part[4], L).to(torch.int32)

        def plain():
            if hp:
                return (last_row_hp_band_plain(*state, *part) if form == "band"
                        else last_row_hp_strand_plain(*state, *part) if form == "strand"
                        else last_row_hp_plain(*state, *part, width))
            if form == "band":
                return last_row_band_plain(*state, *part)
            if form == "strand":
                return last_row_strand_plain(*state, *part)
            return torch.stack(batch_best_and_aec(
                batch_last_row(s1c, mask, part[3], part[4], depths, state[1])))
        info = last_row_call(call_args, name)
        before = {f: getattr(dp_cuda, launch_key[f][3:]) for f in forms}
        got = wrapper(*call_args)
        err = check_equal(f"{name} ({form} form) != plain at {what}", got, plain())
        t = time_plain_pair(lambda: wrapper(*call_args), plain,
                            f"{label}: {form} form at {what}, "
                            f"R={info['rows']} W={info['width']} L={info['L']}",
                            f"; {info['cells']} own-window cells, {info['band_cells']} band "
                            f"cells")
        plain_calls = ((dp_cuda.last_row_hp_plain_calls, dp_cuda.last_row_hp_band_plain_calls,
                        dp_cuda.last_row_hp_strand_plain_calls)
                       if hp else
                       (dp_cuda.last_row_plain_calls, dp_cuda.last_row_band_plain_calls,
                        dp_cuda.last_row_strand_plain_calls))
        if any(plain_calls):
            raise AssertionError(f"{label}: the wrapper took a plain version on the card")
        timing = {f: getattr(dp_cuda, launch_key[f][3:]) - before[f] for f in forms}
        # the kernel alone, into a result buffer made here
        ptrs = [a.data_ptr() for a in part]
        wtot = state[0].shape[1]
        out = got.clone()

        def bare(lib, stream):
            if hp:
                head = [a.data_ptr() for a in state[:3]] + [wtot]
                tail = [a.data_ptr() for a in state[3:]]
                if form == "band":
                    return lib.mia_dp_band_hp(*head, *ptrs, *tail, *classes, L,
                                              out.data_ptr(), R, stream)
                if form == "strand":
                    return lib.mia_dp_strand_hp(*head, *ptrs, *tail, R, L, out.data_ptr(), R,
                                                stream)
                return lib.mia_dp_last_row_hp(*head, *ptrs, *tail, R, width, L,
                                              out.data_ptr(), stream)
            if form == "band":
                return lib.mia_dp_band(state[0].data_ptr(), wtot, *ptrs, state[1].data_ptr(),
                                       *classes, L, out.data_ptr(), R, stream)
            if form == "strand":
                return lib.mia_dp_strand(state[0].data_ptr(), wtot, *ptrs,
                                         state[1].data_ptr(), R, L, out.data_ptr(), R, stream)
            # the whole last row of each: the argmax after it is torch's
            return lib.mia_dp_last_row(s1c.data_ptr(), 1, mask.data_ptr(), part[3].data_ptr(),
                                       depths.data_ptr(), state[1].data_ptr(),
                                       part[4].data_ptr(), R, width, L, 1, last.data_ptr(),
                                       stream)

        if not hp and form == "full":
            if width > dp_cuda.LAST_ROW_COLS * dp_cuda.LAST_ROW_THREADS:
                raise AssertionError(f"{label}: full rows of {width} columns: the register "
                                     "form cannot time them alone")
            last = torch.empty((R, width), dtype=torch.int32, device=part[4].device)
        t["kernel_only_ms"] = time_raw_launch(bare, f"{label}: {form} form", t["ms"], 50)
        # each input read once (the strand state whole, the reads up to their
        # lengths), the [2, R] result written once; the DP's 14 operations a
        # cell (under -h as K4's bound counts them: a row takes one of the
        # two -h candidates, and that one is left out, so both -h kernels
        # share one bound)
        lengths = part[4].cpu().numpy()
        moved = nbytes(*state, *part[:3], part[4], got) + read_bytes(lengths, part[3])
        cells = info["cells"] if form == "full" else info["band_cells"]
        b = bound(moved, DP_OPS_PER_CELL * cells)
        padded = bound(moved, DP_OPS_PER_CELL * info["cells"])
        say(f"{label}: {form} form == plain (exact, max |diff| {err}); bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {DP_OPS_PER_CELL} operations a "
            f"{'own-window' if form == 'full' else 'band'} cell), "
            f"{cells / t['ms'] / 1e6:.3f} Gcells/s; over own-window cells "
            f"bound {padded['bound_ms']:.4f} ms, {info['cells'] / t['ms'] / 1e6:.3f} "
            f"Gcells/s; launches {timing} for the check and timing; rows by class "
            f"{json.dumps(info['class_rows'])}; mean read length {float(np.mean(lengths)):.1f}")
        return {"max_abs_err": err, **t, "library_ms": None, **b,
                "workload_rows": info["rows"], "workload_width": info["width"],
                "workload_cells": info["cells"], "workload_band_cells": info["band_cells"],
                "workload_class_rows": info["class_rows"],
                "own_window_bound_ms": padded["bound_ms"]}

    kept = timer.kept
    run = {"wide_device_ms": sum(ms), "wide_rows": sum(k["rows"] for k in calls),
           "wide_cells": tot["cells"], "wide_band_cells": tot["band_cells"],
           "wide_launched_cells": tot["launched"], "wide_rows_over_384": tot["over_384"],
           "wide_rows_over_512": tot["over_512"], "wide_rows_over_3072": tot["over_3072"],
           "wide_whole_strands": tot["whole_strands"], "wide_classes": per_class}
    out = {}
    for form in forms:
        entry = {"launches": counts[launch_key[form]], **run, "form_device_ms": run_ms[form],
                 "form_rows": sum(form_rows[form])}
        if form == "band":
            entry["multi_warp_rows"] = counts[f"{pre}_band_multi_rows"]
        if entry["launches"]:
            at = max(range(len(kept)), key=lambda i: kept[i][0][f"{form}_rows"]
                     * (kept[i][0]["width"] if form == "full" else 1))
            entry.update(held(form, *kept[at]))
        out[form] = entry
    if hp and out["strand"]["launches"] and not out["full"]["launches"]:
        # the -h full form took these rows before the strand form: its
        # numbers on the largest strand call's rows, in this run
        call, args = max(kept, key=lambda k: k[0]["strand_rows"])
        nb, ns = call["band_rows"], call["strand_rows"]
        rows = tuple(a[nb:nb + ns] for a in args[n_state:n_state + 5])
        width = int(rows[2][:, :, 1].max())
        out["full"].update(held("full", dict(call, band_rows=0, strand_rows=0, rows=ns,
                                             width=width), (*args[:n_state], *rows),
                                "the largest strand call's rows"))
        out["full"]["timed_on"] = "the largest -h strand call's rows, at their widest window"
    return out


def phase_prepare_threads() -> None:
    """Phase 7c: pass 1's banding threaded over reads: the ``mia-hsmt-100k``
    cell's traffic cut to one batch (8,192 reads at seed 1, on its reference
    with the circular wrap) through ``BatchHost.prepare`` on one thread (as
    pass 1 calls it) and on the default count: all six arrays equal, no
    read failed; prints each one's time (host clock, median of 5 calls)."""
    import numpy as np

    from mia_tpu_torch.core import hostbatch
    from mia_tpu_torch.core.entries import L_MAX, MAX_INTERVALS, SCORE_BATCH, WIN_W
    from mia_tpu_torch.core.merge import add_ref_wrap
    from mia_tpu_torch.io.fasta import read_fasta_ref
    from mia_tpu_torch.io.native import iter_frag_seqs_fast
    from mia_tpu_torch.ops.pssm import init_flatsubmat

    inputs = wide_workload(os.path.join(WORK, "prepare"), reads=SCORE_BATCH)
    args = inputs["args"]
    if not ("-c" in args and args[args.index("-k") + 1] == "12"):
        raise AssertionError(f"banding threads: the cell's flags changed: {args}")
    reads = [f.seq[: f.seq_len] for f in iter_frag_seqs_fast(args[args.index("-f") + 1])]
    if len(reads) != SCORE_BATCH:
        raise AssertionError(f"banding threads: {len(reads)} reads, not one batch")
    ref = read_fasta_ref(args[args.index("-r") + 1])
    add_ref_wrap(ref)
    bhost = hostbatch.BatchHost.create(ref.seq, ref.rcseq, ref.wrap_seq_len, init_flatsubmat(),
                                       None, 12, False, WIN_W, MAX_INTERVALS)
    arena, off, lens = bhost.pack_reads(reads)
    default = hostbatch._default_threads()
    out, ms = {}, {}
    try:
        for n in sorted({1, default}):
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                *got, errors = bhost.prepare(arena, off, lens, L_MAX, MAX_INTERVALS,
                                             n_threads=n)
                times.append(1e3 * (time.perf_counter() - t0))
                if errors:
                    raise AssertionError(f"banding threads: {errors} reads failed on {n}")
            out[n], ms[n] = got, statistics.median(times)
    finally:
        bhost.close()
    names = ("s2c", "fw_ws", "rc_ws", "fw_ivg", "rc_ivg", "flags")
    for name, g, w in zip(names, out[default], out[1]):
        if not np.array_equal(g, w):
            raise AssertionError(f"banding threads: {name} on {default} threads differs "
                                 f"from one thread's")
    flags = out[1][-1]
    say(f"banding threads: the 100k cell's traffic cut to {len(reads)} reads "
        f"({int((flags == 0).sum())} windowed, {int((flags == hostbatch.FLAG_WIDE).sum())} "
        f"wide, {int((flags == hostbatch.FLAG_SKIP).sum())} without hits), all six arrays "
        f"equal on 1 and {default} (default) threads; prepare ms "
        + ", ".join(f"{k} threads {v:.3f}" for k, v in ms.items()) + f"; {host_threads()}")


WIDE_AB_PHASES = ("pass1", "pass1.py_merge", "pass1.native_finish", "pass1.collect_wait",
                  "pass1.dispatch", "pass1.pack_prepare", "reiterate", "gc", "wide_calls_ms")
WIDE_AB_COUNTERS = ("pass1.device_scored_reads", "pass1.device_scored_wide_reads",
                    "pass1.native_solved_wide_reads")


def load_package_copy(root: str, name: str = "mia_tpu_torch_earlier"):
    """``root``'s ``mia_tpu_torch`` imported beside this tree's as ``name``
    (a symlink under the work directory), whose relative imports stay
    inside it: its ``cli.mia``, ``utils.profiling`` and ``ops.dp_cuda``.
    The earlier tree's shared ``native`` directory is linked beside it too:
    a port from before it had a native library of its own loads that one."""
    import importlib

    d = os.path.join(WORK, "pkg")
    os.makedirs(d, exist_ok=True)
    earlier = os.path.abspath(root)
    shared = os.path.join(earlier, "native")
    if os.path.isdir(shared):
        os.symlink(shared, os.path.join(d, os.path.basename(shared)))
    os.symlink(os.path.join(earlier, "mia_tpu_torch"), os.path.join(d, name))
    sys.path.append(d)
    return tuple(importlib.import_module(f"{name}.{m}")
                 for m in ("cli.mia", "utils.profiling", "ops.dp_cuda"))


def run_side(side: tuple, args: list[str], root: str, what: str):
    """One whole ``mia.main --engine torch --profile`` run with the port of
    ``side``, (``cli.mia``, ``utils.profiling``, ``ops.dp_cuda``) of this
    tree or of an earlier one, writing ``root``: (maln bytes, wall s,
    profile with the collector's time as the phase ``gc``, launch counts).
    Fails unless the card scored."""
    import torch

    mia, prof_mod, dp = side
    os.makedirs(os.path.dirname(root))
    dp.reset_counts()
    gc_s = [0.0, 0.0]
    # the scorers of wide rows, timed by CUDA events around each call
    events: list = []
    wrapped = {}
    for fn in ("dp_last_row_strand", "dp_last_row_hp"):
        f = getattr(dp, fn)

        def timed(*a, _f=f):
            start, stop = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            start.record()
            out = _f(*a)
            stop.record()
            events.append((start, stop))
            return out

        wrapped[fn] = f
        setattr(dp, fn, timed)

    def gc_clock(phase: str, info: dict) -> None:
        if phase == "start":
            gc_s[1] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_s[1]

    gc.callbacks.append(gc_clock)
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            if mia.main([*args, "-m", root, "--engine", "torch", "--profile"]) != 0:
                raise RuntimeError(f"{what} failed")
            prof = prof_mod.report(out=io.StringIO())
    finally:
        gc.callbacks.remove(gc_clock)
        for fn, f in wrapped.items():
            setattr(dp, fn, f)
    wall = time.time() - t0
    prof["phases_s"]["gc"] = gc_s[0]
    torch.cuda.synchronize()
    prof["phases_s"]["wide_calls_ms"] = sum(a.elapsed_time(b) for a, b in events)
    counts = {"dp.kernel_launches": dp.kernel_launches, "dp.plain_calls": dp.plain_calls,
              "dp.hp_kernel_launches": dp.hp_kernel_launches,
              "dp.hp_plain_calls": dp.hp_plain_calls,
              **{f"dp.{k}": getattr(dp, k, 0) for k in (
                  "last_row_launches", "last_row_plain_calls", "last_row_band_launches",
                  "last_row_band_plain_calls", "last_row_hp_launches",
                  "last_row_hp_plain_calls", "last_row_hp_band_launches",
                  "last_row_hp_band_plain_calls", "last_row_strand_launches",
                  "last_row_strand_plain_calls")}}
    if (counts["dp.plain_calls"] or counts["dp.hp_plain_calls"]
            or counts["dp.last_row_plain_calls"] or counts["dp.last_row_band_plain_calls"]
            or counts["dp.last_row_strand_plain_calls"]
            or counts["dp.last_row_hp_plain_calls"] or counts["dp.last_row_hp_band_plain_calls"]
            or not counts["dp.kernel_launches"] + counts["dp.hp_kernel_launches"]):
        raise AssertionError(f"{what} did not score on the card: {counts}")
    return maln_bytes(root), wall, prof, counts


def sampled_run(label: str, run) -> None:
    """``run()`` once with every thread's stack sampled."""
    samples: dict = {}
    stop = threading.Event()
    sampler = threading.Thread(target=sample_stacks, args=(stop, samples), daemon=True)
    sampler.start()
    try:
        wall = run()[1]
    finally:
        stop.set()
        sampler.join(timeout=10)
    say_samples(label, samples, wall)


def port_ab(label: str, earlier_root: str, pairs: int, inputs: dict, phases: tuple,
            counters: tuple, sampled: bool = True) -> None:
    """Whole ``mia.main --engine torch --profile`` runs of ``inputs`` with the
    port of ``earlier_root`` (imported beside this tree's) and this tree's,
    in turns; every run's maln held to this tree's first run and its counts
    (``run_side``'s and ``counters``) to its tree's first; ``phases`` printed
    a run and as quartiles; with ``sampled`` one more run of each with every
    thread's stack sampled."""
    from mia_tpu_torch.cli import mia as cli_mia
    from mia_tpu_torch.ops import dp_cuda
    from mia_tpu_torch.utils import profiling

    sides = {"earlier": load_package_copy(earlier_root), "this": (cli_mia, profiling, dp_cuda)}
    d = inputs["work"]
    say(f"{label}: {inputs['held']}")

    def run(name: str, tag: str):
        got, wall, prof, counts = run_side(sides[name], inputs["args"],
                                           os.path.join(d, tag, "out.maln"),
                                           f"{label}: {tag} ({name})")
        counts.update({k: prof["counters"].get(k, 0) for k in counters})
        return got, wall, prof, counts

    want, wall, _, this_counts = run("this", "warm_this")
    _, wall_e, _, earlier_counts = run("earlier", "warm_earlier")
    say(f"{label}: warm-up {wall:.3f} s (this) {wall_e:.3f} s (earlier); counts this "
        f"{json.dumps(this_counts)}, earlier {json.dumps(earlier_counts)}")
    runs: dict[str, list[dict]] = {"earlier": [], "this": []}
    for k, name in enumerate(ab_order(pairs)):
        got, wall, prof, counts = run(name, f"run{k}")
        if got != want:
            raise AssertionError(f"{label}: run {k} ({name}) maln differs from this tree's")
        if counts != (this_counts if name == "this" else earlier_counts):
            raise AssertionError(f"{label}: run {k} ({name}) counts {counts} changed")
        ph = prof["phases_s"]
        r = {"wall": wall, **{p: ph.get(p, 0.0) for p in phases}}
        runs[name].append(r)
        say(f"{label}: {name}: {wall:.3f} s, {inputs['reads'] / wall:.2f} reads/s; "
            + ", ".join(f"{p} {r[p]:.3f}" for p in phases))
    wins = sum(b["wall"] < a["wall"] for a, b in zip(runs["earlier"], runs["this"]))
    say(f"{label}: {pairs} pairs in turns, every maln byte-identical; this tree faster in "
        f"{wins} of {pairs} pairs")
    for name, rs in runs.items():
        say(f"{label}:   {name}: reads/s {quartiles([inputs['reads'] / r['wall'] for r in rs])}; "
            + "; ".join(f"{k} s {quartiles([r[k] for r in rs])}" for k in ("wall", *phases)))
    if sampled:
        for name in ("earlier", "this"):
            sampled_run(f"{label}: sampled run ({name})", lambda: run(name, f"sampled_{name}"))


def phase_wide_ab(earlier_root: str, pairs: int) -> None:
    """``--wide-ab``: :func:`port_ab` on phase 7b's workload (the 100k cell's
    traffic cut to 20k reads at seed 1): pass 1's phases and the wide reads'
    counters."""
    d = os.path.join(WORK, "wide_ab")
    inputs = dict(wide_workload(d), work=d)
    port_ab("wide a/b", earlier_root, pairs, inputs, WIDE_AB_PHASES, WIDE_AB_COUNTERS)


PREP_AB_PHASES = ("pass1", "pass1.pack_prepare", "pass1.prep_wait", "pass1.dispatch",
                  "pass1.py_merge", "pass1.native_finish", "pass1.collect_wait", "reiterate",
                  "filters.pop_smp", "filters.pop_smp_first", "gc")


def phase_census(names: list[str]) -> None:
    """``--census [CELL ...]``: each cell's traffic at its own size (seed 1;
    default ``mia-hsmt-100k`` and ``mia-hsmt-100k-h``) through the port on
    the card, its scorer of wide rows watched (:class:`LastRowTimer`): pass
    1's own batching and routing decide the rows, and :func:`wide_totals`
    counts them by form and class as phases 7b and 8c do: rows of each call
    and of each class, the calls holding each, cells as launched and over
    the bands, rows over 384, 512 and 3,072 band columns, whole strands;
    then the run's counters of the forms and of the WIDE reads' routes."""
    from mia_tpu_torch.ops import dp_cuda

    for name in names or ["mia-hsmt-100k", "mia-hsmt-100k-h"]:
        d = os.path.join(WORK, f"census_{name}")
        inputs = wide_workload(d, reads=None, cell_name=name)
        os.makedirs(os.path.join(d, "torch"))
        hp = "-h" in inputs["args"]
        fn = "dp_last_row_hp" if hp else "dp_last_row_strand"
        reset_counts()
        with LastRowTimer(fn) as timer, contextlib.redirect_stderr(io.StringIO()):
            prof = run_port(inputs["args"], os.path.join(d, "torch", "out.maln"), profile=True)
        if dp_cuda.plain_calls or dp_cuda.hp_plain_calls or not timer.calls:
            raise AssertionError(f"census {name}: the card did not score its wide rows")
        tot, per_class = wide_totals(timer.calls)
        say(f"census {name}: " + json.dumps({
            "reads": inputs["reads"], "seed": 1, "scorer": fn, "calls": len(timer.calls),
            "rows": sum(c["rows"] for c in timer.calls),
            "rows_per_call": {c: [k["class_rows"][c] for k in timer.calls] for c in per_class},
            "classes": per_class, **tot}))
        # the forms' launches and the wide reads' routes, as the run counted them
        say(f"census {name}: counters " + json.dumps(
            {k: v for k, v in sorted(prof["counters"].items())
             if k.startswith("dp.last_row") or "wide_reads" in k}))


def phase_band_ab(earlier_root: str, reps: int) -> None:
    """``--band-ab ROOT [REPS]``: the band form's one-warp rows, bare, with
    this tree's kernel library and with that of ``ROOT`` (a ``git archive``
    of an earlier commit, whose ``mia_dp_band`` and ``mia_dp_band_hp`` take
    one count of rows, all on one warp, or one count a class), in turns (earlier, this, this,
    earlier; REPS times, default 3): the one-warp rows of the run's largest
    band call of phase 7b's workload (without ``-h``) and of phase 8c's
    (``-h``), each launch held to the other library's and to the plain
    version (exact).  Beside them this tree's whole band call (its several-
    warp rows too) alone, so that the rows that moved in from the full form
    show apart."""
    import importlib

    import torch

    from mia_tpu_torch.ops.dp_torch import last_row_band_plain, last_row_hp_band_plain
    from mia_tpu_torch.utils.torchcfg import kernel_library

    load_package_copy(earlier_root)
    elib = importlib.import_module("mia_tpu_torch_earlier.utils.torchcfg").kernel_library()
    lib = kernel_library()
    stream = torch.cuda.current_stream().cuda_stream
    d = os.path.join(WORK, "band_ab")
    wide = wide_workload(os.path.join(d, "wide"))
    os.makedirs(os.path.join(d, "plain"))
    os.makedirs(os.path.join(d, "hp"))
    for hp, args in ((False, wide["args"]), (True, [*e2e_workload(), "-h"])):
        name = "dp_last_row_hp" if hp else "dp_last_row_strand"
        label = f"band a/b ({'-h' if hp else 'plain'})"
        with LastRowTimer(name) as timer, contextlib.redirect_stderr(io.StringIO()):
            run_port(args, os.path.join(d, "hp" if hp else "plain", "out.maln"))
        call, cargs = max(timer.kept, key=lambda k: k[0]["band_rows"])
        n_state = 6 if hp else 2
        state, rows = cargs[:n_state], cargs[n_state:n_state + 5]
        classes = call["band_classes"]
        n1, nb = classes[0], call["band_rows"]
        L = rows[3].shape[1]
        one = tuple(a[:n1] for a in rows)
        want = (last_row_hp_band_plain(*state, *one) if hp
                else last_row_band_plain(*state, *one))
        wtot = state[0].shape[1]
        outs = {k: torch.empty((2, n), dtype=torch.int32, device=want.device)
                for k, n in (("earlier", n1), ("this", n1), ("all", nb))}

        def launch(which: str):
            part = rows if which == "all" else one
            n = nb if which == "all" else n1
            counts = classes if which == "all" else (n1, 0, 0, 0)
            # an earlier library takes one count of rows, or one a class
            ecounts = (n1,) if len(elib.mia_dp_band.argtypes) == 13 else (n1, 0, 0, 0)
            out = outs[which]
            ptrs = [a.data_ptr() for a in part]
            if hp:
                head = [a.data_ptr() for a in state[:3]] + [wtot]
                tail = [a.data_ptr() for a in state[3:]]
                rc = (elib.mia_dp_band_hp(*head, *ptrs, *tail, *ecounts, L, out.data_ptr(), n,
                                          stream)
                      if which == "earlier" else
                      lib.mia_dp_band_hp(*head, *ptrs, *tail, *counts, L, out.data_ptr(), n,
                                         stream))
            else:
                head = (state[0].data_ptr(), wtot)
                rc = (elib.mia_dp_band(*head, *ptrs, state[1].data_ptr(), *ecounts, L,
                                       out.data_ptr(), n, stream)
                      if which == "earlier" else
                      lib.mia_dp_band(*head, *ptrs, state[1].data_ptr(), *counts, L,
                                      out.data_ptr(), n, stream))
            if rc:
                raise RuntimeError(f"{label}: {which} launch failed: CUDA error {rc}")

        for which in outs:
            launch(which)
        torch.cuda.synchronize()
        for which in ("earlier", "this"):
            check_equal(f"{label}: {which} library's one-warp rows != plain", outs[which], want)
        check_equal(f"{label}: this library's whole band call, one-warp rows", outs["all"][:, :n1],
                    want)
        times: dict = {"earlier": [], "this": [], "all": []}
        for _ in range(reps):
            for which in ("earlier", "this", "all", "all", "this", "earlier"):
                cuda_ms(lambda: launch(which), 5)
                times[which].append(cuda_ms(lambda: launch(which), 200))
        med = {k: statistics.median(v) for k, v in times.items()}
        say(f"{label}: the run's largest band call R={nb} (classes {list(classes)}), L={L}, "
            f"{call['class_band_cells']['band1']} one-warp band cells; bare ms in turns, "
            + "; ".join(f"{k} " + ", ".join(f"{x:.4f}" for x in v) for k, v in times.items())
            + f"; medians: one-warp rows earlier {med['earlier']:.4f}, this "
            f"{med['this']:.4f} ({(med['this'] / med['earlier'] - 1) * 100:+.2f}%), this "
            f"tree's whole call {med['all']:.4f} (its {nb - n1} several-warp rows "
            f"{med['all'] - med['this']:+.4f})")


def host_threads() -> str:
    """The CPUs this process sees and the native pools' default thread
    count (the finish's and the solves'; pass 1's prepare takes one)."""
    from mia_tpu_torch.core import hostbatch

    env = {k: v for k, v in os.environ.items() if k != "OMP_NUM_THREADS"}
    nproc = subprocess.run(["nproc"], capture_output=True, text=True, env=env).stdout.strip()
    return (f"os.cpu_count() {os.cpu_count()}, affinity {hostbatch.host_cpus()}, nproc "
            f"{nproc} (OMP_NUM_THREADS {os.environ.get('OMP_NUM_THREADS')}); default "
            f"threads {hostbatch._default_threads()}")


def phase_prep_ab(earlier_root: str, pairs: int) -> None:
    """``--prep-ab``: whole ``mia.main --engine torch --profile`` runs of phase
    7b's workload (the 100k cell's traffic cut to 20k reads at seed 1) with
    the port of ``earlier_root`` (its ``core/`` and its native library,
    built from its own sources) and this tree's, in turns, every run's maln
    held to this tree's ``--engine native``; pass 1, its banding
    (``pass1.pack_prepare``) and the main thread's wait on the prep thread
    (``pass1.prep_wait``; 0 for a tree without it) for each run.  Then the
    threads of this tree's pass-1 prepare swept (the call forced to each
    count here; the finish keeps its default) on that workload with and
    without ``-h`` (whose WIDE reads the finish thread solves natively), in
    turns, forward and back; one sampled run of each tree; and two pairs at
    the cell's own 100,000 reads."""
    from mia_tpu_torch.cli import mia as cli_mia
    from mia_tpu_torch.core import hostbatch
    from mia_tpu_torch.ops import dp_cuda
    from mia_tpu_torch.utils import profiling

    sides = {"earlier": load_package_copy(earlier_root), "this": (cli_mia, profiling, dp_cuda)}
    d = os.path.join(WORK, "prep_ab")
    tags = iter(range(10**6))

    def reference(inputs: dict, tag: str) -> dict:
        """The maln of this tree's ``--engine native`` on ``inputs``."""
        root = os.path.join(d, f"native{tag}", "out.maln")
        os.makedirs(os.path.dirname(root))
        with contextlib.redirect_stderr(io.StringIO()):
            run_mia(inputs["args"], root, "native")
        return maln_bytes(root)

    def workload(reads: int) -> tuple[dict, dict]:
        """The cell's traffic cut to ``reads`` and its reference maln."""
        inputs = wide_workload(os.path.join(d, f"in{reads}"), reads=reads)
        say(f"prep a/b: {inputs['held']}; {host_threads()}")
        return inputs, reference(inputs, str(reads))

    prepare = hostbatch.BatchHost.prepare

    def run(name: str, inputs: dict, want: dict, threads: int = 0) -> dict:
        """One run of ``name``; ``threads`` > 0 forces this tree's pass-1
        prepare to that many threads."""
        if threads:
            hostbatch.BatchHost.prepare = (
                lambda self, *a, n_threads=0: prepare(self, *a, n_threads=threads))
        try:
            got, wall, prof, counts = run_side(sides[name], inputs["args"],
                                               os.path.join(d, f"run{next(tags)}", "out.maln"),
                                               f"prep a/b ({name})")
        finally:
            hostbatch.BatchHost.prepare = prepare
        if not want or got != want:
            raise AssertionError(f"prep a/b: a run of {name} differs from --engine native")
        ph = prof["phases_s"]
        return {"wall": wall, "reads": inputs["reads"],
                **{p: ph.get(p, 0.0) for p in PREP_AB_PHASES},
                "errors": prof["counters"].get("pass1.prepare_host_only_errors", 0),
                "counts": counts}

    def say_run(what: str, r: dict) -> None:
        say(f"prep a/b: {what}: {r['wall']:.3f} s, {r['reads'] / r['wall']:.2f} reads/s; "
            + ", ".join(f"{p} {r[p]:.3f}" for p in PREP_AB_PHASES)
            + f"; prepare_host_only_errors {r['errors']}")

    def in_turns(inputs: dict, want: dict, n: int, label: str) -> None:
        warm = {name: run(name, inputs, want) for name in ("this", "earlier")}
        for name, r in warm.items():
            say_run(f"{label} warm-up ({name}), counts {json.dumps(r['counts'])}", r)
        runs: dict[str, list[dict]] = {"earlier": [], "this": []}
        for name in ab_order(n):
            r = run(name, inputs, want)
            if r["counts"] != warm[name]["counts"] or r["errors"]:
                raise AssertionError(f"prep a/b: {name}: counts {r['counts']} changed "
                                     f"or {r['errors']} prepare errors")
            runs[name].append(r)
            say_run(f"{label} {name}", r)
        wins = sum(b["wall"] < a["wall"] for a, b in zip(runs["earlier"], runs["this"]))
        say(f"prep a/b: {label}: {n} pairs in turns, every maln equal to --engine native's; "
            f"this tree faster in {wins} of {n} pairs")
        for name, rs in runs.items():
            say(f"prep a/b: {label}   {name}: reads/s "
                f"{quartiles([r['reads'] / r['wall'] for r in rs])}; "
                + "; ".join(f"{k} s {quartiles([r[k] for r in rs])}"
                            for k in ("wall", *PREP_AB_PHASES)))

    inputs, want = workload(20000)
    in_turns(inputs, want, pairs, "20k")

    # the prepare's threads, in turns: forward, then back; with -h too,
    # where the finish thread also solves the WIDE reads natively
    hp_inputs = dict(inputs, args=[*inputs["args"], "-h"])
    workloads = {"": (inputs, want), " -h": (hp_inputs, reference(hp_inputs, "20000h"))}
    total = hostbatch._default_threads()
    counts = sorted({t for t in (1, 2, 4, 6, 8, 12, 16) if t <= total} | {total})
    sweep: dict[tuple, list[dict]] = {(f, t): [] for f in workloads for t in counts}
    for k in range(max(pairs // 2, 2)):
        for t in counts if k % 2 == 0 else counts[::-1]:
            for f, (w_inputs, w_want) in workloads.items():
                r = run("this", w_inputs, w_want, t)
                sweep[f, t].append(r)
                say_run(f"sweep{f}, {t} prepare threads, finish {total}", r)
    for (f, t), rs in sweep.items():
        say(f"prep a/b: sweep{f} {t} prepare threads: "
            + "; ".join(f"{k} s {quartiles([r[k] for r in rs])}"
                        for k in ("wall", "pass1", "pass1.pack_prepare", "pass1.prep_wait",
                                  "pass1.native_finish", "pass1.py_merge")))
    for name in ("earlier", "this"):
        sampled_run(f"prep a/b: sampled run ({name})",
                    lambda: (None, run(name, inputs, want)["wall"]))

    inputs, want = workload(100000)
    in_turns(inputs, want, 2, "100k")


def raw_myers_waves(lib, bm_a, bm_b, len_a: int, len_b: int, maxd: int):
    """``launch()`` of ``lib``'s Myers kernel into a history and a result
    made here, on the padded bitmaps the wrapper would give it (no fill
    between launches: the kernel writes the same lanes each time)."""
    import torch

    from mia_tpu_torch.ops.myers_cuda import padded_bitmaps
    from mia_tpu_torch.ops.myers_torch import _NEG

    pad_a, pad_b = padded_bitmaps(bm_a, bm_b, len_a, len_b)
    hist = torch.full((maxd + 1, 2 * maxd + 1), _NEG, dtype=torch.int32, device=bm_a.device)
    found = torch.empty(2, dtype=torch.int32, device=bm_a.device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.mia_myers_waves(pad_a.data_ptr(), len_a, pad_b.data_ptr(), len_b, maxd, 0, 0,
                                 hist.data_ptr(), found.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"myers_waves kernel launch failed: CUDA error {rc}")

    return launch, hist, found


def phase_myers_ab(dev, earlier: str) -> None:
    """``--myers-ab``: the Myers kernel of the source ``earlier`` beside this
    tree's at its own thread count (the library's) and at 256 and 512."""
    import torch

    from mia_tpu_torch import testing as T
    from mia_tpu_torch.ops.myers_torch import bitmaps, waves_plain
    from mia_tpu_torch.utils.torchcfg import CSRC_DIR, build_sources, kernel_library

    lib = kernel_library()
    with open(os.path.join(CSRC_DIR, "myers_waves.cu")) as f:
        ours = f.read()
    decl = "constexpr int kThreads = 1024;"
    if ours.count(decl) != 1:
        raise AssertionError(f"myers_waves.cu: no single '{decl}'")
    with open(earlier) as f:
        sources = {"earlier": f.read()}
    sources.update({f"threads{n}": ours.replace(decl, f"constexpr int kThreads = {n};")
                    for n in (256, 512)})
    t0 = time.time()
    libs = {name: ctypes.CDLL(path)
            for name, path in build_sources(sources, os.path.join(WORK, "myers_ab")).items()}
    say(f"myers a/b: built {', '.join(libs)} in {time.time() - t0:.1f} s")
    for other in libs.values():
        other.mia_myers_waves.restype = lib.mia_myers_waves.restype
        other.mia_myers_waves.argtypes = lib.mia_myers_waves.argtypes
    libs["threads1024"] = lib
    order = list(libs) + list(libs)[::-1]
    for name, a, b, maxd in T.myers_phase_pairs():
        bm_a, bm_b = (torch.from_numpy(x).to(dev) for x in bitmaps(a, b))
        pd, pk, phist = waves_plain(bm_a, bm_b, len(a), len(b), maxd=maxd,
                                    mode_is_prefix=False, mode_has_prefix=False)
        launches = {}
        for build, other in libs.items():
            launch, hist, found = raw_myers_waves(other, bm_a, bm_b, len(a), len(b), maxd)
            launch()
            torch.cuda.synchronize()
            if tuple(found.tolist()) != (pd, pk):
                raise AssertionError(f"myers a/b {name}: {build} found {found.tolist()}, "
                                     f"plain {(pd, pk)}")
            check_equal(f"myers a/b {name}: {build} history != plain", hist, phist)
            launches[build] = launch
        waves = maxd if pd == maxd else pd + 1
        times: dict[str, list[float]] = {build: [] for build in libs}
        for build in order:
            cuda_ms(launches[build], 2)
            times[build].append(cuda_ms(launches[build], 20))
        say(f"myers a/b: {name} pair, {waves} waves, every build == plain (found, whole "
            f"history); bare launch, 20 a turn, in turns {' '.join(order)}:")
        for build, ts in times.items():
            say(f"myers a/b:   {build}: " + ", ".join(
                f"{t:.4f} ms ({t * 1e3 / waves:.4f} us a wave)" for t in ts))


def myers_live_lanes(len_a: int, len_b: int, waves: int) -> int:
    """Lanes the waves 0..waves-1 compute: each wave's band
    [max(-d, -len_a), min(d, len_b)]."""
    return sum(min(d, len_b) + min(d, len_a) + 1 for d in range(waves))


def phase_myers_kernel(dev) -> dict:
    import torch

    from mia_tpu_torch import testing as T
    from mia_tpu_torch.ops import myers_cuda
    from mia_tpu_torch.ops.myers import UINT_MAX, Mode, myers_diff
    from mia_tpu_torch.ops.myers_torch import bitmaps, myers_diff_torch, waves_plain
    from mia_tpu_torch.utils.torchcfg import kernel_library

    out = {}
    err = 0
    for name, a, b, maxd in T.myers_phase_pairs():
        bm_a, bm_b = (torch.from_numpy(x).to(dev) for x in bitmaps(a, b))
        args = (bm_a, bm_b, len(a), len(b))
        flags = dict(maxd=maxd, mode_is_prefix=False, mode_has_prefix=False)
        myers_cuda.reset_counts()
        kd, kk, khist = myers_cuda.waves(*args, **flags)
        pd, pk, phist = waves_plain(*args, **flags)
        torch.cuda.synchronize()
        if (kd, kk) != (pd, pk):
            raise AssertionError(f"myers {name}: kernel found (d, k) = {(kd, kk)}, "
                                 f"plain {(pd, pk)}")
        err = max(err, check_equal(f"myers {name}: history != plain", khist, phist))
        t0 = time.time()
        want = myers_diff(a, Mode.GLOBAL, b, maxd)
        host_s = time.time() - t0
        got = myers_diff_torch(a, Mode.GLOBAL, b, maxd, device=dev)
        if got != want:
            raise AssertionError(f"myers {name}: myers_diff_torch on the card gives "
                                 f"d={got[0]}, host myers_diff d={want[0]}")
        if (name == "unrelated") != (want[0] == UINT_MAX):
            raise AssertionError(f"myers {name}: unexpected distance {want[0]}")
        if (myers_cuda.kernel_launches, myers_cuda.plain_calls) != (2, 0):
            raise AssertionError(f"myers {name}: {myers_cuda.kernel_launches} launches, "
                                 f"{myers_cuda.plain_calls} plain calls")
        launch, hist, found = raw_myers_waves(kernel_library(), *args, maxd)
        cuda_ms(launch, 2)
        kernel_only_ms = cuda_ms(launch, 20)
        check_equal(f"myers {name}: history of the timed launches != plain", hist, phist)
        cuda_ms(lambda: myers_cuda.waves(*args, **flags), 2)
        ms = cuda_ms(lambda: myers_cuda.waves(*args, **flags), 20)
        plain_ms = cuda_ms(lambda: waves_plain(*args, **flags), 2)
        waves = maxd if kd == maxd else kd + 1
        # what this pair's data needs: the bitmaps read, a history word
        # written for every lane the waves compute (about 10 operations
        # each), and the snakes' steps over about one sequence's length
        # (about 3 operations a base)
        lanes = myers_live_lanes(len(a), len(b), waves)
        bnd = bound(len(a) + len(b) + 4 * lanes + 8, 10 * lanes + 3 * max(len(a), len(b)))
        say(f"myers kernel: {name} pair {len(a)} x {len(b)}, maxd {maxd}: d="
            f"{'none (UINT_MAX)' if kd == maxd else kd}, k={kk}, {waves} waves, {lanes} "
            f"lanes; kernel == plain (found and the whole history, exact) and "
            f"myers_diff_torch == host myers_diff (d, bt_a, bt_b); kernel alone "
            f"{kernel_only_ms:.4f} ms, {kernel_only_ms * 1e3 / waves:.4f} us a wave; through "
            f"its wrapper {ms:.4f} ms; plain version {plain_ms:.4f} ms; host myers_diff "
            f"{host_s:.3f} s; bound {bnd['bound_ms']:.6f} ms ({bnd['bound_by']})")
        out[name] = {"ms": ms, "kernel_only_ms": kernel_only_ms, "waves": waves,
                     "us_per_wave": kernel_only_ms * 1e3 / waves, "plain_ms": plain_ms,
                     "library_ms": None, **bnd}
    return {"max_abs_err": err, **out["1%"], "pairs": out}


def run_ccheck(argv: list[str], profile: bool) -> tuple[bytes, dict, float]:
    """The port's ccheck CLI in this process: (stdout bytes, profile or {},
    wall s).  Raises unless it exits 0."""
    from mia_tpu_torch.cli.ccheck import main

    out, err = io.StringIO(), io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([*argv, "--profile"] if profile else argv)
    wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"ccheck {' '.join(argv)} exited {rc}:\n{err.getvalue()}")
    prof = {}
    for line in err.getvalue().splitlines():
        if line.startswith("MIA_PROFILE "):
            prof = json.loads(line.split(" ", 1)[1])
    return out.getvalue().encode(), prof, wall


def run_port_ccheck(argv: list[str], what: str) -> tuple[bytes, dict, float, dict]:
    """The port's ccheck under ``--engine torch`` with every count set to 0
    just before it and read just after; raises unless the run went through
    one Myers kernel launch and the scorer, with no plain call.  Returns
    (stdout, profile, wall s, counts)."""
    from mia_tpu_torch.cli import ccheck

    reset_counts()
    out, prof, wall = run_ccheck(argv, profile=True)
    counts = ccheck.counts()
    if not (counts["myers.kernel_launches"] == 1 and counts["dp.kernel_launches"] > 0
            and counts["ccheck.device_entries"] > 0
            and counts["myers.plain_calls"] == counts["dp.plain_calls"] == 0):
        raise AssertionError(f"ccheck device path not taken ({what}): {counts}")
    return out, prof, wall, counts


def phase_ccheck_golden() -> None:
    d = os.path.join(REPO, "tests", "golden", "ccheck")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        for argv, golden in ((["cc.maln.1"], "prose.txt"),
                             (["-T", "-a", "cc.maln.1"], "table_a.txt")):
            out, _, wall, counts = run_port_ccheck(argv, golden)
            with open(golden, "rb") as f:
                if out != f.read():
                    raise AssertionError(f"ccheck {' '.join(argv)} differs from {golden}")
            say(f"ccheck golden: {' '.join(argv)} byte-identical to "
                f"tests/golden/ccheck/{golden} ({wall:.3f} s); {json.dumps(counts)}")
    finally:
        os.chdir(cwd)


def ccheck_workload(n_endo: int, n_cont: int) -> tuple[list[str], str]:
    """Writes phase 11's sample: reads of an mt311-derived sample and of a
    contaminant, and the resolved mt311 as reference.  Returns the mia
    arguments and the maln root."""
    from mia_tpu_torch import testing as T
    from mia_tpu_torch.models.simulate import SimConfig, simulate_reads

    d = os.path.join(WORK, "ccheck")
    os.makedirs(d)
    reference, sample, contaminant = T.ccheck_sample(seed=41)
    ref_fn, frag_fn = os.path.join(d, "mt311_resolved.fna"), os.path.join(d, "reads.fastq")
    with open(ref_fn, "w") as f:
        f.write(">mt311_resolved\n")
        for i in range(0, len(reference), 70):
            f.write(reference[i : i + 70] + "\n")
    with open(frag_fn, "w") as f:
        for tag, src, n, seed in (("e", sample, n_endo, 42), ("c", contaminant, n_cont, 43)):
            for name, seq, qual in simulate_reads(
                src, SimConfig(num_reads=n, mean_len=60, seed=seed)
            ):
                f.write(f"@{tag}_{name}\n{seq}\n+\n{qual}\n")
    return (["-r", ref_fn, "-f", frag_fn, "-c", "-u", "-k", "12",
             "-s", os.path.join(REPO, SUBMAT)], os.path.join(d, "out.maln"))


def phase_ccheck_e2e(n_endo: int = 9000, n_cont: int = 1000) -> dict:
    from mia_tpu_torch.cli.ccheck import find_maln

    args, root = ccheck_workload(n_endo, n_cont)
    t0 = time.time()
    run_port(args, root)
    t_mia = time.time() - t0
    maln = find_maln(root + ".1")
    launches = 0
    for argv in (["-a", maln], ["-T", "-a", maln]):
        what = " ".join(argv[:-1])
        out, prof, t_torch, counts = run_port_ccheck(argv, what)
        want, _, t_native = run_ccheck(["--engine", "native", *argv], profile=False)
        if out != want:
            raise AssertionError(f"ccheck {what} on the {n_endo + n_cont}-read sample "
                                 f"differs from --engine native")
        launches += counts["myers.kernel_launches"]
        lines = out.decode().splitlines()
        if "-T" in argv:
            result = "table row " + lines[1]
        else:
            result = "; ".join(ln.strip() for ln in lines if "alignment distance" in ln
                               or "polluting" in ln)
        ph = prof["phases_s"]
        say(f"ccheck e2e {what}: {n_endo} + {n_cont} reads, final maln "
            f"{os.path.basename(maln)}: {result}; stdout byte-identical to "
            f"--engine native; {json.dumps(counts)}")
        say(f"ccheck e2e {what}: wall s in this process, torch {t_torch:.3f} "
            f"(Myers {ph['ccheck.myers']:.3f}, realignment {ph['ccheck.realign']:.3f}), "
            f"native {t_native:.3f}; assembly by the port's mia {t_mia:.3f}")
    return {"myers.kernel_launches": launches}


def quartiles(xs: list[float]) -> str:
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return f"median {q2:.3f} [{q1:.3f}-{q3:.3f}]"


def ab_order(pairs: int) -> list[str]:
    """The runs of an a/b phase in turns, each order in every other pair."""
    return [name for i in range(pairs)
            for name in (("earlier", "this") if i % 2 == 0 else ("this", "earlier"))]


def phase_ccheck_ab(earlier: str, pairs: int) -> None:
    """``--ccheck-ab``: ccheck's host layer ``earlier`` (an earlier
    ``core/contamination.py``, loaded beside this tree's and run with this
    tree's other modules) against this tree's, whole ``ccheck.main`` calls
    in turns on phase 11's sample."""
    import importlib.util

    from mia_tpu_torch.cli import ccheck
    from mia_tpu_torch.cli.ccheck import find_maln

    spec = importlib.util.spec_from_file_location(
        "mia_tpu_torch.core.contamination_earlier", earlier)
    layers = {"earlier": importlib.util.module_from_spec(spec), "this": ccheck.contamination}
    sys.modules[spec.name] = layers["earlier"]  # its dataclasses look themselves up
    spec.loader.exec_module(layers["earlier"])
    n_endo, n_cont = 9000, 1000
    args, root = ccheck_workload(n_endo, n_cont)
    run_port(args, root)
    argv = ["-a", find_maln(root + ".1")]
    want, _, t_native = run_ccheck(["--engine", "native", *argv], profile=False)
    runs: dict[str, list[dict]] = {name: [] for name in layers}
    for name in ab_order(pairs):
        ccheck.contamination = layers[name]
        try:
            out, prof, wall, counts = run_port_ccheck(argv, f"a/b {name}")
        finally:
            ccheck.contamination = layers["this"]
        if out != want:
            raise AssertionError(f"ccheck a/b: {name}'s stdout differs from --engine native")
        ph = prof["phases_s"]
        run = {"wall": wall, "realign": ph["ccheck.realign"], "myers": ph["ccheck.myers"],
               "walks": wall - ph["ccheck.realign"] - ph["ccheck.myers"]}
        runs[name].append(run)
        say(f"ccheck a/b: {name}: {wall:.3f} s, {(n_endo + n_cont) / wall:.2f} reads/s; walks "
            f"{run['walks']:.3f}, realign {run['realign']:.3f}, myers {run['myers']:.4f}; "
            f"{json.dumps(counts)}")

    wins = sum(b["wall"] < a["wall"] for a, b in zip(runs["earlier"], runs["this"]))
    say(f"ccheck a/b: {pairs} pairs in turns on {n_endo} + {n_cont} reads, every run "
        f"byte-identical to --engine native ({t_native:.3f} s); this tree faster in "
        f"{wins} of {pairs} pairs")
    for name, rs in runs.items():
        rates = [(n_endo + n_cont) / r["wall"] for r in rs]
        say(f"ccheck a/b:   {name}: reads/s {quartiles(rates)}; "
            + "; ".join(f"{k} s {quartiles([r[k] for r in rs])}"
                        for k in ("wall", "walks", "realign", "myers")))


HP_AB_PHASES = ("pass1", "pass1.native_finish", "pass1.py_merge", "pass1.collect_wait",
                "filters.cull", "consensus", "consensus.ins_cols", "reiterate", "gc")
HP_AB_COUNTERS = ("pass1.device_scored_reads", "pass1.device_scored_wide_reads",
                  "pass1.native_solved_wide_reads", "pass1.finish_host_reads")


def phase_hp_ab(earlier_root: str, pairs: int) -> None:
    """``--hp-ab``: :func:`port_ab` with ``-h`` on the ``-h`` cell's traffic
    at seed 41 (20,000 reads with homopolymer-length errors at the cell's
    rate): pass 1's phases (``pass1``, ``pass1.native_finish``), the cull's
    and consensus's, the wide reads' counters and, from ``run_side``, the
    ``-h`` scorers' launches; no sampled runs."""
    from types import SimpleNamespace

    from benchmark import cells
    from benchmark.run import load_benchmark, load_config

    cell = next(w for w in load_benchmark()["workloads"] if w["name"] == "mia-hsmt-100k-h")
    d = os.path.join(WORK, "hp_ab")
    os.makedirs(d)
    inputs = cells.make_inputs(SimpleNamespace(seed=41, scale=1.0, work=d), cell,
                               load_config(cell))
    port_ab("hp a/b", earlier_root, pairs, dict(inputs, work=d), HP_AB_PHASES,
            HP_AB_COUNTERS, sampled=False)


MERGE_AB_LAYER = ("entries", "driver", "assembler")  # core/ modules, in import order
MERGE_AB_PHASES = ("pass1", "pass1.py_merge", "reiterate", "reiterate.classify",
                   "reiterate.device_drain", "reiterate.merge", "gc")
MERGE_AB_COUNTERS = ("pass1.device_scored_reads", "reiterate.device_entries")


def load_earlier_layer(earlier_root: str, names: tuple[str, ...]) -> dict:
    """The modules ``mia_tpu_torch/core/<name>.py`` of ``earlier_root``,
    loaded beside this tree's in order, each bound to the earlier modules
    loaded before it in place of this tree's (the names it imported from
    them), and to this tree's for every other module."""
    import importlib
    import importlib.util

    earlier: dict = {}
    for name in names:
        this = importlib.import_module(f"mia_tpu_torch.core.{name}")
        spec = importlib.util.spec_from_file_location(
            f"{this.__name__}_earlier",
            os.path.join(earlier_root, "mia_tpu_torch", "core", name + ".py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
        for attr, obj in list(vars(module).items()):
            for before, m in earlier.items():
                if (getattr(obj, "__module__", None) == f"mia_tpu_torch.core.{before}"
                        and hasattr(m, attr)):
                    setattr(module, attr, getattr(m, attr))
        earlier[name] = module
    return earlier


def phase_merge_ab(earlier_root: str, pairs: int) -> None:
    """``--merge-ab``: mia's pass-1 merge and realignment host layer of
    ``earlier_root`` (a checkout of an earlier commit: its ``core/entries.py``,
    ``core/driver.py`` and ``core/assembler.py``, loaded beside this tree's
    and bound to each other) against this tree's, whole ``mia.main`` calls
    with ``--engine torch --profile`` in turns on the ``mia-hsmt-100k``
    cell's traffic at seed 41 (100,000 reads).  Every run's maln bytes must
    equal the earlier layer's first run's, and its scored reads, device
    entries and kernel launches the first run's."""
    from types import SimpleNamespace

    from benchmark import cells
    from benchmark.run import load_benchmark, load_config
    from mia_tpu_torch.cli import mia as cli_mia
    from mia_tpu_torch.ops import consensus_torch, dp_cuda

    layers = {"earlier": load_earlier_layer(earlier_root, MERGE_AB_LAYER)["assembler"]
              .run_assembly, "this": cli_mia.run_assembly}
    cell = next(w for w in load_benchmark()["workloads"] if w["name"] == "mia-hsmt-100k")
    d = os.path.join(WORK, "merge_ab")
    os.makedirs(d)
    inputs = cells.make_inputs(SimpleNamespace(seed=41, scale=1.0, work=d), cell,
                               load_config(cell))
    say(f"merge a/b: {inputs['held']}")

    gc_s = [0.0]
    gc_t0 = [0.0]

    def gc_clock(phase: str, info: dict) -> None:
        """The collector's time during a run (it runs on every thread's
        allocations; no phase of the profile isolates it)."""
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_t0[0]

    def run(name: str, tag: str) -> tuple[dict, float, dict, dict]:
        root = os.path.join(d, tag, "out.maln")
        os.makedirs(os.path.dirname(root))
        cli_mia.run_assembly = layers[name]
        reset_counts()
        gc_s[0] = 0.0
        gc.callbacks.append(gc_clock)
        t0 = time.time()
        try:
            # the run's own log would bury the phase's lines
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()):
                prof = run_port(inputs["args"], root, profile=True)
        finally:
            cli_mia.run_assembly = layers["this"]
            gc.callbacks.remove(gc_clock)
        wall = time.time() - t0
        prof["phases_s"]["gc"] = gc_s[0]
        counts = {"dp.kernel_launches": dp_cuda.kernel_launches,
                  "dp.plain_calls": dp_cuda.plain_calls,
                  "cons.kernel_launches": consensus_torch.kernel_launches,
                  "cons.plain_calls": consensus_torch.plain_calls,
                  **{c: prof["counters"].get(c, 0) for c in MERGE_AB_COUNTERS}}
        if (counts["dp.plain_calls"] or counts["cons.plain_calls"]
                or not counts["dp.kernel_launches"] or not counts["cons.kernel_launches"]):
            raise AssertionError(f"merge a/b: {tag} ({name}) did not score on the card: "
                                 f"{counts}")
        return maln_bytes(root), wall, prof, counts

    want, wall, _, want_counts = run("earlier", "warm")
    say(f"merge a/b: warm-up (earlier layer) {wall:.3f} s, {len(want)} maln files; "
        f"{json.dumps(want_counts)}")
    runs: dict[str, list[dict]] = {"earlier": [], "this": []}
    for k, name in enumerate(ab_order(pairs)):
        got, wall, prof, counts = run(name, f"run{k}")
        if got != want:
            raise AssertionError(f"merge a/b: run {k} ({name}) maln differs from the earlier "
                                 f"layer's")
        if counts != want_counts:
            raise AssertionError(f"merge a/b: run {k} ({name}) counts {counts} differ from "
                                 f"the earlier layer's {want_counts}")
        ph = prof["phases_s"]
        r = {"wall": wall, **{p: ph.get(p, 0.0) for p in MERGE_AB_PHASES}}
        runs[name].append(r)
        say(f"merge a/b: {name}: {wall:.3f} s, {inputs['reads'] / wall:.2f} reads/s; "
            + ", ".join(f"{p} {r[p]:.3f}" for p in MERGE_AB_PHASES))
    wins = sum(b["wall"] < a["wall"] for a, b in zip(runs["earlier"], runs["this"]))
    say(f"merge a/b: {pairs} pairs in turns, every run's maln byte-identical to the earlier "
        f"layer's and its counts equal; this tree faster in {wins} of {pairs} pairs")
    for name, rs in runs.items():
        rates = [inputs["reads"] / r["wall"] for r in rs]
        say(f"merge a/b:   {name}: reads/s {quartiles(rates)}; "
            + "; ".join(f"{k} s {quartiles([r[k] for r in rs])}"
                        for k in ("wall", *MERGE_AB_PHASES)))
    # one more run of this tree, untimed, with every thread's stack sampled
    samples: dict = {}
    stop = threading.Event()
    sampler = threading.Thread(target=sample_stacks, args=(stop, samples), daemon=True)
    sampler.start()
    try:
        got, wall, _, _ = run("this", "sampled")
    finally:
        stop.set()
        sampler.join(timeout=10)
    if got != want:
        raise AssertionError("merge a/b: the sampled run's maln differs from the earlier layer's")
    say_samples("merge a/b: sampled run of this tree", samples, wall)


def sample_stacks(stop: threading.Event, samples: dict, period_s: float = 0.002) -> None:
    """Every ``period_s``, each other thread's innermost frame in the
    package (the package's function that called whatever runs, native code
    or a wait included) and its outermost one (the thread's task): a
    sampling profile of wall time by thread, which the run's phases, each
    measured on one thread, cannot give."""
    me = threading.get_ident()
    pkgs = [os.path.join(REPO, "mia_tpu_torch") + os.sep, os.path.join(WORK, "pkg") + os.sep]
    while not stop.is_set():
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            if tid == me or tid not in names:
                continue
            inner = task = None
            f = frame
            while f is not None:
                pkg = next((p for p in pkgs if f.f_code.co_filename.startswith(p)), None)
                if pkg is not None:
                    where = (f"{f.f_code.co_filename[len(pkg):]}:{f.f_code.co_name}")
                    inner = inner or where
                    task = where
                f = f.f_back
            if inner is not None:
                key = (names[tid].split("_")[0], task, inner)
                samples[key] = samples.get(key, 0) + 1
        time.sleep(period_s)


def say_samples(what: str, samples: dict, wall: float) -> None:
    """The sampled threads' time by task and innermost package function."""
    by_thread: dict = {}
    for (thread, task, inner), n in samples.items():
        by_thread.setdefault((thread, task), {})[inner] = n
    total = max(sum(samples.values()), 1)
    say(f"{what}: {wall:.3f} s wall, {total} samples")
    for (thread, task), inners in sorted(by_thread.items(), key=lambda kv: -sum(kv[1].values())):
        n = sum(inners.values())
        if n < total / 200:
            continue
        top = sorted(inners.items(), key=lambda kv: -kv[1])[:8]
        say(f"  {thread} {task}: {n} samples; "
            + ", ".join(f"{k} {100 * v / n:.1f}%" for k, v in top))


def time_plain_pair(kernel, plain, what: str, unit: str = "") -> dict:
    """Kernel and plain times per call (CUDA events, warmed up)."""
    cuda_ms(kernel, 3)
    ms = cuda_ms(kernel, 20)
    plain()
    plain_ms = cuda_ms(plain, 3)
    say(f"{what}: {ms:.4f} ms, plain version {plain_ms:.4f} ms{unit}")
    return {"ms": ms, "plain_ms": plain_ms}


def phase_last_row_kernel(dev) -> dict:
    import numpy as np
    import torch

    from mia_tpu_torch import testing as T
    from mia_tpu_torch.core.driver import init_alignment, set_seq1, set_seq2
    from mia_tpu_torch.ops import dp_cuda, dp_numpy
    from mia_tpu_torch.ops.dp_torch import batch_last_row

    # this phase's launches only (--kernels runs it right after phase 6a's)
    before = (dp_cuda.last_row_wide_launches, dp_cuda.last_row_plain_calls)

    res = {}
    for shared in (True, False):
        what = "shared reference" if shared else "per-read reference"
        d = T.fullwidth_inputs(FW_B, FW_W, L_ROWS, seed=21, shared=shared)
        args = [torch.from_numpy(d[k]).to(dev) for k in T.LAST_ROW_KEYS]
        got = dp_cuda.dp_last_row(*args)
        want = batch_last_row(*args)
        torch.cuda.synchronize()
        err = check_equal(f"dp_last_row != plain ({what})", got, want)
        cells = int((d["lengths"].astype(np.int64) - 1).sum()) * FW_W
        say(f"last-row kernel: dp_last_row == batch_last_row on B={FW_B} W={FW_W} "
            f"L={L_ROWS}, {what} (the whole [B, W] row, exact; max |diff| {err})")
        t = time_plain_pair(lambda: dp_cuda.dp_last_row(*args), lambda: batch_last_row(*args),
                            f"last-row kernel, {what}",
                            f"; {cells} cells, mean read length "
                            f"{float(np.mean(d['lengths'])):.1f}")
        say(f"last-row kernel, {what}: {cells / t['ms'] / 1e6:.3f} Gcells/s, plain "
            f"version {cells / t['plain_ms'] / 1e6:.3f} Gcells/s")
        out = torch.empty_like(got)
        p = [a.data_ptr() for a in args]  # LAST_ROW_KEYS: s1c mask s2c lengths depths submat
        t["kernel_only_ms"] = time_raw_launch(lambda lib, stream: lib.mia_dp_last_row(
            p[0], int(not shared), p[1], p[2], p[4], p[5], p[3], FW_B, FW_W, L_ROWS, 1,
            out.data_ptr(), stream), f"last-row kernel, {what}", t["ms"], 20)
        # s2c and depths count up to each read's own length
        moved = (nbytes(args[0], args[1], args[3], args[5], got)
                 + read_bytes(d["lengths"], args[2], args[4]))
        res[shared] = {"max_abs_err": err, **t, "library_ms": None,
                       **bound(moved, DP_OPS_PER_CELL * cells)}
        if not shared:
            continue
        # 32 rows against the exact host DP: best score and its earliest column
        out = got[:32].cpu().numpy()
        chars = np.array(list("ACGTN"))
        a = init_alignment(L_ROWS, FW_W + 16, False, False)
        a.submat = d["submat"]
        set_seq1(a, "".join(chars[d["s1c"]]))
        a.sg5 = a.sg3 = True
        for b in range(32):
            set_seq2(a, "".join(chars[d["s2c"][b, : d["lengths"][b]]]))
            dp_numpy.solve_sg(a, do_trace=False)
            if (int(a.best_score), int(a.aec)) != (int(out[b].max()), int(out[b].argmax())):
                raise AssertionError(f"last-row kernel != solve_sg on read {b}")
        say("last-row kernel: dp_last_row's (max, earliest argmax) == dp_numpy.solve_sg "
            "on 32 reads")
    say(f"last-row kernel: per-read reference {res[False]['ms']:.4f} ms against shared "
        f"{res[True]['ms']:.4f} ms")
    if (dp_cuda.last_row_wide_launches, dp_cuda.last_row_plain_calls) != before:
        raise AssertionError("last-row kernel: the full-width shape left the register form")
    return res[True]


def time_raw_launch(call, what: str, wrapper_ms: float, iters: int = 200) -> float:
    """Mean device ms of a small kernel alone: ``call(library, stream)``
    launched back to back into buffers made beforehand (CUDA events).  The
    ``kernels`` line carries it as ``kernel_only_ms`` beside ``ms``, which is
    the wrapper's time for every kernel: for a kernel this small the events
    around the wrapper see its host work (checks, allocations, the launch)."""
    import torch

    from mia_tpu_torch.utils.torchcfg import kernel_library

    lib, stream = kernel_library(), torch.cuda.current_stream().cuda_stream

    def launch():
        rc = call(lib, stream)
        if rc:
            raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")

    cuda_ms(launch, 5)
    ms = cuda_ms(launch, iters)
    say(f"{what}: the kernel alone {ms:.4f} ms ({wrapper_ms:.4f} ms through its wrapper: "
        f"checks, allocations, the launch)")
    return ms


def phase_step_kernels(dev) -> tuple[dict, dict]:
    import torch

    from mia_tpu_torch import testing as T
    from mia_tpu_torch.parallel import sharded

    d = T.pileup_inputs(STEP_B, FW_W, L_ROWS, seed=22)
    args = [torch.from_numpy(d[k]).to(dev) for k in T.PILEUP_KEYS]
    counts, scores = sharded.pileup_counts(*args, FW_W)
    pc, ps = sharded._pileup_counts(*args, FW_W)
    torch.cuda.synchronize()
    err = max(check_equal("pileup_counts != plain (counts)", counts, pc),
              check_equal("pileup_counts != plain (scores)", scores, ps))
    n_obs = int(counts.sum())
    say(f"pileup kernel: pileup_counts == _pileup_counts on B={STEP_B} W={FW_W} "
        f"L={L_ROWS}, {n_obs} bases in range (exact)")
    t = time_plain_pair(lambda: sharded.pileup_counts(*args, FW_W),
                        lambda: sharded._pileup_counts(*args, FW_W), "pileup kernel")
    # a call is host work of a few tens of microseconds: enough of them that
    # one pause of the interpreter does not decide the mean
    t["ms"] = cuda_ms(lambda: sharded.pileup_counts(*args, FW_W), 200)
    # the scatter alone, as library calls on indices and terms made
    # beforehand (the lookups are not in it): the score terms alone, the
    # yardstick of earlier runs, and both index_add_ calls of the plain
    # version together, which is the whole of what the kernel adds
    cols = torch.randint(0, FW_W, (n_obs,), device=dev)
    terms = torch.randint(-600, 200, (n_obs, 4), dtype=torch.int32, device=dev)
    acc = torch.zeros((FW_W, 4), dtype=torch.int32, device=dev)
    scores_only_ms = cuda_ms(lambda: acc.index_add_(0, cols, terms), 200)
    say(f"pileup kernel: index_add_ of {n_obs} x 4 score terms alone {scores_only_ms:.4f} ms "
        f"(the scatter without the lookups)")
    slots = cols * 5 + torch.randint(0, 5, (n_obs,), device=dev)
    ones = torch.ones(n_obs, dtype=torch.int32, device=dev)
    acc5 = torch.zeros(FW_W * 5, dtype=torch.int32, device=dev)

    def both():
        acc5.index_add_(0, slots, ones)
        acc.index_add_(0, cols, terms)

    cuda_ms(both, 5)
    library_ms = cuda_ms(both, 200)
    say(f"pileup kernel: index_add_ of the {n_obs} counts and of the {n_obs} x 4 score "
        f"terms together {library_ms:.4f} ms (both scatters of the plain version)")
    acc_c, acc_s = torch.zeros_like(counts), torch.zeros_like(scores)
    t["kernel_only_ms"] = time_raw_launch(lambda lib, stream: lib.mia_pileup_counts(
        *(a.data_ptr() for a in (args[0], args[3], args[1], args[2], args[4], args[5],
                                 args[6])),
        STEP_B, L_ROWS, FW_W, acc_c.data_ptr(), acc_s.data_ptr(), stream),
        "pileup kernel", t["ms"])
    # PILEUP_KEYS: s2c and depths count up to each read's own length (the
    # kernel skips the rows past it), everything else whole
    moved = (nbytes(args[1], args[2], args[4], args[5], args[6], counts, scores)
             + read_bytes(d["lengths"], args[0], args[3]))
    pile = {"max_abs_err": err, **t, "library_ms": library_ms,
            "library_scores_only_ms": scores_only_ms, **bound(moved, 5 * n_obs)}
    if sharded.pileup_plain_calls:
        raise AssertionError("pileup kernel: the plain version was called through the wrapper")

    # the consensus call over dp parts: four pileups of reads of their own
    # (the step's dp = 4) and the columns of each at an odd offset; one part
    # (the pileup, tie_counts); tie_counts cut into four parts whose running
    # sums wrap, and four parts whose own sums wrap
    parts = [(counts, scores)] + [sharded.pileup_counts(
        *(torch.from_numpy(a).to(dev) for a in (T.pileup_inputs(STEP_B, FW_W, L_ROWS,
                                                                 seed=22 + p)[k]
                                                for k in T.PILEUP_KEYS)), FW_W)
        for p in range(1, 4)]
    pc, ps = [c for c, _ in parts], [x for _, x in parts]

    def on(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    tie = T.tie_counts(FW_W, seed=23)
    cases = [("four pileups", pc, ps),
             ("four pileups from column 3", [c[3:-2] for c in pc], [x[3:-2] for x in ps]),
             ("the pileup", [counts], [scores]), ("ties", on(tie[:1]), on(tie[1:])),
             ("ties in four parts", *map(on, T.split_parts(*tie, 4, seed=23, big=True))),
             ("four wrapping parts", *map(on, T.wrapping_parts(FW_W, 4, seed=23)))]
    err = 0
    sharded.reset_counts()
    for what, c, x in cases:
        got = sharded.consensus_call(c, x)
        err = max(err, check_equal(f"consensus_call != plain ({what})", got,
                                   sharded.consensus_from_parts(c, x)))
    # the step's form: a block's columns read in place from the whole parts
    check_equal("consensus_call on columns 3 to W - 2 read in place != on their copies",
                sharded.consensus_call(pc, ps, slice(3, FW_W - 2)),
                sharded.consensus_call(*cases[1][1:]))
    if (sharded.consensus_launches, sharded.consensus_plain_calls) != (len(cases) + 2, 0):
        raise AssertionError(f"consensus-call kernel: {sharded.consensus_launches} launches for "
                             f"{len(cases) + 2} calls")
    say(f"consensus-call kernel: consensus_call == consensus_from_parts on {FW_W} columns "
        f"({'; '.join(what for what, _, _ in cases)}; columns 3 to W - 2 also read in place; "
        f"exact), one launch a call")
    t = time_plain_pair(lambda: sharded.consensus_call(pc, ps),
                        lambda: sharded.consensus_from_parts(pc, ps),
                        "consensus-call kernel, four parts")
    t["ms"] = cuda_ms(lambda: sharded.consensus_call(pc, ps), 200)
    one_ms = cuda_ms(lambda: sharded.consensus_call(counts, scores), 200)
    # the step's tail as it was: the sum over dp as separate adds, then one part
    adds_ms = cuda_ms(lambda: sharded.consensus_call(pc[0] + pc[1] + pc[2] + pc[3],
                                                     ps[0] + ps[1] + ps[2] + ps[3]), 200)
    say(f"consensus-call kernel through its wrapper (200 calls a mean): four parts "
        f"{t['ms']:.4f} ms, one part {one_ms:.4f} ms, the four parts summed by six adds and "
        f"then one part {adds_ms:.4f} ms")
    out = torch.empty(FW_W, dtype=torch.uint8, device=dev)
    ptrs = ctypes.c_void_p * 4
    cp, sp = ptrs(*(c.data_ptr() for c in pc)), ptrs(*(x.data_ptr() for x in ps))
    t["kernel_only_ms"] = time_raw_launch(lambda lib, stream: lib.mia_consensus_call(
        cp, sp, 4, FW_W, out.data_ptr(), stream), "consensus-call kernel, four parts", t["ms"])
    one_raw = time_raw_launch(lambda lib, stream: lib.mia_consensus_call(
        cp, sp, 1, FW_W, out.data_ptr(), stream), "consensus-call kernel, one part", one_ms)
    # per column 9 adds a part and about 15 compares and adds
    cons = {"max_abs_err": err, **t, "parts": 4, "ms_one_part": one_ms,
            "kernel_only_ms_one_part": one_raw, "ms_six_adds_then_one_part": adds_ms,
            "library_ms": None, **bound(nbytes(*pc, *ps) + FW_W, (9 * 4 + 15) * FW_W)}
    return pile, cons


def phase_step(dev) -> dict:
    """One assembly step at dp=4, sp=2 with all eight mesh cells on the one
    card; returns the three kernels' launch counts of the step."""
    import numpy as np
    import torch

    from mia_tpu_torch import testing as T
    from mia_tpu_torch.ops import dp_cuda
    from mia_tpu_torch.ops.dp_torch import batch_best_and_aec, batch_last_row
    from mia_tpu_torch.parallel import sharded

    args = T.step_inputs(STEP_B, FW_W, 120, seed=24)
    s1c, mask, s2c, lengths, depths, fpsm, rpsm = args
    step = sharded.make_assembly_step(sharded.make_mesh(4, 2, [dev] * 8))
    reset_counts()
    t0 = time.time()
    best, aec, cons = step(*args)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {"dp.last_row_launches": dp_cuda.last_row_launches,
              "dp.last_row_wide_launches": dp_cuda.last_row_wide_launches,
              "dp.last_row_plain_calls": dp_cuda.last_row_plain_calls,
              "step.pileup_launches": sharded.pileup_launches,
              "step.pileup_plain_calls": sharded.pileup_plain_calls,
              "step.consensus_launches": sharded.consensus_launches,
              "step.consensus_plain_calls": sharded.consensus_plain_calls}
    if counts != {"dp.last_row_launches": 4, "dp.last_row_wide_launches": 0,
                  "dp.last_row_plain_calls": 0,
                  "step.pileup_launches": 4, "step.pileup_plain_calls": 0,
                  "step.consensus_launches": 2, "step.consensus_plain_calls": 0}:
        # W = 17,024 divides by sp = 2: no tail to call
        raise AssertionError(f"assembly step: kernels not launched as expected: {counts}")
    # the sum over dp is the consensus kernel's: a second step, every ATen
    # operation logged, has no add over any [*, 5] or [*, 4] accumulator
    again, ops = T.aten_ops(step, *args)
    sums = [(op, shapes) for op, shapes in ops if op.startswith("aten.add")
            and any(len(sh) == 2 and sh[1] in (4, 5) for sh in shapes)]
    if sums:
        raise AssertionError(f"assembly step: the sum over dp left adds: {sums[:4]}")
    check_equal("assembly step: a second step's consensus differs", again[2], cons)

    # the single-device scorer on the whole batch, and the first dp shard's
    # rows of it against the plain version on the step's own inputs
    on_dev = [torch.from_numpy(a).to(dev) for a in (s1c, mask, s2c, lengths, depths, fpsm)]
    one = dp_cuda.dp_last_row(*on_dev)
    n0 = STEP_B // 4
    check_equal("assembly step: dp_last_row != plain on the first shard's rows", one[:n0],
                batch_last_row(on_dev[0], *(a[:n0] for a in on_dev[1:5]), on_dev[5]))
    best1, aec1 = batch_best_and_aec(one)
    check_equal("assembly step: best != single-device scorer", best, best1)
    check_equal("assembly step: aec != single-device scorer", aec, aec1)
    # the consensus rebuilt with numpy scatter-adds
    aec_np = aec1.cpu().numpy()
    rows = np.arange(s2c.shape[1])[None, :]
    cols = (aec_np - lengths + 1)[:, None] + rows
    ok = (rows < lengths[:, None]) & (cols >= 0) & (cols < FW_W)
    cnt = np.zeros((FW_W, 5), np.int32)
    sco = np.zeros((FW_W, 4), np.int32)
    np.add.at(cnt, (cols[ok], s2c[ok]), 1)
    np.add.at(sco, cols[ok], fpsm[depths[ok], :4, s2c[ok]])
    want = sharded.consensus_from_counts(torch.from_numpy(cnt), torch.from_numpy(sco))
    check_equal("assembly step: consensus != numpy rebuild", cons.cpu(), want)
    called = bytes(want.numpy())
    say(f"assembly step: dp=4 sp=2 on {dev} eight times over, B={STEP_B} W={FW_W}: "
        f"(best, aec) == single-device scorer (its first {n0} rows == plain version, "
        f"the whole row), consensus == numpy rebuild "
        f"({sum(called.count(c) for c in b'ACGT')} columns called, "
        f"{called.count(b'N')} N); {wall:.3f} s with the host's copies; "
        f"{json.dumps(counts)}; a second step's {len(ops)} ATen operations hold no add "
        f"over the dp shards' accumulators (their sum is the consensus kernel's)")

    # the warm step, and what its four scorer launches take of it on the
    # card: with the register form, and with every launch sent to the wide
    # form, which is the kernel the scorer had before the register form
    scorer = dp_cuda.dp_last_row
    reach = dp_cuda.LAST_ROW_THREADS
    for what, threads in (("register form", reach), ("wide form (the earlier kernel)", 0)):
        spans = []

        def timed_scorer(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = scorer(*a, **kw)
            ev[1].record()
            spans.append(ev)
            return out

        walls = []
        dp_cuda.dp_last_row, dp_cuda.LAST_ROW_THREADS = timed_scorer, threads
        try:
            check_equal(f"assembly step: aec differs with the {what}", step(*args)[1], aec)
            spans.clear()
            for _ in range(5):
                t0 = time.time()
                step(*args)
                torch.cuda.synchronize()
                walls.append(time.time() - t0)
        finally:
            dp_cuda.dp_last_row, dp_cuda.LAST_ROW_THREADS = scorer, reach
        device_ms = sorted(sum(a.elapsed_time(b) for a, b in spans[4 * k : 4 * k + 4])
                           for k in range(5))
        walls.sort()
        say(f"assembly step, {what}: warm, 5 steps: {walls[2] * 1e3:.3f} ms a step (median; "
            f"least {walls[0] * 1e3:.3f}, most {walls[-1] * 1e3:.3f}; host clock, copies "
            f"included), of which its four dp_last_row launches {device_ms[2]:.4f} ms on the "
            f"card (median; CUDA events around each call of the wrapper): "
            f"{100 * device_ms[2] / (walls[2] * 1e3):.1f}% of the step")
    return counts


def phase_sharded(dev) -> None:
    import numpy as np
    import torch

    from mia_tpu_torch import testing as T
    from mia_tpu_torch.core.columns import _record_arrays, main_column_counts
    from mia_tpu_torch.core.torch_engine import Pass1Scorer, state_from_numpy
    from mia_tpu_torch.ops import consensus_torch, dp_cuda

    d = T.random_entries(E_BATCH, L_ROWS, seed=25)
    entries = [d[k] for k in T.ENTRY_KEYS[2:]]
    res, wall = [], []
    for devs in ([dev], [dev] * N_SHARDS):
        states = [state_from_numpy(d["refs"], d["sms"], x) for x in devs]
        sc = Pass1Scorer.from_state(states, d["len1"], batch=E_BATCH // 2)
        sc.collect_entries(sc.dispatch_entries(*entries))  # warm
        dp_cuda.reset_counts()
        t0 = time.time()
        res.append(sc.collect_entries(sc.dispatch_entries(*entries)))
        wall.append(time.time() - t0)
        if (dp_cuda.kernel_launches, dp_cuda.shards, dp_cuda.plain_calls) != \
                (len(devs), len(devs), 0):
            raise AssertionError(f"sharded scorer: {dp_cuda.kernel_launches} launches over "
                                 f"{dp_cuda.shards} shards")
    for name, a, b in zip(("best", "aec"), *res):
        if not np.array_equal(a, b):
            raise AssertionError(f"sharded scorer: {name} differs from the single scorer")
    say(f"sharded scorer: E={E_BATCH} over {N_SHARDS} shards on {dev} == single scorer "
        f"(best, aec in the caller's order); dispatch to collect {wall[1] * 1e3:.3f} ms "
        f"against {wall[0] * 1e3:.3f} ms single (host clock, copies included)")

    maln = T.random_records(N_COLS, N_RECORDS, seed=15)
    _, spans, starts, revs, seq, smp, seq_off, smp_off = _record_arrays(maln, True)
    hook = (seq, smp, starts, spans, seq_off, smp_off, revs, maln.fpsm, maln.rpsm, N_COLS)
    one = consensus_torch.device_column_counts(*hook, device=dev)
    consensus_torch.reset_counts()
    four = consensus_torch.device_column_counts(*hook, devices=[dev] * N_SHARDS)
    if (consensus_torch.kernel_launches, consensus_torch.plain_calls) != (N_SHARDS, 0):
        raise AssertionError(f"sharded consensus: {consensus_torch.kernel_launches} launches")
    host = main_column_counts(maln, exclude_dropped=True)
    for name, f, o, h in zip(("counts", "cov", "scores"), four, one,
                             (host.counts, host.cov, host.scores)):
        if not (np.array_equal(f, o) and np.array_equal(f, h)):
            raise AssertionError(f"sharded consensus: {name} differs")
    sizes = [int(spans[lo:hi].sum()) for lo, hi in
             consensus_torch._split_records(spans, N_SHARDS)]
    say(f"sharded consensus: device_column_counts over {N_SHARDS} shards == one shard == "
        f"host main_column_counts on {int(spans.sum())} observations (shards of {sizes})")


def phase_sharded_e2e(args: list[str], dev, single_counts: dict) -> None:
    """The 20k-read assembly with a list of four devices against phase 7's
    single-device run."""
    from mia_tpu_torch.core import assembler, torch_engine
    from mia_tpu_torch.ops import consensus_torch, dp_cuda

    root = os.path.join(WORK, "e2e_sharded", "out.maln")
    os.makedirs(os.path.dirname(root))
    assembler.make_dp_devices = lambda n: torch_engine.make_dp_devices(
        n, devices=[dev] * n if n > 0 else None)
    try:
        reset_counts()
        t0 = time.time()
        prof = run_port([*args, "--dp-devices", str(N_SHARDS)], root, profile=True)
        wall = time.time() - t0
    finally:
        assembler.make_dp_devices = torch_engine.make_dp_devices
    counts = {"dp.shards": dp_cuda.shards, "dp.kernel_launches": dp_cuda.kernel_launches,
              "dp.plain_calls": dp_cuda.plain_calls,
              "cons.kernel_launches": consensus_torch.kernel_launches,
              "cons.plain_calls": consensus_torch.plain_calls}
    want = maln_bytes(os.path.join(WORK, "e2e", "torch_inproc", "out.maln"))
    if not want or maln_bytes(root) != want:
        raise AssertionError("20k assembly over 4 shards differs from the single-device run")
    if not (counts["dp.shards"] == N_SHARDS
            and counts["dp.kernel_launches"] == N_SHARDS * single_counts["dp.kernel_launches"]
            and counts["cons.kernel_launches"]
            == N_SHARDS * single_counts["cons.kernel_launches"]
            and counts["dp.plain_calls"] == counts["cons.plain_calls"] == 0
            and prof["counters"].get("consensus.device_fallbacks", 0) == 0):
        raise AssertionError(f"sharded device path not taken: {counts} against the single "
                             f"run's {single_counts}")
    say(f"e2e sharded: 20k reads over {N_SHARDS} shards on {dev}, {len(want)} maln files "
        f"byte-identical to the single-device run; {json.dumps(counts)}; wall "
        f"{wall:.3f} s in this process")


MULTIHOST_CHECKS = ("pass1.device_scored_reads", "reiterate.device_entries",
                    "dp.kernel_launches", "dp.plain_calls", "cons.kernel_launches",
                    "cons.plain_calls", "consensus.device_fallbacks", "dist.collectives")


def run_ranks(tag: str, args: list[str], n: int = 2, timeout: float = 600) -> list[dict]:
    """``n`` processes of the port's mia CLI under ``--engine torch
    --profile``, one gloo group over localhost (the ``MIA_TORCH_*``
    variables), every rank on cuda:0 of this one card, rank i writing into
    WORK/tag/rank<i>.  All start at once; any rank that fails stops them
    all.  Returns per rank its directory, process wall seconds and profile."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    ranks, procs = [], []
    t0 = time.time()
    for i in range(n):
        d = os.path.join(WORK, tag, f"rank{i}")
        os.makedirs(d)
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   MIA_TORCH_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   MIA_TORCH_NUM_PROCESSES=str(n), MIA_TORCH_PROCESS_ID=str(i))
        log = open(os.path.join(WORK, tag, f"rank{i}.log"), "w")
        ranks.append({"dir": d, "log": log.name})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mia_tpu_torch.cli.mia", *args, "-m", "out.maln",
             "--engine", "torch", "--profile"], cwd=d, env=env, stdout=log,
            stderr=subprocess.STDOUT))
        log.close()
    try:
        while any(p.returncode is None for p in procs):
            for r, p in zip(ranks, procs):
                if p.returncode is None and p.poll() is not None:
                    r["wall_s"] = time.time() - t0
                    if p.returncode != 0:
                        with open(r["log"]) as f:
                            raise RuntimeError(f"{tag}: a rank exited {p.returncode}:\n"
                                               f"{f.read()[-3000:]}")
            if time.time() - t0 > timeout:
                raise RuntimeError(f"{tag}: the ranks did not finish in {timeout} s")
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in ranks:
        with open(r["log"]) as f:
            line = [ln for ln in f if ln.startswith("MIA_PROFILE ")][-1]
        r["profile"] = json.loads(line.split(" ", 1)[1])
    return ranks


def check_ranks(tag: str, ranks: list[dict], want: dict[str, bytes],
                files: list[tuple[str, bytes]]) -> None:
    """Rank 0 wrote ``want`` (maln files without their timestamp line, and
    ``files`` byte for byte), rank 1 nothing; every rank went through the
    kernels and none through a plain version."""
    got = maln_bytes(os.path.join(ranks[0]["dir"], "out.maln"))
    if not want or got != want:
        diff = [k for k in sorted(set(got) | set(want)) if got.get(k) != want.get(k)]
        raise AssertionError(f"{tag}: rank 0's malns differ from one process's: {diff}")
    for fn, data in files:
        with open(os.path.join(ranks[0]["dir"], fn), "rb") as f:
            if f.read() != data:
                raise AssertionError(f"{tag}: rank 0's {fn} differs from one process's")
    for r in ranks[1:]:
        if os.listdir(r["dir"]):
            raise AssertionError(f"{tag}: a rank other than 0 wrote {os.listdir(r['dir'])}")
    for i, r in enumerate(ranks):
        c = r["profile"]["counters"]
        checks = {k: c.get(k, 0) for k in MULTIHOST_CHECKS}
        if not (checks["pass1.device_scored_reads"] > 0 and checks["dp.kernel_launches"] > 0
                and checks["cons.kernel_launches"] > 0 and checks["dist.collectives"] > 0
                and checks["reiterate.device_entries"] > 0
                and checks["dp.plain_calls"] == checks["cons.plain_calls"] == 0
                and checks["consensus.device_fallbacks"] == 0):
            raise AssertionError(f"{tag}: rank {i} did not take the device path: {checks}")
        r["checks"] = checks


def say_ranks(tag: str, ranks: list[dict], single: str, smi: str) -> None:
    for i, r in enumerate(ranks):
        p = r["profile"]
        say(f"{tag}: rank {i} on cuda:0, wall {r['wall_s']:.3f} s as a new process "
            f"(run {p['total_s']:.3f} s), dist.collectives {p['counters']['dist.collectives']}"
            f", dist.collective_s {p['phases_s'].get('dist.collective_s', 0.0):.3f}; "
            f"{json.dumps(r['checks'])}; {smi}")
        say(f"{tag}: rank {i} phases s " + json.dumps(p["phases_s"], sort_keys=True))
    say(f"{tag}: one process: {single}; {smi}")


def phase_multihost(args: list[str], walls: dict, smi: str) -> None:
    """Two processes of the port on this one card as a multi-host run of
    phase 7's 20k-read workload, started together on a cold kernel-library
    build: rank 0's malns equal phase 7's single-process run, rank 1 writes
    nothing, both ranks launch the kernels and call no plain version.  Then
    the same with ``-C2 -q``, against one process of the port (maln and
    fastq byte for byte)."""
    from mia_tpu_torch.utils import torchcfg

    # both ranks start with no library: one builds it under the lock, the
    # other waits and loads the same file (this process keeps its own open)
    lib_dir = os.path.dirname(torchcfg.library_path())
    shutil.rmtree(lib_dir)
    ranks = run_ranks("multihost", args)
    left = sorted(os.listdir(lib_dir))
    if (not os.path.exists(torchcfg.library_path()) or "build.log" not in left
            or any(fn.endswith(".tmp") for fn in left)):
        raise AssertionError(f"multi-host: the cold build left {left}")
    want = maln_bytes(os.path.join(WORK, "e2e", "torch_inproc", "out.maln"))
    check_ranks("multi-host", ranks, want, [])
    say(f"multi-host: 2 ranks, 20k reads, {len(want)} maln files of rank 0 byte-identical "
        f"to phase 7's one process; rank 1 wrote none; the kernel library built once "
        f"from cold for both ({', '.join(left)})")
    say_ranks("multi-host", ranks, f"wall {walls['torch']:.3f} s as a new process, "
              f"{walls['torch_inproc']:.3f} s warm in this process (phase 7)", smi)

    fq = ["-C2", "-q", "out.fastq"]
    ranks = run_ranks("multihost_cq", [*args, *fq])
    d = os.path.join(WORK, "multihost_cq", "single")
    os.makedirs(d)
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "mia_tpu_torch.cli.mia", *args, *fq, "-m",
                        "out.maln", "--engine", "torch", "--profile"], cwd=d, check=True,
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=REPO + os.pathsep
                                + os.environ.get("PYTHONPATH", "")))
    t_single = time.time() - t0
    prof = json.loads([ln for ln in r.stderr.splitlines()
                       if ln.startswith("MIA_PROFILE ")][-1].split(" ", 1)[1])
    with open(os.path.join(d, "out.fastq"), "rb") as f:
        fastq = f.read()
    want = maln_bytes(os.path.join(d, "out.maln"))
    check_ranks("multi-host -C2 -q", ranks, want, [("out.fastq", fastq)])
    say(f"multi-host -C2 -q: 2 ranks, {len(want)} maln files and the fastq "
        f"({len(fastq)} bytes) of rank 0 byte-identical to one process of the port")
    say_ranks("multi-host -C2 -q", ranks, f"wall {t_single:.3f} s as a new process (run "
              f"{prof['total_s']:.3f} s), phases s {json.dumps(prof['phases_s'], sort_keys=True)}",
              smi)


# a client of the port's mia whose import system refuses torch, jax and the
# JAX package: what a short run through the resident server loads
NO_TORCH_CLIENT = r"""
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "jaxlib", "mia_tpu"):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
from mia_tpu_torch.cli.mia import main
rc = main(sys.argv[1:])
bad = [m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "jaxlib", "mia_tpu")]
assert not bad, bad
sys.exit(rc)
"""
SERVER_CHECKS = ("pass1.using_server", "pass1.device_scored_reads", "reiterate.device_entries",
                 "consensus.device_calls", "consensus.device_fallbacks",
                 "pass1.native_solved_wide_reads")


def server_hello(sock: str) -> dict:
    from mia_tpu_torch import serve

    client = serve._Client(sock)
    try:
        return client.hello()
    finally:
        client.close()


def start_client(tag: str, args: list[str], sock: str, engine: str = "torch"):
    """A new process of the port's mia with torch refused, writing into
    WORK/server/tag; returns (process, its directory, its log, start time)."""
    d = os.path.join(WORK, "server", tag)
    os.makedirs(d)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               MIA_TORCH_SERVER=sock)
    log = os.path.join(d, "log")
    with open(log, "w") as lf:
        proc = subprocess.Popen([sys.executable, "-c", NO_TORCH_CLIENT, *args, "-m", "out.maln",
                                 "--engine", engine, "--profile"], cwd=d, env=env, stdout=lf,
                                stderr=subprocess.STDOUT)
    return proc, d, log, time.time()


def finish_client(tag: str, run, want: dict[str, bytes]) -> tuple[float, dict]:
    """Waits for a client of start_client; checks its malns against
    ``want``; returns its wall seconds and profile (phases and counters)."""
    proc, d, log, t0 = run
    try:
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.time() - t0
    with open(log) as f:
        text = f.read()
    if rc != 0:
        raise RuntimeError(f"server {tag}: the client exited {rc}:\n{text[-3000:]}")
    got = maln_bytes(os.path.join(d, "out.maln"))
    if not want or got != want:
        diff = [k for k in sorted(set(got) | set(want)) if got.get(k) != want.get(k)]
        raise AssertionError(f"server {tag}: malns differ: {diff}")
    prof = json.loads([ln for ln in text.splitlines()
                       if ln.startswith("MIA_PROFILE ")][-1].split(" ", 1)[1])
    return wall, prof


def check_served(tag: str, counters: dict, before: dict, after: dict, scorer: str,
                 runs: int = 1) -> dict:
    """The client went through the server, and the server's counts rose by
    at least one scorer (``scorer``) and one consensus launch a run, with
    no plain call; returns the rise."""
    from mia_tpu_torch import serve

    rise = {k: after["counters"][k] - before["counters"][k] for k in serve.COUNTERS}
    checks = {k: counters.get(k, 0) for k in SERVER_CHECKS}
    if not (checks["pass1.using_server"] == 1 and checks["pass1.device_scored_reads"] > 0
            and checks["reiterate.device_entries"] > 0 and checks["consensus.device_calls"] > 0
            and checks["consensus.device_fallbacks"] == 0
            and rise[scorer] >= runs and rise["cons.kernel_launches"] >= runs
            and rise["dp.plain_calls"] == rise["dp.hp_plain_calls"] == 0
            and rise["dp.last_row_plain_calls"] == rise["dp.last_row_hp_plain_calls"] == 0
            and rise["dp.last_row_band_plain_calls"] == 0
            and rise["dp.last_row_strand_plain_calls"] == 0
            and rise["dp.last_row_hp_band_plain_calls"] == 0
            and rise["dp.last_row_hp_strand_plain_calls"] == 0
            and checks["pass1.native_solved_wide_reads"] == 0
            and rise["cons.plain_calls"] == 0):
        raise AssertionError(f"server {tag}: not served by the card: {checks}, server {rise}")
    return rise


def phase_server(args: list[str], walls: dict, smi: str) -> dict:
    """Phase 16b: the resident server and torch-free clients on phase 7's
    and phase 8's workloads.  Returns the server's launches by kernel."""
    sock = os.path.join(WORK, "srv.sock")
    os.makedirs(os.path.join(WORK, "server"))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    with open(os.path.join(WORK, "server", "serve.log"), "w") as lf:
        proc = subprocess.Popen([sys.executable, "-m", "mia_tpu_torch.cli.serve", "--sock", sock],
                                env=env, stdout=lf, stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                with open(os.path.join(WORK, "server", "serve.log")) as f:
                    raise RuntimeError(f"server: exited {proc.returncode}:\n{f.read()[-3000:]}")
            try:
                h = server_hello(sock)
                break
            except OSError:
                if time.time() - t0 > 300:
                    raise RuntimeError("server: no hello within 300 s")
                time.sleep(0.02)
        t_start = time.time() - t0
        from mia_tpu_torch import serve

        if h["platform"] != "cuda" or h["build"] != serve.build_id() or not h["library"]:
            raise AssertionError(f"server: not on the card, or not of these sources: {h}")
        say(f"server: ready on {sock} ({h['device']}, {h['name']}, build {h['build']}, kernel "
            f"library {h['library']}), {t_start:.3f} s from launch to the first hello; {smi}")
        want = maln_bytes(os.path.join(WORK, "e2e", "torch_inproc", "out.maln"))
        want_hp = maln_bytes(os.path.join(WORK, "e2e_hp", "torch_inproc", "out.maln"))
        launches = {"dp_entries": 0, "dp_entries_hp": 0, "column_counts": 0,
                    "dp_last_row": 0, "dp_last_row_band": 0, "dp_strand": 0,
                    "dp_last_row_hp": 0, "dp_last_row_hp_band": 0, "dp_strand_hp": 0}

        def served(tags, run_args, want_bytes, scorer):
            before = server_hello(sock)
            runs = [start_client(t, run_args, sock) for t in tags]
            out = [finish_client(t, r, want_bytes) for t, r in zip(tags, runs)]
            after = server_hello(sock)
            rise = None
            for t, (_, prof) in zip(tags, out):
                rise = check_served(t, prof["counters"], before, after, scorer, len(tags))
            launches["dp_entries"] += rise["dp.kernel_launches"]
            launches["dp_entries_hp"] += rise["dp.hp_kernel_launches"]
            launches["column_counts"] += rise["cons.kernel_launches"]
            launches["dp_last_row"] += rise["dp.last_row_launches"]
            launches["dp_last_row_band"] += rise["dp.last_row_band_launches"]
            launches["dp_strand"] += rise["dp.last_row_strand_launches"]
            launches["dp_last_row_hp"] += rise["dp.last_row_hp_launches"]
            launches["dp_last_row_hp_band"] += rise["dp.last_row_hp_band_launches"]
            launches["dp_strand_hp"] += rise["dp.last_row_hp_strand_launches"]
            return [w for w, _ in out], out[-1][1], rise

        client_walls = []
        for i in range(3):
            (wall,), prof, rise = served([f"client{i}"], args, want, "dp.kernel_launches")
            if not rise["dp.last_row_band_launches"]:
                raise AssertionError(f"server: client {i}'s WIDE reads did not go through "
                                     f"the band form of dp_last_row_strand: {rise}")
            client_walls.append(wall)
            say(f"server: client {i}, 20k reads as a new process with torch refused: "
                f"{wall:.3f} s (run {prof['total_s']:.3f} s), malns byte-identical to phase 7; "
                f"server launches {json.dumps(rise)}")
        say("server: client counters " + json.dumps(prof["counters"], sort_keys=True))
        say("server: client phases s " + json.dumps(prof["phases_s"], sort_keys=True))
        (hp_wall,), prof, rise = served(["client_hp"], [*args, "-h"], want_hp,
                                        "dp.hp_kernel_launches")
        if not (rise["dp.last_row_hp_strand_launches"] and rise["dp.last_row_hp_band_launches"]
                and not rise["dp.last_row_hp_launches"]):
            raise AssertionError(f"server: the -h client's WIDE reads did not go through "
                                 f"the band and strand forms of dp_last_row_hp alone: {rise}")
        say(f"server: -h client {hp_wall:.3f} s (run {prof['total_s']:.3f} s), malns "
            f"byte-identical to phase 8; server launches {json.dumps(rise)}")
        say("server: -h client phases s " + json.dumps(prof["phases_s"], sort_keys=True))
        t0 = time.time()
        pair, _, rise = served(["pair0", "pair1"], args, want, "dp.kernel_launches")
        t_pair = time.time() - t0
        say(f"server: two clients at once, {pair[0]:.3f} / {pair[1]:.3f} s ({t_pair:.3f} s for "
            f"both), both byte-identical to phase 7; server launches {json.dumps(rise)}")
        native = start_client("native", args, sock, engine="native")
        t_native, prof = finish_client("native", native, want)
        if prof["counters"].get("pass1.using_server") or prof["counters"].get("dp.kernel_launches"):
            raise AssertionError(f"server: --engine native went to a device: {prof['counters']}")
        median = sorted(client_walls)[1]
        say(f"server: walls s as new processes: server start {t_start:.3f}; clients "
            f"{', '.join(f'{w:.3f}' for w in client_walls)} (median {median:.3f}); -h "
            f"{hp_wall:.3f}; two at once {pair[0]:.3f} / {pair[1]:.3f}; native with torch "
            f"refused {t_native:.3f}; against phase 7's new processes torch {walls['torch']:.3f}, "
            f"native {walls['native']:.3f}; {smi}")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    if proc.returncode != 0 or os.path.exists(sock):
        raise AssertionError(f"server: exit {proc.returncode}, socket left: {os.path.exists(sock)}")
    say(f"server: stopped by SIGTERM, socket removed; launches {json.dumps(launches)}")
    return launches


def phase_dryrun() -> None:
    from mia_tpu_torch.entry import dryrun_multichip

    t0 = time.time()
    dryrun_multichip(N_SHARDS)
    say(f"dry run: dryrun_multichip({N_SHARDS}) passed ({time.time() - t0:.3f} s)")


def main() -> int:
    t_start = t0 = time.time()
    import torch

    t_import = time.time() - t0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    say(f"device: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"python {sys.version.split()[0]}")
    if not os.path.isdir(os.path.join(REPO, "mia_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    # every phase scores in its own processes; phase 16b names its server
    os.environ["MIA_TORCH_SERVER"] = "0"
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    dev = torch.device("cuda", 0)
    t0 = time.time()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    say(f"set-up: import torch {t_import:.3f} s, CUDA context {time.time() - t0:.3f} s")
    phase_build()
    if sys.argv[1:2] == ["--myers-ab"] and len(sys.argv) == 3:
        phase_myers_ab(dev, sys.argv[2])
        say(nvidia_smi())
        say(f"total: {time.time() - t_start:.1f} s (myers a/b only)")
        return 0
    if sys.argv[1:2] == ["--census"]:
        phase_census(sys.argv[2:])
        say(nvidia_smi())
        say(f"total: {time.time() - t_start:.1f} s (census only)")
        return 0
    if sys.argv[1:2] == ["--band-ab"] and len(sys.argv) in (3, 4):
        phase_band_ab(sys.argv[2], int(sys.argv[3]) if len(sys.argv) == 4 else 3)
        say(nvidia_smi())
        say(f"total: {time.time() - t_start:.1f} s (band a/b only)")
        return 0
    if sys.argv[1:2] == ["--ccheck-ab"] and len(sys.argv) in (3, 4):
        phase_ccheck_ab(sys.argv[2], int(sys.argv[3]) if len(sys.argv) == 4 else 10)
        say(nvidia_smi())
        say(f"total: {time.time() - t_start:.1f} s (ccheck a/b only)")
        return 0
    if sys.argv[1:2] == ["--hp-ab"] and len(sys.argv) in (3, 4):
        phase_hp_ab(sys.argv[2], int(sys.argv[3]) if len(sys.argv) == 4 else 10)
        say(nvidia_smi())
        say(f"total: {time.time() - t_start:.1f} s (hp a/b only)")
        return 0
    if sys.argv[1:2] == ["--merge-ab"] and len(sys.argv) in (3, 4):
        phase_merge_ab(sys.argv[2], int(sys.argv[3]) if len(sys.argv) == 4 else 10)
        say(nvidia_smi())
        say(f"total: {time.time() - t_start:.1f} s (merge a/b only)")
        return 0
    if sys.argv[1:2] == ["--wide-ab"] and len(sys.argv) in (3, 4):
        phase_wide_ab(sys.argv[2], int(sys.argv[3]) if len(sys.argv) == 4 else 10)
        say(nvidia_smi())
        say(f"total: {time.time() - t_start:.1f} s (wide a/b only)")
        return 0
    if sys.argv[1:2] == ["--prep-ab"] and len(sys.argv) in (3, 4):
        phase_prep_ab(sys.argv[2], int(sys.argv[3]) if len(sys.argv) == 4 else 10)
        say(nvidia_smi())
        say(f"total: {time.time() - t_start:.1f} s (prep a/b only)")
        return 0
    kern = phase_kernel(dev)
    hp_kern = phase_hp_kernel(dev)
    cons_kern = phase_consensus_kernel(dev)
    if sys.argv[1:] == ["--kernels"]:
        # the quick form for work on the kernels: no result line
        phase_edges(dev)
        myers_kern = phase_myers_kernel(dev)
        last_row_kern = phase_last_row_kernel(dev)
        pileup_kern, cons_call_kern = phase_step_kernels(dev)
        say(json.dumps({"dp_entries": kern, "dp_entries_hp": hp_kern,
                        "column_counts": cons_kern, "myers_waves": myers_kern,
                        "dp_last_row": last_row_kern, "pileup_counts": pileup_kern,
                        "consensus_call": cons_call_kern}))
        say(nvidia_smi())
        say(f"total: {time.time() - t_start:.1f} s (kernels only)")
        return 0
    phase_golden()
    phase_edges(dev)
    args = e2e_workload()
    captured: dict = {}
    main_counts, main_walls = run_e2e("e2e", args, hp=False, new_process=True,
                                      captured=captured)
    wide = phase_wide(dev)
    phase_prepare_threads()
    with LastRowTimer("dp_last_row_hp") as hp_timer:
        hp_counts, _ = run_e2e("e2e_hp", [*args, "-h"], hp=True, new_process=False,
                               captured=captured)
    hp_wide = wide_forms("-h wide reads", hp_timer, hp_counts, hp=True)
    # this workload's -h wide rows hold whole strands: the -h strand form
    # takes them, and the -h full form makes no launch
    if not hp_wide["strand"]["launches"] or hp_wide["full"]["launches"]:
        raise AssertionError(f"-h wide reads: the strand form did not take the whole strands "
                             f"alone: {hp_counts}")
    shapes = phase_workload_shapes(captured)
    myers_kern = phase_myers_kernel(dev)
    phase_ccheck_golden()
    cc_counts = phase_ccheck_e2e()
    last_row_kern = phase_last_row_kernel(dev)
    pileup_kern, cons_call_kern = phase_step_kernels(dev)
    step_counts = phase_step(dev)
    phase_sharded(dev)
    phase_sharded_e2e(args, dev, main_counts)
    phase_multihost(args, main_walls, smi)
    server_launches = phase_server(args, main_walls, smi)
    phase_dryrun()
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "mia_tpu")]
    if bad:
        raise AssertionError(f"jax or the JAX package was imported: {bad[:5]}")
    say(json.dumps({"kernels": [{
        "name": "dp_entries",
        "route": "cuda",
        "source": "mia_tpu_torch/csrc/dp_entries.cu",
        "replaces": "mia_tpu/ops/dp_pallas.py:46",
        "launches": main_counts["dp.kernel_launches"],
        # phase 16b: the resident server's launches for its clients
        "server_launches": server_launches["dp_entries"],
        **kern, **shapes["dp_entries"],
    }, {
        "name": "dp_entries_hp",
        "route": "cuda",
        "source": "mia_tpu_torch/csrc/dp_entries.cu",
        "replaces": "mia_tpu/ops/dp_jax.py:220",
        "launches": hp_counts["dp.hp_kernel_launches"],
        "server_launches": server_launches["dp_entries_hp"],
        **hp_kern, **shapes["dp_entries_hp"],
    }, {
        "name": "column_counts",
        "route": "cuda",
        "source": "mia_tpu_torch/csrc/column_counts.cu",
        "replaces": "mia_tpu/ops/consensus_device.py:65",
        # both e2e paths run it: their launches together
        "launches": main_counts["cons.kernel_launches"] + hp_counts["cons.kernel_launches"],
        "server_launches": server_launches["column_counts"],
        **cons_kern, **shapes["column_counts"],
    }, {
        "name": "myers_waves",
        "route": "cuda",
        "source": "mia_tpu_torch/csrc/myers_waves.cu",
        "replaces": "mia_tpu/ops/myers_jax.py:36",
        # both ccheck runs of the e2e path: one launch each
        "launches": cc_counts["myers.kernel_launches"],
        **myers_kern,
    }, {
        "name": "dp_last_row",
        "route": "cuda",
        "source": "mia_tpu_torch/csrc/dp_last_row.cu",
        "replaces": "mia_tpu/ops/dp_pallas.py:133",
        # its path is the assembly step's (phase 14: one launch per dp
        # shard); pass 1's WIDE rows no longer reach it (phase 7b: the full
        # form's launches there, 0, and its rows past 18,432 band columns,
        # none, as wide_*); the server's launches for its clients (16b);
        # ms, plain_ms and the bound at the JAX bench's full-width shape
        # (phase 12)
        "launches": step_counts["dp.last_row_launches"],
        "wide_launches": wide["full"]["launches"],
        "server_launches": server_launches["dp_last_row"],
        **{k: v for k, v in wide["full"].items()
           if k.startswith("wide_") or k.startswith("form_")},
        **last_row_kern,
    }, {
        "name": "dp_last_row_band",
        "route": "cuda",
        "source": "mia_tpu_torch/csrc/dp_band.cu",
        "replaces": "mia_tpu/ops/dp_pallas.py:46",
        # the band form of the same: pass 1's WIDE rows whose band takes at
        # most 3,072 columns on 1, 2, 4 or 8 warps a row (phase 7b;
        # multi_warp_rows the rows on more than one), its numbers at the
        # run's largest call
        "server_launches": server_launches["dp_last_row_band"],
        **wide["band"],
    }, {
        "name": "dp_strand",
        "route": "cuda",
        "source": "mia_tpu_torch/csrc/dp_strand.cu",
        "replaces": "mia_tpu/ops/dp_pallas.py:46",
        # the strand form of the same: pass 1's WIDE rows whose band takes
        # 3,073-18,432 columns, whole strands, a cluster of CTAs a row (phase
        # 7b), its numbers at the run's largest call
        "server_launches": server_launches["dp_strand"],
        **wide["strand"],
    }, {
        "name": "dp_last_row_hp",
        "route": "cuda",
        "source": "mia_tpu_torch/csrc/dp_last_row.cu",
        "replaces": "mia_tpu/ops/dp_jax.py:220",
        # the -h full form: pass 1 gives it no row (phase 8: 0 launches; the
        # strand form takes the whole strands); its numbers on the rows of
        # phase 8c's largest strand call, which it took before (timed_on);
        # the server's launches for the -h client (16b), 0
        "server_launches": server_launches["dp_last_row_hp"],
        **hp_wide["full"],
    }, {
        "name": "dp_strand_hp",
        "route": "cuda",
        "source": "mia_tpu_torch/csrc/dp_strand.cu",
        "replaces": "mia_tpu/ops/dp_jax.py:220",
        # the -h strand form: pass 1's -h WIDE rows whose band takes
        # 3,073-18,432 columns, whole strands, a cluster of CTAs a row (phase
        # 8), its numbers at the run's largest such call (phase 8c)
        "server_launches": server_launches["dp_strand_hp"],
        **hp_wide["strand"],
    }, {
        "name": "dp_last_row_hp_band",
        "route": "cuda",
        "source": "mia_tpu_torch/csrc/dp_band.cu",
        "replaces": "mia_tpu/ops/dp_jax.py:220",
        # the band form of the same: the rest of the -h WIDE rows
        "server_launches": server_launches["dp_last_row_hp_band"],
        **hp_wide["band"],
    }, {
        "name": "pileup_counts",
        "route": "cuda",
        "source": "mia_tpu_torch/csrc/pileup_counts.cu",
        "replaces": "mia_tpu/parallel/sharded.py:51",
        "launches": step_counts["step.pileup_launches"],
        **pileup_kern,
    }, {
        "name": "consensus_call",
        "route": "cuda",
        "source": "mia_tpu_torch/csrc/consensus_call.cu",
        "replaces": "mia_tpu/parallel/sharded.py:34",
        "launches": step_counts["step.consensus_launches"],
        **cons_call_kern,
    }]}))
    say(f"total: {time.time() - t_start:.1f} s")
    say(nvidia_smi())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
