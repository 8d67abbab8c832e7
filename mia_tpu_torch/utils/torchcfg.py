"""Process-wide PyTorch set-up for the port: device selection and the
build of the hand-written CUDA kernels (the entry scorers, the general-width
last-row scorer and its band and strand forms, the consensus column counts, ccheck's
Myers wavefront, and the assembly step's pileup counts and consensus call).

Port of :mod:`mia_tpu.utils.jaxcfg`.  JAX's "compile once" was its
persistent compilation cache; here it is one shared library built by
``nvcc`` from ``mia_tpu_torch/csrc/*.cu`` at first use, keyed by a hash of
the sources and the headers they share (an edited ``.cu`` or ``.cuh``
rebuilds) and kept in ``mia_tpu_torch/_build/``
inside the checkout.  Each source compiles in its own ``nvcc`` process, all
started together, and the objects link into one library; ``ptxas``'s
register and spill report lands in ``build.log`` beside it.  The library has
a plain C interface and is loaded with ``ctypes``; nothing here includes
PyTorch's headers, so a build takes seconds.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def select_device(index: int = 0) -> torch.device:
    """The device the port scores on: ``cuda:(index mod card count)`` (a
    multi-host run passes its rank, so processes on one host share its cards
    round robin), or the CPU only when ``MIA_TORCH_DEVICE=cpu`` asks for it
    (the CPU tests do).  Without a card and without that request this raises:
    the port never drops to the CPU unasked."""
    if os.environ.get("MIA_TORCH_DEVICE", "") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "--engine torch needs a CUDA device and none is available "
            "(set MIA_TORCH_DEVICE=cpu to score with the plain PyTorch "
            "version on the CPU)"
        )
    return torch.device("cuda", index % torch.cuda.device_count())


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME)")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")) +
                  glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    """Where the kernel library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], "libmia_kernels.so")


_LIB: ctypes.CDLL | None = None


def expected_constants() -> list[int]:
    """The values ``mia_dp_entries_constants`` must report, in its order:
    window width, intervals per entry, read rows, PSSM depth slots, PSSM
    depth, GOP, GEP, HIM, LOW, the ``-h`` row reach (HPW) and the length of
    the ``-h`` discount table."""
    from ..constants import GEP, GOP, HIM, PSSM_DEPTH
    from ..core.entries import HPW_ROUTE, L_MAX, MAX_INTERVALS, WIN_W, hp_pengop_table

    from ..ops.dp_torch import _LOW

    return [WIN_W, MAX_INTERVALS, L_MAX, 2 * PSSM_DEPTH + 1, PSSM_DEPTH, GOP,
            GEP, HIM, _LOW, HPW_ROUTE, len(hp_pengop_table())]


def expected_myers_constants() -> list[int]:
    """The values ``mia_myers_constants`` must report: the sentinel of
    out-of-range diagonals (``myers_torch._NEG``) and the zero bytes a
    bitmap carries past its length (``myers_cuda.SLACK``)."""
    from ..ops.myers_cuda import SLACK
    from ..ops.myers_torch import _NEG

    return [_NEG, SLACK]


def expected_last_row_constants() -> list[int]:
    """The values ``mia_dp_last_row_constants`` must report: GOP, GEP, HIM,
    LOW, PSSM depth slots, the shared-memory limit the wrapper plans the
    wide form with, the register form's columns per thread and threads per
    block (``dp_cuda.LAST_ROW_*``), the most read rows, and the ``-h``
    form's intervals a row, read-run reach (HPW), discount slots and widest
    row (``entries.HP_WIDE_COLS``)."""
    from ..constants import GEP, GOP, HIM, PSSM_DEPTH
    from ..core.entries import HP_WIDE_COLS, HPW_ROUTE, L_MAX, MAX_INTERVALS, hp_pengop_table
    from ..ops.dp_cuda import LAST_ROW_COLS, LAST_ROW_SMEM, LAST_ROW_THREADS
    from ..ops.dp_torch import _LOW

    return [GOP, GEP, HIM, _LOW, 2 * PSSM_DEPTH + 1, LAST_ROW_SMEM, LAST_ROW_COLS,
            LAST_ROW_THREADS, L_MAX, MAX_INTERVALS, HPW_ROUTE, len(hp_pengop_table()),
            HP_WIDE_COLS]


def expected_band_hp_constants() -> list[int]:
    """The values ``mia_dp_band_hp_constants`` must report: the ``-h`` band
    form's band columns a warp (``entries.BAND_COLS``), intervals a row,
    read rows, PSSM depth slots, GOP, GEP, HIM, LOW, the read-run reach
    (HPW), the discount slots and band columns a row at most
    (``entries.BAND_ROW_COLS``)."""
    from ..constants import GEP, GOP, HIM, PSSM_DEPTH
    from ..core.entries import (
        BAND_COLS,
        BAND_ROW_COLS,
        HPW_ROUTE,
        L_MAX,
        MAX_INTERVALS,
        hp_pengop_table,
    )
    from ..ops.dp_torch import _LOW

    return [BAND_COLS, MAX_INTERVALS, L_MAX, 2 * PSSM_DEPTH + 1, GOP, GEP, HIM, _LOW,
            HPW_ROUTE, len(hp_pengop_table()), BAND_ROW_COLS]


def expected_band_constants() -> list[int]:
    """The values ``mia_dp_band_constants`` must report: the plain band
    form's band columns a warp (``entries.BAND_COLS``), intervals a row,
    read rows, PSSM depth slots, PSSM depth, GOP, GEP, HIM, LOW and band
    columns a row at most (``entries.BAND_ROW_COLS``)."""
    from ..constants import GEP, GOP, HIM, PSSM_DEPTH
    from ..core.entries import BAND_COLS, BAND_ROW_COLS, L_MAX, MAX_INTERVALS
    from ..ops.dp_torch import _LOW

    return [BAND_COLS, MAX_INTERVALS, L_MAX, 2 * PSSM_DEPTH + 1, PSSM_DEPTH, GOP, GEP, HIM,
            _LOW, BAND_ROW_COLS]


def expected_strand_constants() -> list[int]:
    """The values ``mia_dp_strand_constants`` must report: the strand
    form's band columns a row (``entries.STRAND_COLS``), band columns a
    thread, CTAs a row and threads a CTA (``dp_cuda.STRAND_*``), intervals
    a row, read rows, PSSM depth slots, PSSM depth, GOP, GEP, HIM and
    LOW."""
    from ..constants import GEP, GOP, HIM, PSSM_DEPTH
    from ..core.entries import L_MAX, MAX_INTERVALS, STRAND_COLS
    from ..ops.dp_cuda import STRAND_COLS_PER_THREAD, STRAND_CTAS, STRAND_THREADS
    from ..ops.dp_torch import _LOW

    return [STRAND_COLS, STRAND_COLS_PER_THREAD, STRAND_CTAS, STRAND_THREADS, MAX_INTERVALS,
            L_MAX, 2 * PSSM_DEPTH + 1, PSSM_DEPTH, GOP, GEP, HIM, _LOW]


def expected_strand_hp_constants() -> list[int]:
    """The values ``mia_dp_strand_hp_constants`` must report: the strand
    form's (:func:`expected_strand_constants`), then the ``-h`` read-run
    reach (HPW) and discount slots."""
    from ..core.entries import HPW_ROUTE, hp_pengop_table

    return [*expected_strand_constants(), HPW_ROUTE, len(hp_pengop_table())]


def expected_pileup_constants() -> list[int]:
    """The values ``mia_pileup_counts_constants`` must report: PSSM depth
    slots, the reads a block lists per round and its widest tile
    (``parallel.sharded.PILEUP_ROUND``, ``PILEUP_TILE``)."""
    from ..constants import PSSM_DEPTH
    from ..parallel.sharded import PILEUP_ROUND, PILEUP_TILE

    return [2 * PSSM_DEPTH + 1, PILEUP_ROUND, PILEUP_TILE]


def expected_consensus_call_constants() -> list[int]:
    """The values ``mia_consensus_call_constants`` must report: PERC4GAP,
    MIN_SCORE_CONS and the most parts a call sums
    (``parallel.sharded.CONSENSUS_MAX_PARTS``)."""
    from ..constants import MIN_SCORE_CONS, PERC4GAP
    from ..parallel.sharded import CONSENSUS_MAX_PARTS

    return [PERC4GAP, MIN_SCORE_CONS, CONSENSUS_MAX_PARTS]


def check_constants(lib) -> None:
    """Raise unless the kernel library was built with the constants the
    Python side uses (a kernel built for other bounds or penalties would
    read too few intervals, overrun its row buffer or score differently; a
    Myers kernel with another sentinel would write another history)."""
    for entry, expected in (
        ("mia_dp_entries_constants", expected_constants),
        ("mia_myers_constants", expected_myers_constants),
        ("mia_dp_last_row_constants", expected_last_row_constants),
        ("mia_dp_band_hp_constants", expected_band_hp_constants),
        ("mia_dp_band_constants", expected_band_constants),
        ("mia_dp_strand_constants", expected_strand_constants),
        ("mia_dp_strand_hp_constants", expected_strand_hp_constants),
        ("mia_pileup_counts_constants", expected_pileup_constants),
        ("mia_consensus_call_constants", expected_consensus_call_constants),
    ):
        want = expected()
        buf = (ctypes.c_int32 * len(want))()
        n = getattr(lib, entry)(buf, len(want))
        got = list(buf)
        if n != len(want) or got != want:
            raise RuntimeError(
                f"kernel library constants {got} (count {n}, {entry}) differ "
                f"from the Python side's {want}: rebuild from matching sources"
            )


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once; their stderr, in order.  Raises on the
    first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for cmd, p, err in zip(cmds, procs, errs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")
    return errs


def build_sources(sources: dict[str, str], out_dir: str) -> dict[str, str]:
    """Build each named source text into a shared library of its own under
    ``out_dir`` with the library's flags, one ``nvcc`` each, all at once;
    returns name -> library path.  For timing another form of a kernel
    beside the library's (``chip_smoke.py --myers-ab``)."""
    os.makedirs(out_dir, exist_ok=True)
    cmds, libs = [], {}
    for name, text in sources.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        libs[name] = os.path.join(out_dir, f"lib{name}.so")
        cmds.append([_nvcc(), *NVCC_FLAGS, "-shared", "-o", libs[name], src])
    _run_all(cmds)
    return libs


def build_kernels() -> str:
    """Build the kernel library for the current sources unless it exists;
    returns its path.  A file lock serialises concurrent builds; the
    library is written under a temporary name and renamed into place."""
    path = library_path()
    if os.path.exists(path):
        return path
    import fcntl

    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, ".lock"), "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        nvcc = _nvcc()
        srcs = [s for s in _sources() if s.endswith(".cu")]
        objs = [os.path.join(out_dir, os.path.basename(s) + ".o") for s in srcs]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                        for s, o in zip(srcs, objs)])
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write("".join(log))
        tmp = path + ".tmp"
        _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, path)
    return path


def ptxas_report(path: str) -> list[str]:
    """ptxas's per-kernel lines (registers, spills, shared memory) from the
    build of the library at ``path``."""
    keys = ("Compiling entry function", "registers", "spill")
    with open(os.path.join(os.path.dirname(path), "build.log")) as f:
        return [ln.strip() for ln in f if any(k in ln for k in keys)]


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with every C entry
    point's argument and result types declared and its compile-time
    constants checked against the Python side's once."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_kernels())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mia_dp_entries.restype = ci
        lib.mia_dp_entries.argtypes = [
            vp, ci, vp, vp, vp, vp, vp, ci, vp, vp, vp, ci, vp,
        ]
        lib.mia_dp_entries_hp.restype = ci
        lib.mia_dp_entries_hp.argtypes = [
            vp, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp, ci, vp, vp, vp, ci, vp,
        ]
        lib.mia_column_counts.restype = ci
        lib.mia_column_counts.argtypes = [
            vp, ctypes.c_int64, vp, ctypes.c_int64, vp, vp, vp, vp, vp, ci, vp, vp,
            vp, vp, ci, vp, vp, vp, vp,
        ]
        lib.mia_dp_entries_constants.restype = ci
        lib.mia_dp_entries_constants.argtypes = [vp, ci]
        lib.mia_myers_waves.restype = ci
        lib.mia_myers_waves.argtypes = [vp, ci, vp, ci, ci, ci, ci, vp, vp, vp]
        lib.mia_myers_constants.restype = ci
        lib.mia_myers_constants.argtypes = [vp, ci]
        lib.mia_dp_last_row.restype = ci
        lib.mia_dp_last_row.argtypes = [
            vp, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp, vp,
        ]
        lib.mia_dp_last_row_wide.restype = ci
        lib.mia_dp_last_row_wide.argtypes = [
            vp, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp,
        ]
        lib.mia_dp_last_row_hp.restype = ci
        lib.mia_dp_last_row_hp.argtypes = [
            vp, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp,
        ]
        lib.mia_dp_band_hp.restype = ci
        lib.mia_dp_band_hp.argtypes = [
            vp, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, ci, vp,
        ]
        lib.mia_dp_band_hp_constants.restype = ci
        lib.mia_dp_band_hp_constants.argtypes = [vp, ci]
        lib.mia_dp_band.restype = ci
        lib.mia_dp_band.argtypes = [
            vp, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, ci, vp,
        ]
        lib.mia_dp_band_constants.restype = ci
        lib.mia_dp_band_constants.argtypes = [vp, ci]
        lib.mia_dp_strand.restype = ci
        lib.mia_dp_strand.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, ci, ci, vp, ci, vp]
        lib.mia_dp_strand_constants.restype = ci
        lib.mia_dp_strand_constants.argtypes = [vp, ci]
        lib.mia_dp_strand_hp.restype = ci
        lib.mia_dp_strand_hp.argtypes = [
            vp, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, vp, ci, vp,
        ]
        lib.mia_dp_strand_hp_constants.restype = ci
        lib.mia_dp_strand_hp_constants.argtypes = [vp, ci]
        lib.mia_dp_last_row_constants.restype = ci
        lib.mia_dp_last_row_constants.argtypes = [vp, ci]
        lib.mia_pileup_counts.restype = ci
        lib.mia_pileup_counts.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp]
        lib.mia_pileup_counts_constants.restype = ci
        lib.mia_pileup_counts_constants.argtypes = [vp, ci]
        lib.mia_consensus_call.restype = ci
        lib.mia_consensus_call.argtypes = [vp, vp, ci, ci, vp, vp]
        lib.mia_consensus_call_constants.restype = ci
        lib.mia_consensus_call_constants.argtypes = [vp, ci]
        check_constants(lib)
        _LIB = lib
    return _LIB
