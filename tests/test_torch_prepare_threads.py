"""Pass 1's banding (``BatchHost.prepare``, the port's ``mia_p1_prepare``)
threaded over reads, against the JAX package's serial one.

The same seeded reads go through ``mia_tpu.core.hostbatch.BatchHost.prepare``
(the root ``native/`` library, one thread) and the port's ``prepare`` at
several thread counts.  The reads are simulated with the port's simulator
from the sample of ``testing.ccheck_sample(1)`` and scored against its
reference, with batches built to reach every branch of the banding: reads
shorter than k, reads with N, a read whose hits saturate (one band over the
whole reference), reads with more than K intervals (HOST_ONLY), no k-mer
filter (every read WIDE), k below the k-mer index's 8 leading bases, an
empty batch, a batch smaller than the thread count and one of 8,192 reads,
the cell's batch.

Tolerance: none; all six arrays equal.  Beside it, a small ``--engine
torch`` assembly on the CPU writes the same maln files with the prepare on
1 and on 8 threads.
"""
import io
import os

import numpy as np
import pytest

from mia_tpu.core.hostbatch import BatchHost as TpuBatchHost
from mia_tpu_torch import testing
from mia_tpu_torch.core import hostbatch
from mia_tpu_torch.core.entries import L_MAX, MAX_INTERVALS, WIN_W
from mia_tpu_torch.core.hostbatch import (
    FLAG_HOST_ONLY,
    FLAG_SKIP,
    FLAG_WIDE,
    BatchHost,
)
from mia_tpu_torch.models.simulate import SimConfig, simulate_reads
from mia_tpu_torch.ops.pssm import init_flatsubmat
from mia_tpu_torch.utils import profiling
from mia_tpu_torch.utils.encoding import revcom

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
K = 12
WRAP = 256
THREADS = [1, 2, 5, 16]
CASES = ["short", "with_n", "saturate", "host_only", "no_kmer", "small_k", "empty", "few",
         "cell_batch"]


def _simulated(sample: str, n: int, seed: int) -> list[str]:
    return [seq for _, seq, _ in simulate_reads(sample, SimConfig(num_reads=n, seed=seed))]


def _pieces(ref: str, n_pieces: int = 20, size: int = K) -> str:
    """One read of ``n_pieces`` pieces of the reference from places further
    apart than a band is long: a band of more than K intervals."""
    step = len(ref) // n_pieces
    return "".join(ref[i * step : i * step + size] for i in range(n_pieces))


def _batch(case: str, ref: str, sample: str) -> tuple[list[str], int]:
    """(reads, kmer_len) of one case."""
    rng = np.random.default_rng(CASES.index(case))
    if case == "empty":
        return [], K
    if case == "few":
        return _simulated(sample, 3, 3), K
    if case == "cell_batch":
        return _simulated(sample, 8192, 8), K
    reads = _simulated(sample, 200, CASES.index(case) + 10)
    if case == "short":
        reads += ["", "A", sample[100:105], sample[200:211], revcom(sample[300:311])]
    elif case == "with_n":
        for i in range(0, len(reads), 3):
            s = list(reads[i])
            for p in rng.choice(len(s), min(len(s), 1 + i % 7), replace=False):
                s[p] = "N"
            reads[i] = "".join(s)
        reads += ["N" * 40, sample[500:530] + "N" + sample[531:560]]
    elif case == "saturate":
        # the reference's two runs of 12+ C: five positions of C^12, so
        # 49 k-mers of this read hit 245 times
        reads += ["C" * 60, "G" * 60]
    elif case == "host_only":
        reads += [_pieces(ref), revcom(_pieces(ref)), _pieces(ref, 17, 14)]
    return reads, {"no_kmer": -1, "small_k": 6}.get(case, K)


@pytest.fixture(scope="module")
def sample_parts():
    ref, sample, _ = testing.ccheck_sample(1)
    return ref, sample


_WANT: dict = {}


def _prepared(host_cls, ref: str, kmer: int, reads: list[str], **kw):
    fw = ref + ref[:WRAP]
    rc = revcom(ref) + revcom(ref)[:WRAP]
    bh = host_cls.create(fw, rc, len(fw), init_flatsubmat(), None, kmer, False, WIN_W,
                         MAX_INTERVALS)
    assert bh is not None, "native library not built"
    try:
        arena, off, lens = host_cls.pack_reads(reads)
        return bh.prepare(arena, off, lens, L_MAX, MAX_INTERVALS, **kw)
    finally:
        bh.close()


@pytest.mark.parametrize("n_threads", THREADS)
@pytest.mark.parametrize("case", CASES)
def test_prepare_threads_equal_serial(case, n_threads, sample_parts):
    ref, sample = sample_parts
    reads, kmer = _batch(case, ref, sample)
    if case not in _WANT:
        _WANT[case] = _prepared(TpuBatchHost, ref, kmer, reads)
    want = _WANT[case]
    *got, errors = _prepared(BatchHost, ref, kmer, reads, n_threads=n_threads)
    assert errors == 0
    names = ("s2c", "fw_ws", "rc_ws", "fw_ivg", "rc_ivg", "flags")
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=f"{case}: {name}")

    # the case reaches what it is for
    flags = want[-1]
    fw_ivg = want[3]
    len1 = len(ref) + WRAP
    assert len(flags) == len(reads)
    if case == "short":
        assert (flags[-5:] == FLAG_SKIP).all()
    elif case == "saturate":
        rc_ivg = want[4]
        assert (flags[-2:] == FLAG_WIDE).all()
        assert tuple(fw_ivg[-2, 0]) == (0, len1) and (fw_ivg[-2, 1:] == 0).all()
        assert tuple(rc_ivg[-1, 0]) == (0, len1) and (rc_ivg[-1, 1:] == 0).all()
    elif case == "host_only":
        assert ((flags[-3:] & FLAG_HOST_ONLY) != 0).all()
    elif case == "no_kmer":
        assert (flags == FLAG_WIDE).all()
    elif case == "cell_batch":
        assert len(flags) == 8192 and (flags == 0).sum() > len(flags) // 2


def test_prepare_counts_no_errors():
    """A prepare that fails for no read returns 0 errors, at the default
    thread count too (pass 1 records the count in
    ``pass1.prepare_host_only_errors``; the assembly test below reads it)."""
    ref, sample, _ = testing.ccheck_sample(1)
    reads = _simulated(sample, 50, 1)
    for n in (0, 4):
        *arrays, errors = _prepared(BatchHost, ref, K, reads, n_threads=n)
        assert errors == 0 and len(arrays) == 6 and len(arrays[-1]) == len(reads)


def test_thread_counts(monkeypatch):
    """The default thread count comes from the affinity set, capped, and
    from ``os.cpu_count()`` where there is none."""
    cpus = len(os.sched_getaffinity(0))
    assert hostbatch.host_cpus() == cpus
    assert hostbatch._default_threads() == min(cpus, hostbatch.MAX_SOLVE_THREADS)
    monkeypatch.setattr(hostbatch, "os", _NoAffinity(os))
    assert hostbatch.host_cpus() == (os.cpu_count() or 1)


class _NoAffinity:
    """``os`` without ``sched_getaffinity``, as on platforms that lack it."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        if name == "sched_getaffinity":
            raise AttributeError(name)
        return getattr(self._mod, name)


def test_assembly_same_with_1_and_8_prepare_threads(tmp_path, monkeypatch):
    """The fixtures' assembly (``-c -k 12``, as ``entry.dryrun_multichip``
    runs it) on the CPU writes the same maln files with the prepare on 1
    and on 8 threads (pass 1's own call forced to that count); batches of
    8 reads, so its 25 reads make 4 batches."""
    from mia_tpu_torch.config import MiaConfig
    from mia_tpu_torch.core import assembler

    monkeypatch.setenv("MIA_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MIA_TORCH_SERVER", "0")
    monkeypatch.setenv("MIA_SCORE_BATCH", "8")
    monkeypatch.setattr(profiling, "_enabled", profiling._enabled)
    prepare = BatchHost.prepare
    outputs = {}
    for n in (1, 8):
        monkeypatch.setattr(BatchHost, "prepare",
                            lambda self, *a, n_threads=0, n=n: prepare(self, *a, n_threads=n))
        d = tmp_path / str(n)
        d.mkdir()
        profiling.enable()
        assembler.run_assembly(MiaConfig(
            ref_fn=os.path.join(FIXTURES, "tr1.fna"), frag_fn=os.path.join(FIXTURES, "tf.fna"),
            maln_root=str(d / "out.maln"), circular=True, kmer_filt_len=12, engine="torch"))
        rep = profiling.report(out=io.StringIO())
        assert rep["counters"]["pass1.batches_drained"] == 4
        assert rep["counters"]["pass1.prepare_host_only_errors"] == 0
        assert "pass1.prep_wait" in rep["phases_s"]
        outputs[n] = {fn: b"\n".join((d / fn).read_bytes().split(b"\n")[1:])
                      for fn in sorted(os.listdir(d))}
    assert outputs[1] and outputs[1] == outputs[8]
