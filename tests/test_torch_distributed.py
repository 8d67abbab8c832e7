"""Multi-host runs of the PyTorch port on torch.distributed (gloo), on the
CPU: the port's counterpart of tests/test_distributed.py.

Real processes form a gloo group over TCP on localhost from the
``MIA_TORCH_*`` variables.  A group of two (and one of three, where the
order of a float sum over ranks can matter) holds the collective helpers to
numpy and the summed consensus to ``mia_tpu``'s single-process
``find_consensus_cols``; two-process assemblies under ``--engine torch``
(``MIA_TORCH_DEVICE=cpu``: every rank's scorer and consensus counts run
their plain versions, which the counters prove) write the committed goldens
from rank 0 and nothing from rank 1, and under ``--engine native`` with
``-C2 -q`` they write ``mia_tpu``'s single-process bytes, fastq included.
"""
import contextlib
import io
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

from mia_tpu.cli import mia as tpu_mia
from mia_tpu.ops.consensus import ColumnCounts, find_consensus_cols
from mia_tpu.ops.pssm import init_flatsubmat, revcom_submat
from mia_tpu_torch.io.native import count_frag_seqs

from .conftest import GOLDEN
from .test_torch_golden import NO_JAX_MAIN, _norm, fixture_args, profile_counters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_COLS, N_OBS = 64, 4000

HELPERS = r"""
import pickle, sys
import numpy as np
from mia_tpu_torch.ops.consensus import ColumnCounts, find_consensus_cols
from mia_tpu_torch.ops.pssm import init_flatsubmat, revcom_submat
from mia_tpu_torch.parallel import distributed as dist

assert dist.initialize_if_needed()
n, r = dist.process_count(), dist.process_index()
out = {"n": n, "rank": r}

# the consensus reduction: each rank counts its shard of one observation set
N_COLS, N_OBS = %d, %d
rng = np.random.default_rng(11)
cols = rng.integers(0, N_COLS, N_OBS)
chars = np.frombuffer(b"ACGT-", np.uint8)[rng.integers(0, 5, N_OBS)]
depths = rng.integers(0, 31, N_OBS)
strands = rng.random(N_OBS) < 0.5
fpsm = init_flatsubmat().astype(np.int64)
rpsm = revcom_submat(fpsm).astype(np.int64)
shard = dist.host_read_shard(N_OBS)
sl = slice(shard.start, shard.start + shard.count)
cc = ColumnCounts(N_COLS)
cc.add_bases(cols[sl], chars[sl], depths[sl], strands[sl], fpsm, rpsm)
dist.allreduce_column_counts(cc)
out["cons"] = find_consensus_cols(cc, 1)[0]
out["counts"], out["cov"], out["scores"] = cc.counts, cc.cov, cc.scores

# float terms whose sum depends on the order: rank 0 holds 1e16, rank 1 1.0,
# rank 2 -1e16 (in rank order 1e16 + 1 rounds to 1e16, so the sum is 0.0)
terms = np.random.default_rng(100 + r).normal(size=7) * 10.0 ** np.arange(7)
terms[0] = (1e16, 1.0, -1e16)[r] if n == 3 else terms[0]
out["terms"] = terms
out["terms_sum"] = dist.allreduce_terms(terms)
out["ints_sum"] = dist.allreduce_terms(np.array([r, 2**40 + r], np.int64))

gaps = np.random.default_rng(200 + r).integers(0, 50, 33).astype(np.int64)
out["gaps"] = gaps.copy()
out["gaps_max"] = dist.allreduce_max(gaps)

blob = b"" if r == 1 else bytes(range(r, r + 5 * (r + 1)))
out["blob"] = blob
out["blobs"] = dist.gather_bytes(blob)
out["empty_blobs"] = dist.gather_bytes(b"")
rows = np.arange(3 * r, dtype=np.int64).reshape(r, 3)
out["rows"] = rows
out["rows_all"] = dist.gather_arrays(rows)

out["votes"] = [dist.converged_everywhere(True), dist.converged_everywhere(r == 0),
                dist.converged_everywhere(r != 0)]
dist.shutdown()
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % (N_COLS, N_OBS)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(port: int, n: int, rank: int, **extra) -> dict:
    """A rank's environment: the CPU, and no resident server unless
    ``extra`` names one."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(MIA_TORCH_DEVICE="cpu", MIA_SCORE_BATCH="64", OMP_NUM_THREADS="1",
               MIA_TORCH_SERVER="0",
               MIA_TORCH_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
               MIA_TORCH_NUM_PROCESSES=str(n), MIA_TORCH_PROCESS_ID=str(rank))
    env.update(extra)
    return env


def run_group(argvs, cwds, n, timeout=300, **extra):
    """Start one process per rank, all at once, ``extra`` added to each
    one's environment; returns each one's stderr.  Every rank must exit 0."""
    port = free_port()
    procs = [subprocess.Popen(argvs[i], cwd=cwds[i], env=rank_env(port, n, i, **extra),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(n)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i}: {err.decode()[-3000:]}"
    return [err for _, err in outs]


@pytest.fixture(scope="module", params=[2, 3], ids=["two_ranks", "three_ranks"])
def group(request, tmp_path_factory):
    """Each rank's results of the helper worker, in rank order."""
    d = tmp_path_factory.mktemp(f"group{request.param}")
    script = d / "worker.py"
    script.write_text(HELPERS)
    n = request.param
    run_group([[sys.executable, str(script), str(d / f"out.{i}")] for i in range(n)],
              [d] * n, n)
    res = []
    for i in range(n):
        with open(d / f"out.{i}", "rb") as f:
            res.append(pickle.load(f))
    assert [r["rank"] for r in res] == list(range(n)) and {r["n"] for r in res} == {n}
    return res


def test_consensus_reduction_equals_one_process(group):
    rng = np.random.default_rng(11)
    cols = rng.integers(0, N_COLS, N_OBS)
    chars = np.frombuffer(b"ACGT-", np.uint8)[rng.integers(0, 5, N_OBS)]
    depths = rng.integers(0, 31, N_OBS)
    strands = rng.random(N_OBS) < 0.5
    fpsm = init_flatsubmat().astype(np.int64)
    rpsm = revcom_submat(fpsm).astype(np.int64)
    cc = ColumnCounts(N_COLS)
    cc.add_bases(cols, chars, depths, strands, fpsm, rpsm)
    expect, _ = find_consensus_cols(cc, 1)
    for r in group:
        assert np.array_equal(r["cons"], expect), f"rank {r['rank']} consensus differs"
        assert r["counts"].dtype == np.int64
        for name in ("counts", "cov", "scores"):
            assert np.array_equal(r[name], getattr(cc, name)), name


def test_allreduce_terms_is_the_rank_order_numpy_sum(group):
    want = np.stack([r["terms"] for r in group]).sum(axis=0)
    for r in group:
        assert r["terms_sum"].dtype == np.float64
        assert r["terms_sum"].tobytes() == want.tobytes()
        assert r["ints_sum"].dtype == np.int64
        assert r["ints_sum"].tolist() == [sum(range(len(group))),
                                          len(group) * 2**40 + sum(range(len(group)))]
    if len(group) == 3:
        assert want[0] == 0.0  # where another order gives 1.0


def test_allreduce_max(group):
    want = np.stack([r["gaps"] for r in group]).max(axis=0)
    for r in group:
        assert np.array_equal(r["gaps_max"], want) and r["gaps_max"].dtype == np.int64


def test_gather_bytes_and_arrays(group):
    blobs = [r["blob"] for r in group]
    assert blobs[1] == b""
    for r in group:
        assert r["blobs"] == blobs
        assert r["empty_blobs"] == [b""] * len(group)
        assert [a.tolist() for a in r["rows_all"]] == [g["rows"].tolist() for g in group]


def test_converged_everywhere_needs_every_vote(group):
    for r in group:
        assert r["votes"] == [True, False, False]


def test_rank_outside_the_group_is_refused(monkeypatch):
    from mia_tpu_torch.parallel import distributed as dist

    monkeypatch.setenv(dist.COORDINATOR, "127.0.0.1:1")
    monkeypatch.setenv(dist.NUM_PROCESSES, "2")
    monkeypatch.setenv(dist.PROCESS_ID, "2")
    with pytest.raises(ValueError, match="outside 0..1"):
        dist.initialize_if_needed()
    assert dist.process_count() == 1 and dist.process_index() == 0


def run_assembly_group(args, tmp_path, engine, n=2):
    """An n-process assembly, rank i in tmp_path/rank<i>; returns the rank
    directories and each rank's profile counters."""
    dirs = [tmp_path / f"rank{i}" for i in range(n)]
    for d in dirs:
        d.mkdir()
    argv = [sys.executable, "-c", NO_JAX_MAIN, *args, "-m", "out.maln",
            "--engine", engine, "--profile"]
    errs = run_group([argv] * n, dirs, n)
    return dirs, [profile_counters(e) for e in errs]


@pytest.mark.parametrize("name", ["kmer", "fastq_UC", "hp"])
def test_two_process_torch_assembly_writes_golden(name, tmp_path):
    dirs, counters = run_assembly_group(fixture_args(name), tmp_path, "torch")
    golden = os.path.join(GOLDEN, name)
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(golden))
    for fn in sorted(os.listdir(golden)):
        assert _norm(dirs[0] / fn) == _norm(os.path.join(golden, fn)), f"{name}/{fn}"
    assert os.listdir(dirs[1]) == [], "only rank 0 writes"
    hp = name == "hp"
    for rank, c in enumerate(counters):
        # each rank scored its own reads with the port's scorer (the -h one
        # under -h) and counted its consensus with the port's counts, as
        # their plain versions on the CPU, and took part in the collectives
        assert c["pass1.reads_seen"] > 0, (rank, c)
        assert c["pass1.device_scored_reads"] + c["reiterate.device_entries"] > 0, (rank, c)
        assert c["reiterate.device_entries"] > 0, (rank, c)
        assert c["dp.hp_plain_calls" if hp else "dp.plain_calls"] > 0, (rank, c)
        assert c["dp.kernel_launches"] == c["dp.hp_kernel_launches"] == 0, (rank, c)
        assert c["cons.plain_calls"] > 0 and c["cons.kernel_launches"] == 0, (rank, c)
        assert "consensus.device_fallbacks" not in c, (rank, c)
        assert c["dist.collectives"] > 0, (rank, c)
    # the ranks' slices are the whole stream
    assert sum(c["pass1.reads_seen"] for c in counters) == count_frag_seqs(
        fixture_args(name)[3])


def test_two_process_native_collapse_fastq_equals_mia_tpu(tmp_path, monkeypatch):
    """-U -C2 -q: duplicate groups that span ranks, the global collapse and
    the global fastq export, against mia_tpu's single process."""
    args = [*fixture_args("fastq_UC"), "-q", "out.fastq"]
    dirs, counters = run_assembly_group(args, tmp_path, "native")
    single = tmp_path / "single"
    single.mkdir()
    monkeypatch.delenv("MIA_JAX_PLATFORM", raising=False)
    monkeypatch.chdir(single)
    with contextlib.redirect_stderr(io.StringIO()):
        assert tpu_mia.main([*args, "-m", "out.maln", "--engine", "native"]) == 0
    want = sorted(os.listdir(single))
    assert "out.fastq" in want and sorted(os.listdir(dirs[0])) == want
    for fn in want:
        if fn.startswith("out.maln"):
            assert _norm(dirs[0] / fn) == _norm(single / fn), fn
        else:
            assert (dirs[0] / fn).read_bytes() == (single / fn).read_bytes(), fn
    assert os.listdir(dirs[1]) == []
    for c in counters:
        assert c["pass1.reads_seen"] > 0 and c["dist.collectives"] > 0, c
        assert c["dp.plain_calls"] == c["cons.plain_calls"] == 0, c
