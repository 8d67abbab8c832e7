"""The port's consensus column counts (mia_tpu_torch.ops.consensus_torch)
against the JAX package's device accumulator
(mia_tpu.ops.consensus_device.device_column_counts, JAX's CPU backend) and
the host accumulator (mia_tpu.core.columns.main_column_counts), on seeded
record sets; and the port's consensus hook, which must make the assembly
raise when the device fails instead of counting on the host.

Tolerance: exact equality of the int64 counts, coverage and scores.
"""
import os

import numpy as np
import pytest
import torch

from mia_tpu_torch.cli.mia import parse_args
from mia_tpu.core.columns import _record_arrays, consensus_assembly_string, main_column_counts
from mia_tpu.ops import consensus_device
from mia_tpu_torch.utils import profiling
from mia_tpu_torch import testing as T
from mia_tpu_torch.core import assembler
from mia_tpu_torch.ops import consensus_torch as ct

from .conftest import FIXTURES


def _arrays(maln):
    _, spans, starts, revs, seq_a, smp_a, seq_off, smp_off = _record_arrays(maln, True)
    return (seq_a, smp_a, starts, spans, seq_off, smp_off, revs, maln.fpsm, maln.rpsm,
            maln.ref.seq_len)


def _tensors(args):
    seq, smp, starts, spans, seq_off, smp_off, revs, fpsm, rpsm, n = args
    t = [torch.from_numpy(np.require(a, dt, ["C", "W"])) for a, dt in (
        (seq, np.uint8), (smp, np.uint8), (starts, np.int32), (spans, np.int32),
        (seq_off, np.int32), (smp_off, np.int32), (revs, np.bool_), (fpsm, np.int32),
        (rpsm, np.int32))]
    return (*t, n)


@pytest.mark.parametrize("n,R,seed", [(300, 400, 0), (1200, 900, 1), (50, 40, 2)])
def test_column_counts_plain_matches_jax_and_host(n, R, seed):
    maln = T.random_records(n, R, seed=seed)
    args = _arrays(maln)
    host = main_column_counts(maln, exclude_dropped=True)
    jax_out = consensus_device.device_column_counts(*args)
    got = [t.numpy() for t in ct.column_counts_plain(*_tensors(args))]
    for g, j, h in zip(got, jax_out, (host.counts, host.cov, host.scores)):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, h)
    assert host.cov.sum() > 0 and host.counts[:, 4].sum() > 0  # gaps counted


def test_column_counts_routes_cpu_tensors_to_plain():
    maln = T.random_records(200, 100, seed=3)
    args = _tensors(_arrays(maln))
    ct.reset_counts()
    out = ct.column_counts(*args)
    assert (ct.plain_calls, ct.kernel_launches) == (1, 0)
    for a, b in zip(out, ct.column_counts_plain(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["dtype", "psm_shape", "record_count", "empty_arena"])
def test_column_counts_rejects_bad_inputs(bad):
    args = list(_tensors(_arrays(T.random_records(100, 30, seed=4))))
    if bad == "dtype":
        args[2] = args[2].to(torch.int64)
        err = TypeError
    elif bad == "psm_shape":
        args[7] = args[7][:30].contiguous()
        err = ValueError
    elif bad == "record_count":
        args[4] = args[4][:-1].contiguous()
        err = ValueError
    else:
        args[0] = args[0][:0]
        err = ValueError
    with pytest.raises(err):
        ct.column_counts(*args)


def test_device_hook_matches_host_consensus(monkeypatch):
    """The hook in consensus_assembly_string: same consensus, counted on the
    (CPU) device, no host fallback."""
    maln = T.random_records(400, 500, seed=5)
    maln.ref.gaps = np.zeros(401, np.int64)
    host = consensus_assembly_string(maln)
    counters: dict = {}
    monkeypatch.setattr(profiling, "_enabled", True)
    monkeypatch.setattr(profiling, "_counts", counters)
    monkeypatch.setattr(profiling, "_phases", {})
    ct.reset_counts()
    got = assembler.ConsensusHook(assembler.Placement(torch.device("cpu")).counts()).consensus(maln)
    assert got == host
    assert ct.plain_calls == 1
    assert counters.get("consensus.device_calls") == 1
    assert "consensus.device_fallbacks" not in counters


def _failing_plain(*args, **kwargs):
    raise RuntimeError("device counts failed")


def test_failing_hook_raises_after_consensus(monkeypatch):
    maln = T.random_records(300, 200, seed=6)
    maln.ref.gaps = np.zeros(301, np.int64)
    monkeypatch.setattr(ct, "column_counts_plain", _failing_plain)
    hook = assembler.ConsensusHook(assembler.Placement(torch.device("cpu")).counts())
    with pytest.raises(RuntimeError, match="device consensus failed") as info:
        hook.consensus(maln)
    assert "device counts failed" in str(info.value.__cause__)


def test_failing_hook_makes_assembly_raise(monkeypatch, tmp_path):
    """A device failure inside the consensus stops the run: the host's
    equal answer must not hide it."""
    monkeypatch.setenv("MIA_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MIA_SCORE_BATCH", "64")
    monkeypatch.setenv("MIA_TORCH_SERVER", "0")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ct, "column_counts_plain", _failing_plain)
    cfg = parse_args(["-r", os.path.join(FIXTURES, "tr1.fna"),
                      "-f", os.path.join(FIXTURES, "tf.fna"), "-k", "12",
                      "-m", "out.maln", "--engine", "torch"])
    with pytest.raises(RuntimeError, match="device consensus failed"):
        assembler.run_assembly(cfg)
    # iteration 1's maln is written before the first consensus; no later one
    assert sorted(os.listdir(tmp_path)) == ["out.maln.1"]


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_edge_records_plain_matches_host_and_jax(seed, big):
    """The adversarial record set (records across every 512-column border,
    below 0, off the end, span 0, all gaps, all N, one column hit by 4,200
    records): the plain version against the host accumulator, exact; with
    PSSM entries near +-2^20 the column's sums pass 2^32, past the JAX
    accumulator's int32 bound, so that one is compared only without them."""
    maln = T.edge_records(seed, big=big)
    args = _arrays(maln)
    host = main_column_counts(maln, exclude_dropped=True)
    got = [t.numpy() for t in ct.column_counts(*_tensors(args))]
    for g, h in zip(got, (host.counts, host.cov, host.scores)):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, h)
    if big:
        assert np.abs(got[2]).max() > 2**32
    else:
        for g, j in zip(got, consensus_device.device_column_counts(*args)):
            np.testing.assert_array_equal(g, j)


def test_edge_records_plain_matches_host_at_the_largest_entries():
    """PSSM entries near +-2^30, the largest an int32 table holds: two
    records already pass int32 in the column they share."""
    maln = T.edge_records(3, bits=30)
    host = main_column_counts(maln, exclude_dropped=True)
    got = [t.numpy() for t in ct.column_counts(*_tensors(_arrays(maln)))]
    for g, h in zip(got, (host.counts, host.cov, host.scores)):
        np.testing.assert_array_equal(g, h)
    assert np.abs(got[2]).max() > 2**40
