"""The port's multi-device paths against the JAX package's, on the CPU: the
dp x sp assembly step (mia_tpu_torch/parallel/sharded.py against
mia_tpu.parallel.sharded on the 8 virtual CPU devices), its pileup counts
and consensus call, the sharded entry scorer and consensus column counts
(device list ``["cpu"] * 4`` against the single shard and against mia_tpu's
mesh forms), ``--dp-devices`` on two goldens, and the port's dry run.

Tolerance: exact equality (integer outputs).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import mia_tpu.core.jax_engine as je
from mia_tpu.ops import consensus_device
from mia_tpu.ops.dp_jax import depths_for
from mia_tpu.ops.pssm import init_flatsubmat, revcom_submat
from mia_tpu.parallel import sharded as tpu_sharded
from mia_tpu_torch import testing as T
from mia_tpu_torch.cli import mia as port_mia
from mia_tpu_torch.core import assembler, torch_engine
from mia_tpu_torch.core.columns import _record_arrays, main_column_counts
from mia_tpu_torch.entry import dryrun_multichip, entry
from mia_tpu_torch.ops import consensus_torch, dp_cuda
from mia_tpu_torch.parallel import sharded

from .conftest import GOLDEN
from .test_parallel import _mk_inputs
from .test_torch_golden import _norm, fixture_args

CPU4 = ["cpu"] * 4


@pytest.mark.parametrize("dp,sp,W", [(4, 2, 384), (8, 1, 384), (1, 1, 384), (4, 2, 381)])
def test_assembly_step_matches_mia_tpu(dp, sp, W):
    """(best, aec, cons) of one step, mesh shape by mesh shape; W = 381
    leaves a tail past the sp blocks."""
    B, L = 16, 32
    s1c, s2c, lengths = _mk_inputs(B, W, L)
    depths = depths_for(lengths, L)
    fpsm = init_flatsubmat().astype(np.int32)
    rpsm = revcom_submat(fpsm).astype(np.int32)
    mask = np.ones((B, W), bool)
    args = (s1c, mask, s2c, lengths, depths, fpsm, rpsm)

    want = tpu_sharded.make_assembly_step(tpu_sharded.make_mesh(n_dp=dp, n_sp=sp))(
        *(jnp.asarray(a) for a in args))
    dp_cuda.reset_counts()
    sharded.reset_counts()
    mesh = sharded.make_mesh(dp, sp, ["cpu"] * (dp * sp))
    assert mesh.shape == (dp, sp)
    got = sharded.make_assembly_step(mesh)(*args)
    for name, g, w in zip(("best", "aec", "cons"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[2].dtype == torch.uint8 and got[2].shape == (W,)
    # one scorer and one pileup call per dp shard, one consensus call per sp
    # block and one for the tail; plain versions on the CPU
    assert (dp_cuda.last_row_plain_calls, dp_cuda.last_row_launches) == (dp, 0)
    assert (sharded.pileup_plain_calls, sharded.pileup_launches) == (dp, 0)
    assert (sharded.consensus_plain_calls, sharded.consensus_launches) == (sp + 1, 0)


def test_assembly_step_without_sg5_and_uneven_batch():
    """sg5 off, and a batch that does not divide by dp (the port splits
    unevenly): equal to one device."""
    args = T.step_inputs(13, 200, 24, seed=3)
    want = sharded.make_assembly_step(sharded.make_mesh(1, 1, ["cpu"]), sg5=False)(*args)
    got = sharded.make_assembly_step(sharded.make_mesh(4, 1, CPU4), sg5=False)(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="needs 8 devices"):
        sharded.make_mesh(4, 2, CPU4)


@pytest.mark.parametrize("seed", [0, 1])
def test_consensus_from_counts_matches_jax(seed):
    """Ties (the later base wins), empty columns, the gap share on and
    around its threshold, scores on and below the floor."""
    counts, scores = T.tie_counts(300, seed)
    want = np.asarray(tpu_sharded.consensus_from_counts(jnp.asarray(counts),
                                                        jnp.asarray(scores)))
    got = sharded.consensus_from_counts(torch.from_numpy(counts), torch.from_numpy(scores))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(b"ACGTN-") == set(want.tobytes())
    assert bytes(want[3::7][:3]) == b"TTT" and want[0] == ord("N")
    sharded.reset_counts()
    assert torch.equal(sharded.consensus_call(torch.from_numpy(counts),
                                              torch.from_numpy(scores)), got)
    assert (sharded.consensus_plain_calls, sharded.consensus_launches) == (1, 0)


def _parts_cases(n_parts: int, W: int = 301):
    """(name, counts parts, scores parts) as numpy int32: the pileups of
    n_parts read sets, tie_counts cut into parts whose running sums wrap,
    and parts whose own sums wrap."""
    piles = [sharded._pileup_counts(*(torch.from_numpy(d[k]) for k in T.PILEUP_KEYS), W)
             for d in (T.pileup_inputs(24, W, 32, seed=s) for s in range(n_parts))]
    return [("pileups", [c.numpy() for c, _ in piles], [s.numpy() for _, s in piles]),
            ("ties", *T.split_parts(*T.tie_counts(W, seed=n_parts), n_parts, seed=n_parts,
                                    big=True)),
            ("wrapping", *T.wrapping_parts(W, n_parts, seed=n_parts))]


@pytest.mark.parametrize("n_parts", [1, 2, 4, 8, 32])
def test_consensus_from_parts_matches_jax(n_parts):
    """The sum over dp folded into the consensus call: ``consensus_from_parts``
    equals jnp.sum of the parts followed by the JAX package's
    consensus_from_counts, on whole columns and on column slices at odd
    offsets, sums that wrap int32 included; the wrapper on the CPU is one
    plain call."""
    W = 301
    for name, counts, scores in _parts_cases(n_parts, W):
        wide = np.sum(np.stack(counts).astype(np.int64), axis=0)
        if name == "wrapping":  # the coverage wraps, and with two parts or more each sum
            assert (wide.sum(axis=1) > 2**31 - 1).all()
            assert (wide > 2**31 - 1).all() == (n_parts > 1)
        for cols in (slice(0, W), slice(3, W - 2), slice(7, 8)):
            pc = [np.ascontiguousarray(c[cols]) for c in counts]
            ps = [np.ascontiguousarray(s[cols]) for s in scores]
            want = np.asarray(tpu_sharded.consensus_from_counts(
                jnp.sum(jnp.stack(pc), axis=0), jnp.sum(jnp.stack(ps), axis=0)))
            tc, ts = [torch.from_numpy(c) for c in pc], [torch.from_numpy(s) for s in ps]
            got = sharded.consensus_from_parts(tc, ts)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} {cols}")
            sharded.reset_counts()
            assert torch.equal(sharded.consensus_call(tc, ts), got)
            whole = ([torch.from_numpy(c) for c in counts], [torch.from_numpy(s) for s in scores])
            assert torch.equal(sharded.consensus_call(*whole, cols), got)
            assert (sharded.consensus_plain_calls, sharded.consensus_launches) == (2, 0)
        if name == "ties":  # the parts add up to tie_counts again
            tie = sharded.consensus_from_counts(*(torch.from_numpy(a)
                                                  for a in T.tie_counts(W, seed=n_parts)))
            assert torch.equal(sharded.consensus_from_parts(
                [torch.from_numpy(c) for c in counts], [torch.from_numpy(s) for s in scores]), tie)


def test_consensus_call_rejects_bad_parts():
    c, s = (torch.from_numpy(a) for a in T.tie_counts(40))
    sharded.reset_counts()
    with pytest.raises(ValueError, match="want 1 to 32"):
        sharded.consensus_call([], [])
    with pytest.raises(ValueError, match="want 1 to 32"):
        sharded.consensus_call([c] * 33, [s] * 33)
    with pytest.raises(ValueError, match="want 1 to 32"):
        sharded.consensus_call([c, c], [s])
    with pytest.raises(ValueError, match=r"counts\[1\]: shape"):
        sharded.consensus_call([c, c[1:]], [s, s])
    with pytest.raises(TypeError, match=r"scores\[1\]"):
        sharded.consensus_call([c, c], [s, s.to(torch.int64)])
    with pytest.raises(ValueError, match=r"counts\[1\]: not contiguous"):
        sharded.consensus_call([c, c.t().contiguous().t()], [s, s])
    with pytest.raises(ValueError, match=r"scores\[0\]: on meta"):
        sharded.consensus_call([c], [s.to("meta")])
    with pytest.raises(ValueError, match="a step of 1"):
        sharded.consensus_call([c], [s], slice(0, 40, 2))
    with pytest.raises(ValueError, match="sums at most 32"):
        sharded.make_assembly_step(np.array([["cpu"]] * 33))
    assert (sharded.consensus_plain_calls, sharded.consensus_launches) == (0, 0)


def test_assembly_step_sums_dp_inside_the_consensus_call(monkeypatch):
    """dp = 4, sp = 2: every consensus call takes the four dp shards'
    slices of its columns, and no add over the whole [W, 5] or [W, 4]
    accumulators is left in the step (the CPU's plain version adds its
    parts inside the call, over a block's columns)."""
    W = 300
    args = T.step_inputs(16, W, 24, seed=3)
    calls = []
    orig = sharded.consensus_call
    monkeypatch.setattr(sharded, "consensus_call", lambda c, s, cols: calls.append(
        ([tuple(x.shape) for x in c], cols)) or orig(c, s, cols))
    got, ops = T.aten_ops(sharded.make_assembly_step(sharded.make_mesh(4, 2, ["cpu"] * 8)),
                          *args)
    assert calls == [([(W, 5)] * 4, slice(0, 150)), ([(W, 5)] * 4, slice(150, 300)),
                     ([(W, 5)] * 4, slice(300, 300))]
    assert not [op for op, shapes in ops if op.startswith("aten.add")
                and any(sh in ((W, 5), (W, 4)) for sh in shapes)]
    want = sharded.make_assembly_step(sharded.make_mesh(1, 1, ["cpu"]))(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_block_parts_sends_only_the_block_between_devices():
    """A consensus call on the parts' own device reads them in place; on
    another device it gets only the block's rows of each part (the meta
    device stands in for a second card)."""
    counts, scores = T.split_parts(*T.tie_counts(40, seed=2), 4, seed=2)
    pc, ps = [torch.from_numpy(c) for c in counts], [torch.from_numpy(s) for s in scores]
    cols = slice(10, 30)
    c, s, got_cols = sharded.block_parts(pc, ps, torch.device("cpu"), cols)
    assert (c, s, got_cols) == (pc, ps, cols)
    c, s, got_cols = sharded.block_parts(pc, ps, torch.device("meta"), cols)
    assert got_cols == slice(None)
    assert [(t.device.type, tuple(t.shape)) for t in c] == [("meta", (20, 5))] * 4
    assert [(t.device.type, tuple(t.shape)) for t in s] == [("meta", (20, 4))] * 4
    # one part already there: every part's block is taken, so the call sees
    # one shape
    c, s, got_cols = sharded.block_parts([pc[0].to("meta"), *pc[1:]], ps,
                                         torch.device("meta"), cols)
    assert got_cols == slice(None) and {tuple(t.shape) for t in c} == {(20, 5)}


@pytest.mark.parametrize("B,W,L,seed", [(16, 120, 24, 0), (40, 60, 32, 1)])
def test_pileup_counts_matches_jax(B, W, L, seed):
    """Starts that run off both ends, code 4, both strands."""
    d = T.pileup_inputs(B, W, L, seed)
    assert (d["starts"] < 0).any() and (d["starts"] + d["lengths"] > W).any()
    wc, ws = tpu_sharded._pileup_counts(*(jnp.asarray(d[k]) for k in T.PILEUP_KEYS), W)
    args = [torch.from_numpy(d[k]) for k in T.PILEUP_KEYS]
    gc, gs = sharded._pileup_counts(*args, W)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert gc[:, 4].sum() > 0
    sharded.reset_counts()
    pc, ps = sharded.pileup_counts(*args, W)
    assert torch.equal(pc, gc) and torch.equal(ps, gs)
    assert (sharded.pileup_plain_calls, sharded.pileup_launches) == (1, 0)
    with pytest.raises(TypeError, match="strands"):
        sharded.pileup_counts(*args[:4], args[4].to(torch.int32), *args[5:], W)


def test_make_dp_devices(monkeypatch):
    assert torch_engine.make_dp_devices(0) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert torch_engine.make_dp_devices(4) is None and torch_engine.make_dp_devices(-1) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert torch_engine.make_dp_devices(3) == [torch.device("cuda", i) for i in range(3)]
    assert len(torch_engine.make_dp_devices(-1)) == len(torch_engine.make_dp_devices(9)) == 4
    assert torch_engine.make_dp_devices(1) is None
    # an explicit list is taken as it is, repeats and all
    assert torch_engine.make_dp_devices(0, CPU4) == [torch.device("cpu")] * 4
    assert torch_engine.make_dp_devices(4, ["cpu"]) is None


def test_sharded_scorer_matches_single_and_mia_tpu_mesh():
    """The dp-sharded entry scorer: the port over 4 shards, the port on one
    device and mia_tpu's _mesh_fn over 8 virtual devices, on the inputs of
    the JAX package's mesh scorer test; results in the caller's order."""
    rng = np.random.default_rng(5)
    len1 = 700
    fw = rng.integers(0, 4, len1).astype(np.int8)
    rc = rng.integers(0, 4, len1).astype(np.int8)
    fpsm = init_flatsubmat().astype(np.int32)
    rpsm = revcom_submat(fpsm).astype(np.int32)
    n = 50
    ref_sel = rng.integers(0, 2, n).astype(np.int8)
    smidx = rng.integers(0, 2, n).astype(np.int8)
    lens = rng.integers(8, 60, n).astype(np.int32)
    starts = rng.integers(0, len1 - je.WIN_W + 1, n).astype(np.int32)
    ivl = np.zeros((n, je.MAX_INTERVALS, 2), np.int32)
    ivl[:, 0, 0] = 2
    ivl[:, 0, 1] = rng.integers(80, je.WIN_W, n)
    s2c = rng.integers(0, 5, (n, je.L_MAX)).astype(np.int8)
    entries = (ref_sel, starts, ivl, s2c, lens, smidx)

    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    tpu = je.Pass1Scorer(fw, rc, len1, fpsm, rpsm, batch=32, mesh=mesh, warm=False)
    want = tpu.collect_entries(tpu.dispatch_entries(*entries))

    single = torch_engine.Pass1Scorer(fw, rc, len1, fpsm, rpsm, batch=32, device="cpu")
    dp_cuda.reset_counts()
    one = single.collect_entries(single.dispatch_entries(*entries))
    assert (dp_cuda.plain_calls, dp_cuda.shards) == (1, 1)
    four = torch_engine.Pass1Scorer(fw, rc, len1, fpsm, rpsm, batch=32, devices=CPU4)
    assert len(four.shards) == 4
    dp_cuda.reset_counts()
    h = four.dispatch_entries(*entries)
    assert four.ready(h)
    got = four.collect_entries(h)
    assert (dp_cuda.plain_calls, dp_cuda.shards) == (4, 4)
    for g, o, w in zip(got, one, want):
        np.testing.assert_array_equal(g, o)
        np.testing.assert_array_equal(g, w)
    # fewer entries than shards: the empty shards are skipped
    few = four.collect_entries(four.dispatch_entries(*(a[:3] for a in entries)))
    np.testing.assert_array_equal(few[0], want[0][:3])
    np.testing.assert_array_equal(few[1], want[1][:3])
    # a JAX scorer's state carried over, once per shard
    states = [torch_engine.state_from_numpy(tpu._refs_np, tpu._sms_np, d) for d in CPU4]
    carried = torch_engine.Pass1Scorer.from_state(states, len1, batch=32)
    got = carried.collect_entries(carried.dispatch_entries(*entries))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_sharded_column_counts_match_single_host_and_mia_tpu_mesh():
    maln = T.random_records(300, 400, seed=5)
    host = main_column_counts(maln, exclude_dropped=True)
    _, spans, starts, revs, seq_a, smp_a, seq_off, smp_off = _record_arrays(maln, True)
    hook = (seq_a, smp_a, starts, spans, seq_off, smp_off, revs, maln.fpsm, maln.rpsm, 300)
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    want = consensus_device.device_column_counts(*hook, mesh=mesh)
    consensus_torch.reset_counts()
    one = consensus_torch.device_column_counts(*hook, device="cpu")
    four = consensus_torch.device_column_counts(*hook, devices=CPU4)
    assert consensus_torch.plain_calls == 5
    for f, o, w, h in zip(four, one, want, (host.counts, host.cov, host.scores)):
        assert f.dtype == np.int64
        np.testing.assert_array_equal(f, o)
        np.testing.assert_array_equal(f, w)
        np.testing.assert_array_equal(f, h)
    # contiguous groups of about equal observation counts, every record once
    bounds = consensus_torch._split_records(spans, 4)
    assert [lo for lo, _ in bounds] == [0] + [hi for _, hi in bounds[:-1]]
    assert bounds[-1][1] == len(spans)
    share = -(-int(spans.sum()) // 4)
    assert all(int(spans[lo:hi].sum()) <= share + int(spans.max()) for lo, hi in bounds)
    # more shards than records: the spare shards get nothing
    assert consensus_torch._split_records(spans[:2], 4)[2:] == [(2, 2), (2, 2)]


@pytest.mark.parametrize("name", ["default", "kmer"])
def test_dp_devices_golden_byte_identical(name, tmp_path, monkeypatch):
    """``--dp-devices 4`` with a list of four devices: the golden's bytes,
    every dispatch dealt over 4 shards, the consensus records too."""
    monkeypatch.setenv("MIA_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MIA_SCORE_BATCH", "64")
    monkeypatch.chdir(tmp_path)
    orig = torch_engine.make_dp_devices
    monkeypatch.setattr(assembler, "make_dp_devices",
                        lambda n: orig(n, devices=CPU4[:n]) if n else None)
    split = []
    orig_split = consensus_torch._split_records
    monkeypatch.setattr(consensus_torch, "_split_records",
                        lambda spans, k: split.append(k) or orig_split(spans, k))
    rc = port_mia.main([*fixture_args(name), "-m", "out.maln", "--dp-devices", "4",
                        "--profile"])
    assert rc == 0
    golden = os.path.join(GOLDEN, name)
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(golden))
    for fn in os.listdir(golden):
        assert _norm(tmp_path / fn) == _norm(os.path.join(golden, fn)), fn
    assert dp_cuda.shards == 4
    assert dp_cuda.plain_calls > 0 and dp_cuda.plain_calls % 4 == 0
    assert dp_cuda.kernel_launches == 0
    assert split and set(split) == {4}


def test_dp_devices_under_hp_stay_on_one_device(tmp_path, monkeypatch):
    """-h has no sharded scorer (as in the JAX package): the device list is
    dropped and the run equals the golden."""
    monkeypatch.setenv("MIA_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MIA_TORCH_SERVER", "0")
    monkeypatch.setenv("MIA_SCORE_BATCH", "64")
    monkeypatch.chdir(tmp_path)
    orig = torch_engine.make_dp_devices
    monkeypatch.setattr(assembler, "make_dp_devices",
                        lambda n: orig(n, devices=CPU4[:n]) if n else None)
    assert port_mia.main([*fixture_args("hp_k"), "-m", "out.maln", "--dp", "4"]) == 0
    golden = os.path.join(GOLDEN, "hp_k")
    for fn in os.listdir(golden):
        assert _norm(tmp_path / fn) == _norm(os.path.join(golden, fn)), fn
    assert dp_cuda.shards == 1 and dp_cuda.hp_plain_calls > 0


def test_entry_and_dryrun_multichip(monkeypatch):
    monkeypatch.setenv("MIA_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("MIA_SCORE_BATCH", raising=False)
    fn, args = entry()
    best, aec = fn(*args)
    assert best.shape == aec.shape == (8,) and best.dtype == torch.int32
    dryrun_multichip(4)
    dryrun_multichip(2)
    # the dry run's small batch is its own: the process keeps the default
    assert "MIA_SCORE_BATCH" not in os.environ
