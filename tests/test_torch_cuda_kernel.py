"""The CUDA kernels against their plain PyTorch versions on the card: the
entry scorer and its -h instantiation (mia_tpu_torch/csrc/dp_entries.cu,
also against the exact host DP), the consensus column counts
(mia_tpu_torch/csrc/column_counts.cu, also against the host accumulator),
ccheck's Myers wavefront (mia_tpu_torch/csrc/myers_waves.cu, also against
the host aligner, on the adversarial pairs too), the general-width
last-row scorer (mia_tpu_torch/csrc/dp_last_row.cu: the register form, and
the wide form with shared-memory and global-memory rows, and its -h form;
the band forms of both, mia_tpu_torch/csrc/dp_band.cu, on 1, 2, 4 and 8
warps a row; and the strand forms of both, mia_tpu_torch/csrc/dp_strand.cu),
the pileup counts and the consensus call of the assembly step (csrc/pileup_counts.cu,
csrc/consensus_call.cu, the latter over 1 to 32 parts), and the sharded
scorer, consensus counts and step with every shard on the one card.

Needs an NVIDIA card: without one every test skips (a CUDA kernel has no
CPU mode).  The repository's conftest imports jax, which the machine with
the card need not have, so run these there without it:

    python -m pytest --noconftest tests/test_torch_cuda_kernel.py

Tolerance: exact int32 equality.
"""
import numpy as np
import pytest
import torch

from mia_tpu_torch import testing as T
from mia_tpu_torch.core.torch_engine import Pass1Scorer, score_wide, state_from_numpy
from mia_tpu_torch.ops import consensus_torch, dp_cuda, dp_torch, myers_cuda, myers_torch
from mia_tpu_torch.parallel import sharded

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _on(d, dev):
    return [torch.from_numpy(d[k]).to(dev) for k in T.ENTRY_KEYS]


@pytest.mark.parametrize("E,L,seed", [(1, 32, 0), (7, 32, 1), (600, 64, 2),
                                      (2048, 256, 3)])
def test_kernel_matches_plain(cuda, E, L, seed):
    args = _on(T.random_entries(E, L, seed=seed), cuda)
    dp_cuda.reset_counts()
    got = dp_cuda.dp_entries(*args)
    torch.cuda.synchronize()
    assert (dp_cuda.kernel_launches, dp_cuda.plain_calls) == (1, 0)
    assert torch.equal(got, dp_torch.entries_core_plain(*args))


def test_kernel_matches_solve_sg(cuda):
    d = T.oracle_entries(32, 64, seed=5)
    out = dp_cuda.dp_entries(*_on(d, cuda)).cpu().numpy()
    for e in range(32):
        assert T.solve_sg_entry(d, e) == (out[0, e], out[1, e]), e


def test_kernel_rejects_mixed_devices(cuda):
    args = _on(T.random_entries(8, 32, seed=6), cuda)
    args[3] = args[3].cpu()
    with pytest.raises(ValueError):
        dp_cuda.dp_entries(*args)


def test_scorer_on_card_matches_cpu_scorer(cuda):
    d = T.random_entries(300, 256, seed=7)
    entries = [d[k] for k in T.ENTRY_KEYS[2:]]
    res = []
    for dev in (cuda, torch.device("cpu")):
        sc = Pass1Scorer.from_state(state_from_numpy(d["refs"], d["sms"], dev),
                                    d["len1"], batch=150)
        h = sc.dispatch_entries(*entries)
        res.append(sc.collect_entries(h))
        assert sc.ready(h)
    np.testing.assert_array_equal(res[0][0], res[1][0])
    np.testing.assert_array_equal(res[0][1], res[1][1])


def _on_hp(d, dev):
    return [torch.from_numpy(np.ascontiguousarray(d[k])).to(dev) for k in T.HP_ENTRY_KEYS]


@pytest.mark.parametrize("E,L,seed", [(1, 32, 0), (9, 32, 1), (600, 64, 2),
                                      (2048, 256, 3), (333, 256, 4)])
def test_hp_kernel_matches_plain(cuda, E, L, seed):
    args = _on_hp(T.random_hp_entries(E, L, seed=seed), cuda)
    dp_cuda.reset_counts()
    got = dp_cuda.dp_entries_hp(*args)
    torch.cuda.synchronize()
    assert (dp_cuda.hp_kernel_launches, dp_cuda.hp_plain_calls) == (1, 0)
    assert torch.equal(got, dp_torch.entries_core_hp_plain(*args))


def test_hp_kernel_matches_solve_sg(cuda):
    d = T.oracle_hp_entries(32, 96, seed=5)
    out = dp_cuda.dp_entries_hp(*_on_hp(d, cuda)).cpu().numpy()
    for e in range(32):
        assert T.solve_sg_entry(d, e) == (out[0, e], out[1, e]), e


def test_hp_kernel_rejects_mixed_devices(cuda):
    args = _on_hp(T.random_hp_entries(8, 32, seed=6), cuda)
    args[2] = args[2].cpu()
    with pytest.raises(ValueError):
        dp_cuda.dp_entries_hp(*args)


def _records_on(maln, dev):
    from mia_tpu_torch.core.columns import _record_arrays

    _, spans, starts, revs, seq, smp, seq_off, smp_off = _record_arrays(maln, True)
    arrs = [(seq, np.uint8), (smp, np.uint8), (starts, np.int32), (spans, np.int32),
            (seq_off, np.int32), (smp_off, np.int32), (revs, np.bool_),
            (maln.fpsm, np.int32), (maln.rpsm, np.int32)]
    return [torch.from_numpy(np.require(a, t, ["C", "W"])).to(dev) for a, t in arrs]


@pytest.mark.parametrize("n,R,seed", [(300, 400, 0), (16569, 20000, 1)])
def test_column_counts_kernel_matches_plain_and_host(cuda, n, R, seed):
    from mia_tpu_torch.core.columns import main_column_counts

    maln = T.random_records(n, R, seed=seed)
    args = _records_on(maln, cuda)
    consensus_torch.reset_counts()
    got = consensus_torch.column_counts(*args, n)
    torch.cuda.synchronize()
    assert (consensus_torch.kernel_launches, consensus_torch.plain_calls) == (1, 0)
    for g, p in zip(got, consensus_torch.column_counts_plain(*args, n)):
        assert torch.equal(g, p)
    host = main_column_counts(maln, exclude_dropped=True)
    for g, h in zip(got, (host.counts, host.cov, host.scores)):
        np.testing.assert_array_equal(g.cpu().numpy(), h)


def test_column_counts_kernel_rejects_mixed_devices(cuda):
    args = _records_on(T.random_records(100, 50, seed=2), cuda)
    args[5] = args[5].cpu()
    with pytest.raises(ValueError):
        consensus_torch.column_counts(*args, 100)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_matches_plain_on_edge_entries(cuda, seed):
    """Closed windows, one-column bands, lane-sized intervals, column 0, all
    16 intervals, reads of 0..257 rows, ties: where a mask folded into the
    kernel's data could differ from the plain version's selects."""
    args = _on(T.edge_entries(seed), cuda)
    got = dp_cuda.dp_entries(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, dp_torch.entries_core_plain(*args))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hp_kernel_matches_plain_on_edge_entries(cuda, seed):
    args = _on_hp(T.edge_hp_entries(seed), cuda)
    got = dp_cuda.dp_entries_hp(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, dp_torch.entries_core_hp_plain(*args))


@pytest.mark.parametrize("seed,big,bits", [(0, False, 20), (1, True, 20), (2, True, 20),
                                           (3, True, 24), (4, True, 30)])
def test_column_counts_kernel_matches_plain_and_host_on_edge_records(cuda, seed, big, bits):
    """Records across every tile border and both ends of the reference, and
    (big) sums past 2^32 in one column: a private int32 sum must not wrap.
    At 2^24 a block may walk fewer records between two flushes than it has
    threads, at 2^30 one."""
    from mia_tpu_torch.core.columns import main_column_counts

    maln = T.edge_records(seed, big=big, bits=bits)
    n = maln.ref.seq_len
    args = _records_on(maln, cuda)
    got = consensus_torch.column_counts(*args, n)
    torch.cuda.synchronize()
    assert [tuple(g.shape) for g in got] == [(n, 5), (n,), (n, 4)]
    assert all(g.is_contiguous() and g.dtype == torch.int64 for g in got)
    for g, p in zip(got, consensus_torch.column_counts_plain(*args, n)):
        assert torch.equal(g, p)
    host = main_column_counts(maln, exclude_dropped=True)
    for g, h in zip(got, (host.counts, host.cov, host.scores)):
        np.testing.assert_array_equal(g.cpu().numpy(), h)
    if big:
        assert int(got[2].abs().max()) > 2**32


@pytest.mark.parametrize("n,R", [(16569, 3), (16569, 300), (40, 5000), (70000, 2000)])
def test_column_counts_kernel_grid_follows_columns_and_records(cuda, n, R):
    """Few records over many columns (no empty slice), many records over
    one tile, more tiles than the card has SMs."""
    maln = T.random_records(n, R, seed=n + R)
    args = _records_on(maln, cuda)
    got = consensus_torch.column_counts(*args, n)
    for g, p in zip(got, consensus_torch.column_counts_plain(*args, n)):
        assert torch.equal(g, p)


def _myers_case(kind, seed):
    """(seq_a, mode, seq_b, maxd) of one kernel test case."""
    from mia_tpu_torch.cli.ccheck import load_mt311
    from mia_tpu_torch.models.simulate import random_reference
    from mia_tpu_torch.ops.myers import Mode

    rng = np.random.default_rng(seed)
    if kind == "pairs":
        return T.myers_pairs(seed)
    panel = load_mt311()
    if kind == "mt311":
        b = T.ccheck_sample(seed)[1]
    elif kind == "mt311_5pct":
        b = T.mutate(T.ccheck_sample(seed)[0], rng, 0.05, 0.002)
    elif kind == "unrelated":
        b = random_reference(16569, seed)
    elif kind == "long":  # bitmaps too long for shared memory: read from global
        panel = panel * 7
        b = T.mutate(T.resolve_iupac(panel, rng), rng, 0.0005, 0.0001)
        return [(panel, Mode.GLOBAL, b, 200)]
    else:  # a 3 kb slice of mt311 against a mutated copy
        panel = panel[2000:5000]
        b = T.mutate(T.resolve_iupac(panel, rng), rng, 0.03, 0.005)
    return [(panel, Mode.GLOBAL, b, max(len(panel), len(b)) // 10)]


@pytest.mark.parametrize("kind,seed", [("pairs", 0), ("pairs", 1), ("slice", 2),
                                       ("mt311", 3), ("mt311_5pct", 4),
                                       ("unrelated", 5), ("long", 6)])
def test_myers_kernel_matches_plain_and_host(cuda, kind, seed):
    from mia_tpu_torch.ops.myers import Mode, UINT_MAX, myers_diff

    for a, mode, b, maxd in _myers_case(kind, seed):
        maxd = min(maxd, len(a) + len(b))
        if maxd <= 0:
            continue
        bm_a, bm_b = myers_torch.bitmaps(a, b)
        flags = dict(maxd=maxd, mode_is_prefix=mode == Mode.IS_PREFIX,
                     mode_has_prefix=mode == Mode.HAS_PREFIX)
        args = (torch.from_numpy(bm_a).to(cuda), torch.from_numpy(bm_b).to(cuda),
                len(a), len(b))
        myers_cuda.reset_counts()
        kd, kk, khist = myers_cuda.waves(*args, **flags)
        torch.cuda.synchronize()
        assert (myers_cuda.kernel_launches, myers_cuda.plain_calls) == (1, 0)
        pd, pk, phist = myers_torch.waves_plain(*args, **flags)
        assert (kd, kk) == (pd, pk), (kind, len(a), len(b), maxd)
        assert torch.equal(khist, phist)
        want = myers_diff(a, mode, b, maxd)
        assert myers_torch.myers_diff_torch(a, mode, b, maxd, device=cuda) == want
        if kind == "unrelated":
            assert want[0] == UINT_MAX and kd == maxd


def _myers_on_card(cuda, a, mode, b, maxd):
    """The kernel against the plain version (found and the whole history)
    and myers_diff_torch on the card against the host aligner, one launch."""
    from mia_tpu_torch.ops.myers import Mode, myers_diff

    bm_a, bm_b = myers_torch.bitmaps(a, b)
    flags = dict(maxd=maxd, mode_is_prefix=mode == Mode.IS_PREFIX,
                 mode_has_prefix=mode == Mode.HAS_PREFIX)
    args = (torch.from_numpy(bm_a).to(cuda), torch.from_numpy(bm_b).to(cuda), len(a), len(b))
    myers_cuda.reset_counts()
    kd, kk, khist = myers_cuda.waves(*args, **flags)
    torch.cuda.synchronize()
    assert (myers_cuda.kernel_launches, myers_cuda.plain_calls) == (1, 0)
    pd, pk, phist = myers_torch.waves_plain(*args, **flags)
    assert (kd, kk) == (pd, pk)
    assert torch.equal(khist, phist)
    assert myers_torch.myers_diff_torch(a, mode, b, maxd, device=cuda) == \
        myers_diff(a, mode, b, maxd)


@pytest.mark.parametrize("seed", [0, 1])
def test_myers_kernel_on_edge_pairs(cuda, seed):
    """edge_myers_pairs: lengths around the 8- and 16-base snake steps and the
    padding, N runs, bitmap-0 characters, snakes ending at either or both
    ends, maxd 1 and clipped, all modes, bitmaps past shared memory."""
    for name, a, mode, b, maxd in T.edge_myers_pairs(seed):
        maxd = min(maxd, len(a) + len(b))
        if maxd > 0:
            _myers_on_card(cuda, a, mode, b, maxd)


def test_myers_kernel_with_the_ring_in_global_memory(cuda):
    """maxd 15,000: two rows of 30,001 lanes pass shared memory, so the
    previous wave is read back from the history (an 8 kb pair 40 edits
    apart: the alignment is found early, the history is 1.8 GB)."""
    from mia_tpu_torch.ops.myers import Mode

    rng = np.random.default_rng(7)
    a = "".join(rng.choice(list("ACGT"), 8000))
    b = T.mutate(a, rng, 0.004, 0.001)
    _myers_on_card(cuda, a, Mode.GLOBAL, b, 15000)


def test_myers_kernel_rejects_mixed_devices(cuda):
    bm_a, bm_b = (torch.from_numpy(x) for x in myers_torch.bitmaps("ACGTA", "ACGA"))
    with pytest.raises(ValueError):
        myers_cuda.waves(bm_a.to(cuda), bm_b, 5, 4, maxd=3, mode_is_prefix=False,
                         mode_has_prefix=False)


@pytest.mark.parametrize("B,W,L,seed", [(8, 64, 8, 0), (16, 384, 32, 1), (5, 1000, 64, 2),
                                        (40, 17024, 256, 3), (3, 20000, 48, 4),
                                        (6, 17408, 40, 5), (6, 17409, 40, 6),
                                        (4, 17700, 48, 7)])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("sg5", [True, False])
def test_last_row_kernel_matches_plain(cuda, B, W, L, seed, shared, sg5):
    """Any width: the register form up to 17,408 columns; past it the wide
    form, rows in shared memory up to 17.8k columns (W = 17,409 and 17,700)
    and in global memory above (W = 20,000); shared and per-read reference;
    both sg5."""
    d = T.last_row_inputs(B, W, L, seed=seed, shared=shared)
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.LAST_ROW_KEYS]
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row(*args, sg5=sg5)
    torch.cuda.synchronize()
    assert (dp_cuda.last_row_launches, dp_cuda.last_row_plain_calls) == (1, 0)
    assert dp_cuda.last_row_wide_launches == int(
        W > dp_cuda.LAST_ROW_COLS * dp_cuda.LAST_ROW_THREADS)
    want = dp_torch.batch_last_row(*args, sg5=sg5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_last_row_kernel_on_edge_inputs(cuda, seed, shared):
    """Rows of 1 to 2,300 columns, lengths 0 to L + 1, closed rows, bands
    over every thread and warp border, ties (edge_last_row_inputs)."""
    dp_cuda.reset_counts()
    cases = T.edge_last_row_inputs(seed, shared, wide=True)
    for name, d, sg5 in cases:
        args = [torch.from_numpy(d[k]).to(cuda) for k in T.LAST_ROW_KEYS]
        got = dp_cuda.dp_last_row(*args, sg5=sg5)
        assert torch.equal(got, dp_torch.batch_last_row(*args, sg5=sg5)), name
    assert (dp_cuda.last_row_launches, dp_cuda.last_row_wide_launches,
            dp_cuda.last_row_plain_calls) == (len(cases), 0, 0)


@pytest.mark.parametrize("shared", [True, False])
def test_last_row_kernel_at_full_width(cuda, shared):
    """The shape the kernel is timed at: B = 512, W = 17,024, L = 256."""
    d = T.fullwidth_inputs(512, 17024, 256, seed=21, shared=shared)
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.LAST_ROW_KEYS]
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row(*args)
    assert torch.equal(got, dp_torch.batch_last_row(*args))
    assert (dp_cuda.last_row_launches, dp_cuda.last_row_wide_launches) == (1, 0)


def test_last_row_kernel_rejects_mixed_devices(cuda):
    d = T.last_row_inputs(4, 64, 8, seed=5)
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.LAST_ROW_KEYS]
    args[3] = args[3].cpu()
    with pytest.raises(ValueError):
        dp_cuda.dp_last_row(*args)


@pytest.mark.parametrize("W,L,seed", [(40, 37, 0), (100, 48, 1), (1100, 64, 2),
                                      (2300, 48, 3), (17024, 40, 4), (17408, 40, 5),
                                      (17408, 256, 6)])
def test_last_row_hp_kernel_matches_plain(cuda, W, L, seed):
    """The -h form (dp_last_row_hp) on testing.hp_wide_inputs' edge rows
    (read runs of 1, 2 and 31, a window starting inside a reference run, a
    run at columns 0-1, ties, one-column bands, narrower rows, windows past
    the strand state, lengths 1, 2 and L): widths of one and of two warps,
    the human-mt strand's and the 17,408-column limit."""
    d = T.hp_wide_inputs(W, L, seed)
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.HP_WIDE_KEYS]
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_hp(*args, W)
    torch.cuda.synchronize()
    assert (dp_cuda.last_row_hp_launches, dp_cuda.last_row_hp_plain_calls) == (1, 0)
    assert torch.equal(got, dp_torch.last_row_hp_plain(*args, W))


def test_last_row_hp_kernel_through_the_scorer(cuda):
    """torch_engine.score_wide under -h on the card (the state's own strand
    arrays) equals it on the CPU."""
    d = T.hp_wide_inputs(2300, 64, 7)
    rows = [torch.from_numpy(d[k]) for k in ("strand", "win_lo", "ivl", "s2chr", "lengths")]
    sms = np.stack([d["submat"], d["submat"]])
    got = {}
    for dev in (cuda, torch.device("cpu")):
        st = state_from_numpy(d["refs"], sms, dev, d["refchr"], d["hpcs"], d["pengop"])
        got[dev.type] = score_wide(st, d["width"], 0, (), 0, *(r.to(dev) for r in rows)).cpu()
    assert torch.equal(got["cuda"], got["cpu"])


def test_last_row_hp_kernel_rejects_mixed_devices(cuda):
    d = T.hp_wide_inputs(100, 40, 8)
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.HP_WIDE_KEYS]
    args[10] = args[10].cpu()
    with pytest.raises(ValueError):
        dp_cuda.dp_last_row_hp(*args, 100)


def _band_first(d: dict, rows=T.HP_WIDE_KEYS[6:]):
    """``d``'s rows (its per-row arrays ``rows``) in the order of
    entries.wide_rows (the band form's by warps, then the strand form's,
    then the full form's), and (n_band, band_classes, n_strand, the full
    rows' widest window)."""
    from mia_tpu_torch.core.entries import band_columns, wide_order

    order, classes, n_strand = wide_order(band_columns(d["ivl"])[1])
    d = {k: (v[order] if k in rows else v) for k, v in d.items()}
    n_band = sum(classes)
    return d, (n_band, classes, n_strand,
               int(d["ivl"][n_band + n_strand:, :, 1].max(initial=1)))


@pytest.mark.parametrize("L,seed", [(40, 0), (48, 1), (256, 2)])
def test_band_hp_kernel_matches_plain_on_edge_rows(cuda, L, seed):
    """The -h band form (csrc/dp_band.cu) on testing.hp_band_inputs'
    edge rows, 1, 2, 4 and 8 warps a row, the -h strand form
    (csrc/dp_strand.cu) taking the rows past 3,072 band columns in the same
    call: both equal their plain versions; one launch of each and none of
    the full form."""
    d, (n_band, classes, n_strand, width) = _band_first(T.hp_band_inputs(L, seed))
    assert all(classes) and n_strand == len(d["lengths"]) - n_band > 0
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.HP_WIDE_KEYS]
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_hp(*args, width, n_band, classes, n_strand)
    torch.cuda.synchronize()
    assert (dp_cuda.last_row_hp_band_launches, dp_cuda.last_row_hp_strand_launches,
            dp_cuda.last_row_hp_launches) == (1, 1, 0)
    assert (dp_cuda.last_row_hp_band_plain_calls, dp_cuda.last_row_hp_strand_plain_calls,
            dp_cuda.last_row_hp_plain_calls) == (0, 0, 0)
    assert dp_cuda.last_row_hp_band_multi_rows == n_band - classes[0]
    want = dp_cuda.dp_last_row_hp(*(a.cpu() for a in args), width, n_band, classes, n_strand)
    assert torch.equal(got.cpu(), want)
    # every row given to the band form, the rest on eight warps: those past
    # it marked (HIM, -1)
    R = len(d["lengths"])
    got = dp_cuda.dp_last_row_hp(*args, 0, R, (*classes[:3], classes[3] + R - n_band))
    assert torch.equal(got.cpu(), dp_torch.last_row_hp_band_plain(*(a.cpu() for a in args)))
    assert (got[1] == -1).sum().item() == R - n_band


@pytest.mark.parametrize("W,L,seed", [(2300, 48, 3), (17408, 40, 5)])
def test_band_hp_kernel_on_wide_inputs(cuda, W, L, seed):
    """testing.hp_wide_inputs' rows split between the band and strand forms,
    and the strand rows once more on the full form at their own widest
    window: equal to the plain versions."""
    d, (n_band, classes, n_strand, _) = _band_first(T.hp_wide_inputs(W, L, seed))
    assert n_band >= 3
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.HP_WIDE_KEYS]
    width = int(d["ivl"][n_band:, :, 1].max(initial=1))
    for split in ((n_band, classes, n_strand), (n_band, classes, 0)):
        got = dp_cuda.dp_last_row_hp(*args, width, *split)
        assert torch.equal(got.cpu(), dp_cuda.dp_last_row_hp(*(a.cpu() for a in args), width,
                                                             *split))


def test_band_hp_kernel_through_the_scorer(cuda):
    """torch_engine.score_wide under -h with a mixed batch on the card
    equals it on the CPU."""
    d, (n_band, classes, n_strand, width) = _band_first(T.hp_band_inputs(64, 5))
    rows = [torch.from_numpy(d[k]) for k in ("strand", "win_lo", "ivl", "s2chr", "lengths")]
    sms = np.stack([d["submat"], d["submat"]])
    got = {}
    for dev in (cuda, torch.device("cpu")):
        st = state_from_numpy(d["refs"], sms, dev, d["refchr"], d["hpcs"], d["pengop"])
        got[dev.type] = score_wide(st, width, n_band, classes, n_strand,
                                   *(r.to(dev) for r in rows)).cpu()
    assert torch.equal(got["cuda"], got["cpu"])


def test_band_hp_kernel_rejects_mixed_devices(cuda):
    d = T.hp_band_inputs(40, 6, copies=1)
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.HP_WIDE_KEYS]
    args[8] = args[8].cpu()
    with pytest.raises(ValueError):
        dp_cuda.dp_last_row_hp(*args, 0, len(d["lengths"]))


@pytest.mark.parametrize("L,seed,copies", [(40, 0, 2), (48, 1, 2), (256, 2, 2),
                                           (96, 3, 70)])
def test_band_kernel_matches_plain_on_edge_rows(cuda, L, seed, copies):
    """The plain band form (csrc/dp_band.cu) on testing.band_inputs' edge
    rows, 1, 2, 4 and 8 warps a row (with copies=70: 1,470 rows), the strand
    form (csrc/dp_strand.cu) taking the rows past 3,072 band columns in the
    same call: both equal their plain versions; one launch of each and
    none of the full form."""
    d, (n_band, classes, n_strand, width) = _band_first(T.band_inputs(L, seed, copies),
                                                        T.BAND_KEYS[2:])
    R = len(d["lengths"])
    assert all(classes) and n_strand == R - n_band > 0
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.BAND_KEYS]
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_strand(*args, width, n_band, classes, n_strand)
    torch.cuda.synchronize()
    assert (dp_cuda.last_row_band_launches, dp_cuda.last_row_strand_launches,
            dp_cuda.last_row_launches) == (1, 1, 0)
    assert dp_cuda.last_row_band_plain_calls == dp_cuda.last_row_strand_plain_calls == 0
    assert (dp_cuda.last_row_band_rows, dp_cuda.last_row_strand_rows,
            dp_cuda.last_row_rows) == (n_band, n_strand, 0)
    want = dp_cuda.dp_last_row_strand(*(a.cpu() for a in args), width, n_band, classes,
                                      n_strand)
    assert torch.equal(got.cpu(), want)
    # every row given to the band form, the rest on eight warps: those past
    # it marked (HIM, -1)
    got = dp_cuda.dp_last_row_strand(*args, 0, R, (*classes[:3], classes[3] + n_strand))
    assert torch.equal(got.cpu(), dp_torch.last_row_band_plain(*(a.cpu() for a in args)))
    assert (got[1] == -1).sum().item() == n_strand


@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_band_kernel_each_class_alone(cuda, warps):
    """The band rows of one warp class, 40 copies of testing.band_inputs'
    (several blocks), alone in a launch: equal to the plain version."""
    from mia_tpu_torch.core.entries import BAND_WARPS, band_columns, band_warps

    d = T.band_inputs(64, 7, copies=40)
    keep = band_warps(band_columns(d["ivl"])[1]) == warps
    d = {k: (v[keep] if k in T.BAND_KEYS[2:] else v) for k, v in d.items()}
    R = int(keep.sum())
    classes = tuple(R if w == warps else 0 for w in BAND_WARPS)
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.BAND_KEYS]
    got = dp_cuda.dp_last_row_strand(*args, 0, R, classes)
    assert torch.equal(got.cpu(), dp_torch.last_row_band_plain(*(a.cpu() for a in args)))


@pytest.mark.parametrize("L,seed,base", [(48, 0, 2000), (1, 1, 2000), (256, 2, 2000),
                                         (96, 3, 16569), (256, 4, 16569)])
def test_strand_kernel_matches_plain(cuda, L, seed, base):
    """The strand form (csrc/dp_strand.cu) on testing.strand_inputs' rows
    (whole strands in one and in 16 intervals, across the origin, ties in
    the wrap and in a repeat, no open column, a read of 1 base, past the
    state), on a 2,000-column strand and on a human-mt-sized one: equal to
    its plain version; one launch, no other form."""
    d = T.strand_inputs(L, seed, base=base)
    R = len(d["lengths"])
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.BAND_KEYS]
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_strand(*args, 0, 0, (), R)
    torch.cuda.synchronize()
    assert (dp_cuda.last_row_band_launches, dp_cuda.last_row_strand_launches,
            dp_cuda.last_row_launches) == (0, 1, 0)
    assert torch.equal(got.cpu(), dp_torch.last_row_strand_plain(*(a.cpu() for a in args)))


@pytest.mark.parametrize("L,seed,base", [(48, 0, 4000), (1, 1, 4000), (256, 2, 4000),
                                         (96, 3, 16569), (256, 4, 16569)])
def test_strand_hp_kernel_matches_plain(cuda, L, seed, base):
    """The -h strand form (csrc/dp_strand.cu's -h instantiation) on
    testing.hp_strand_inputs' rows (whole strands in one and in 16
    intervals, reference runs across a slice border and at a slice's first
    column, a source that is not open, a run longer than a slice with read
    runs of 31, 32 and 33, across the origin, a tie in the wrap, past the
    state, a read of 1 base, no open column), on a 4,000-column strand and
    on a human-mt-sized one: equal to its plain version; one launch, no
    other form."""
    d = T.hp_strand_inputs(L, seed, base=base)
    R = len(d["lengths"])
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.HP_WIDE_KEYS]
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_hp(*args, 0, 0, (), R)
    torch.cuda.synchronize()
    assert (dp_cuda.last_row_hp_band_launches, dp_cuda.last_row_hp_strand_launches,
            dp_cuda.last_row_hp_launches) == (0, 1, 0)
    assert torch.equal(got.cpu(),
                       dp_torch.last_row_hp_strand_plain(*(a.cpu() for a in args)))


def test_hp_kernels_on_a_call_of_every_form(cuda):
    """testing.mixed_hp_wide_inputs: -h band rows of all four classes,
    strand rows and full rows in one dp_last_row_hp call: equal to the call
    on the CPU; one launch of each form, no plain call."""
    d = T.mixed_hp_wide_inputs(64, 1)
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.HP_WIDE_KEYS]
    split = (d["width"], d["n_band"], d["band_classes"], d["n_strand"])
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_hp(*args, *split)
    torch.cuda.synchronize()
    assert (dp_cuda.last_row_hp_band_launches, dp_cuda.last_row_hp_strand_launches,
            dp_cuda.last_row_hp_launches) == (1, 1, 1)
    assert (dp_cuda.last_row_hp_band_plain_calls, dp_cuda.last_row_hp_strand_plain_calls,
            dp_cuda.last_row_hp_plain_calls) == (0, 0, 0)
    assert torch.equal(got.cpu(), dp_cuda.dp_last_row_hp(*(a.cpu() for a in args), *split))


def test_kernels_on_a_call_of_every_form(cuda):
    """testing.mixed_wide_inputs: band rows of all four classes, strand
    rows and full rows past 18,432 band columns in one call, as
    entries.wide_rows orders them: equal to the call on the CPU; one launch
    of each form."""
    d, (n_band, classes, n_strand, width) = _band_first(T.mixed_wide_inputs(64, 1),
                                                        T.BAND_KEYS[2:])
    assert all(classes) and n_strand and n_band + n_strand < len(d["lengths"])
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.BAND_KEYS]
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row_strand(*args, width, n_band, classes, n_strand)
    torch.cuda.synchronize()
    assert (dp_cuda.last_row_band_launches, dp_cuda.last_row_strand_launches,
            dp_cuda.last_row_launches) == (1, 1, 1)
    want = dp_cuda.dp_last_row_strand(*(a.cpu() for a in args), width, n_band, classes,
                                      n_strand)
    assert torch.equal(got.cpu(), want)


def test_band_kernel_through_the_scorer(cuda):
    """torch_engine.score_wide without -h, a mixed batch on the card equal
    to it on the CPU."""
    d, (n_band, classes, n_strand, width) = _band_first(T.band_inputs(64, 5),
                                                        T.BAND_KEYS[2:])
    rows = [torch.from_numpy(d[k]) for k in T.BAND_KEYS[2:]]
    sms = np.stack([d["submat"], d["submat"]])
    got = {}
    for dev in (cuda, torch.device("cpu")):
        st = state_from_numpy(d["refs"], sms, dev)
        got[dev.type] = score_wide(st, width, n_band, classes, n_strand,
                                   *(r.to(dev) for r in rows)).cpu()
    assert torch.equal(got["cuda"], got["cpu"])


def test_band_kernel_rejects_mixed_devices(cuda):
    d = T.band_inputs(40, 6, copies=1)
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.BAND_KEYS]
    args[4] = args[4].cpu()
    with pytest.raises(ValueError):
        dp_cuda.dp_last_row_strand(*args, 0, len(d["lengths"]))
    with pytest.raises(ValueError):
        dp_cuda.dp_last_row_strand(*args, 0, 0, (), len(d["lengths"]))


@pytest.mark.parametrize("B,W,L,seed", [(16, 300, 32, 0), (2048, 17024, 256, 1)])
def test_pileup_and_consensus_kernels_match_plain(cuda, B, W, L, seed):
    d = T.pileup_inputs(B, W, L, seed=seed)
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.PILEUP_KEYS]
    sharded.reset_counts()
    counts, scores = sharded.pileup_counts(*args, W)
    pc, ps = sharded._pileup_counts(*args, W)
    assert torch.equal(counts, pc) and torch.equal(scores, ps)
    assert torch.equal(sharded.consensus_call(counts, scores),
                       sharded.consensus_from_counts(counts, scores))
    tc, ts = (torch.from_numpy(a).to(cuda) for a in T.tie_counts(W, seed=seed))
    assert torch.equal(sharded.consensus_call(tc, ts), sharded.consensus_from_counts(tc, ts))
    assert (sharded.pileup_launches, sharded.pileup_plain_calls) == (1, 0)
    assert (sharded.consensus_launches, sharded.consensus_plain_calls) == (2, 0)


@pytest.mark.parametrize("n_parts", [1, 2, 4, 8, 32])
def test_consensus_kernel_sums_parts(cuda, n_parts):
    """The consensus call over n_parts partial accumulators against the
    plain version on the same parts: pileups, tie_counts cut into parts
    whose running sums wrap, parts whose own sums wrap; whole columns and
    slices at odd offsets."""
    W = 17024
    piles = [sharded._pileup_counts(*(torch.from_numpy(d[k]) for k in T.PILEUP_KEYS), W)
             for d in (T.pileup_inputs(256, W, 64, seed=s) for s in range(n_parts))]
    cases = [([c.numpy() for c, _ in piles], [s.numpy() for _, s in piles]),
             T.split_parts(*T.tie_counts(W, seed=n_parts), n_parts, seed=n_parts, big=True),
             T.wrapping_parts(W, n_parts, seed=n_parts)]
    sharded.reset_counts()
    calls = 0
    for counts, scores in cases:
        whole = ([torch.from_numpy(c).to(cuda) for c in counts],
                 [torch.from_numpy(x).to(cuda) for x in scores])
        for cols in (slice(0, W), slice(3, W - 2), slice(7, 8)):
            pc = [torch.from_numpy(np.ascontiguousarray(c[cols])).to(cuda) for c in counts]
            ps = [torch.from_numpy(np.ascontiguousarray(x[cols])).to(cuda) for x in scores]
            got = sharded.consensus_call(pc, ps)
            assert torch.equal(got, sharded.consensus_from_parts(pc, ps))
            # the same columns read in place from the whole parts
            assert torch.equal(sharded.consensus_call(*whole, cols), got)
            calls += 2
    assert (sharded.consensus_launches, sharded.consensus_plain_calls) == (calls, 0)


def test_step_sums_dp_inside_the_consensus_kernel(cuda):
    """dp = 4, sp = 2 on the card: no ATen add over any [*, 5] or [*, 4]
    accumulator is left in the step, two consensus launches, equal to one
    device."""
    s = T.step_inputs(64, 2000, 48, seed=11)
    sharded.reset_counts()
    got, ops = T.aten_ops(sharded.make_assembly_step(sharded.make_mesh(4, 2, [cuda] * 8)), *s)
    assert (sharded.consensus_launches, sharded.consensus_plain_calls) == (2, 0)
    assert not [op for op, shapes in ops if op.startswith("aten.add")
                and any(len(sh) == 2 and sh[1] in (4, 5) for sh in shapes)]
    want = sharded.make_assembly_step(sharded.make_mesh(1, 1, [cuda]))(*s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_pileup_kernel_on_edge_inputs(cuda, seed):
    """Every tile border, starts off both ends, lengths 0 and above L, a
    batch larger than a block's list, B of 0 and 1, sums that wrap
    (edge_pileup_inputs).  Codes outside 0..4 lie outside what the JAX
    package defines: there the kernel is held to the plain version's rule
    alone (such a base adds nothing)."""
    sharded.reset_counts()
    cases = T.edge_pileup_inputs(seed)
    for name, d, W, _ in cases:
        args = [torch.from_numpy(d[k]).to(cuda) for k in T.PILEUP_KEYS]
        counts, scores = sharded.pileup_counts(*args, W)
        pc, ps = sharded._pileup_counts(*args, W)
        assert torch.equal(counts, pc) and torch.equal(scores, ps), name
    assert (sharded.pileup_launches, sharded.pileup_plain_calls) == (len(cases), 0)


def test_pileup_kernel_twice_gives_equal_tensors(cuda):
    """Nothing is left over from a call: the kernel writes every sum, so a
    second call on the same reads (into memory the allocator may hand back
    dirty) and one after other reads give the same tensors."""
    d = T.pileup_inputs(2048, 17024, 256, seed=1)
    args = [torch.from_numpy(d[k]).to(cuda) for k in T.PILEUP_KEYS]
    first = [t.clone() for t in sharded.pileup_counts(*args, 17024)]
    torch.empty(9 * 17024, dtype=torch.int32, device=cuda).fill_(-1)
    other = T.pileup_inputs(2048, 17024, 256, seed=2)
    sharded.pileup_counts(*(torch.from_numpy(other[k]).to(cuda) for k in T.PILEUP_KEYS), 17024)
    second = sharded.pileup_counts(*args, 17024)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    pc, ps = sharded._pileup_counts(*args, 17024)
    assert torch.equal(second[0], pc) and torch.equal(second[1], ps)


def test_sharded_paths_on_one_card(cuda):
    """Four shards on the one card: the scorer, the consensus counts and
    the step equal their single-device forms."""
    d = T.random_entries(1000, 64, seed=8)
    entries = [d[k] for k in T.ENTRY_KEYS[2:]]
    res = []
    for devs in (None, [cuda] * 4):
        states = [state_from_numpy(d["refs"], d["sms"], dev) for dev in devs or [cuda]]
        sc = Pass1Scorer.from_state(states, d["len1"], batch=500)
        dp_cuda.reset_counts()
        res.append(sc.collect_entries(sc.dispatch_entries(*entries)))
        assert dp_cuda.kernel_launches == len(states) == dp_cuda.shards
    np.testing.assert_array_equal(res[0][0], res[1][0])
    np.testing.assert_array_equal(res[0][1], res[1][1])

    from mia_tpu_torch.core.columns import _record_arrays

    maln = T.random_records(3000, 4000, seed=9)
    _, spans, starts, revs, seq, smp, seq_off, smp_off = _record_arrays(maln, True)
    hook = (seq, smp, starts, spans, seq_off, smp_off, revs, maln.fpsm, maln.rpsm, 3000)
    one = consensus_torch.device_column_counts(*hook, device=cuda)
    four = consensus_torch.device_column_counts(*hook, devices=[cuda] * 4)
    for a, b in zip(one, four):
        np.testing.assert_array_equal(a, b)

    s = T.step_inputs(64, 2000, 48, seed=10)
    got = sharded.make_assembly_step(sharded.make_mesh(4, 2, [cuda] * 8))(*s)
    want = sharded.make_assembly_step(sharded.make_mesh(1, 1, [cuda]))(*s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
