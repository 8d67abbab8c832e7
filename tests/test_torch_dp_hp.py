"""The port's ``-h`` scorer against the JAX package's: the plain PyTorch
homopolymer DP (mia_tpu_torch.ops.dp_torch.batch_last_row_hp,
entries_core_hp_plain) against dp_jax.batch_last_row_hp and
jax_engine._entries_core_hp (through _plain_fn_hp, JAX's CPU backend),
against the exact host DP (dp_numpy.solve_sg with hp rows and columns), and
the port's -h Pass1Scorer against a JAX Pass1Scorer(hp_seqs=...) on the
same state.

Tolerance: exact int32 equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mia_tpu.core import jax_engine as je
from mia_tpu.ops import dp_jax
from mia_tpu.utils.encoding import pop_hpl_and_hps
from mia_tpu_torch import testing as T
from mia_tpu_torch.core import torch_engine as te
from mia_tpu_torch.ops import dp_cuda, dp_torch

B = 16


def _tensors(d):
    return {k: torch.from_numpy(np.ascontiguousarray(d[k])) for k in T.HP_ENTRY_KEYS}


def _scan_inputs(d):
    """batch_last_row_hp's inputs for a batch of -h entries, as
    _entries_core_hp builds them: numpy arrays."""
    t = _tensors(d)
    idx, maskw = dp_torch._windows(t["refs"], t["ref_sel"], t["starts"], t["ivl"])
    flat = idx.reshape(-1)

    def gather(a):
        return a.reshape(-1)[flat].reshape(idx.shape).to(torch.int32).numpy()

    s2c = t["b2i"][t["s2chr"].long()]
    row_sm = dp_torch._row_scores(t["sms"], t["smidx"], t["lengths"], s2c)
    return dict(s1c=gather(t["refs"]), s1chr=gather(t["refchr"]), mask=maskw.numpy(),
                row_sm=row_sm.numpy(), lengths=d["lengths"],
                s2chr=d["s2chr"].astype(np.int32), hpcs_w=gather(t["hpcs"]),
                ws=d["starts"], pengop=d["pengop"])


SCAN_ARGS = ("s1c", "s1chr", "mask", "row_sm", "lengths", "s2chr", "hpcs_w", "ws",
             "pengop")


@pytest.mark.parametrize("L", [32, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_last_row_hp_matches_jax(seed, L):
    a = _scan_inputs(T.random_hp_entries(B, L, seed=seed))
    want = np.asarray(dp_jax.batch_last_row_hp(*(jnp.asarray(a[k]) for k in SCAN_ARGS)))
    got = dp_torch.batch_last_row_hp(*(torch.from_numpy(np.ascontiguousarray(a[k]))
                                       for k in SCAN_ARGS)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _jax_entries_hp(d):
    """jax_engine._entries_core_hp as the JAX engine ships it: intervals
    int16, b2i int32."""
    out = je._plain_fn_hp()(
        jnp.asarray(d["refs"]), jnp.asarray(d["refchr"]), jnp.asarray(d["hpcs"]),
        jnp.asarray(d["b2i"].astype(np.int32)), jnp.asarray(d["pengop"]),
        jnp.asarray(d["ref_sel"]), jnp.asarray(d["starts"]),
        jnp.asarray(d["ivl"].astype(np.int16)), jnp.asarray(d["s2chr"]),
        jnp.asarray(d["lengths"]), jnp.asarray(d["smidx"]), jnp.asarray(d["sms"]),
    )
    return np.asarray(out)


def _plain_hp(d):
    return dp_torch.entries_core_hp_plain(*_tensors(d).values()).numpy()


@pytest.mark.parametrize("L", [32, 256])
@pytest.mark.parametrize("seed", [2, 3])
def test_entries_core_hp_plain_matches_jax(seed, L):
    d = T.random_hp_entries(B, L, seed=seed)
    np.testing.assert_array_equal(_plain_hp(d), _jax_entries_hp(d))


def test_hp_batches_exercise_the_homopolymer_candidates():
    """The test batches hold runs of 32+ bases (past the TPU ring's reach)
    in reads and reference, and -h changes the score of many entries."""
    d = T.random_hp_entries(48, 256, seed=4)
    reads = [bytes(d["s2chr"][e, : d["lengths"][e]]).decode() for e in range(48)]
    assert sum(je.hp_routes_to_host(r) for r in reads) >= 8
    assert pop_hpl_and_hps(bytes(d["refchr"][0, : d["len1"]]).decode())[0].max() >= 32
    t = _tensors(d)
    s2c = t["b2i"][t["s2chr"].long()].contiguous()
    plain = dp_torch.entries_core_plain(t["refs"], t["sms"], t["ref_sel"], t["starts"],
                                        t["ivl"], s2c, t["lengths"], t["smidx"]).numpy()
    hp = _plain_hp(d)
    assert (hp[0] != plain[0]).sum() >= 10
    assert (hp[0] >= plain[0]).all()  # discounted gaps only add candidates


@pytest.mark.parametrize("seed", [5, 6])
def test_entries_core_hp_plain_matches_solve_sg(seed):
    d = T.oracle_hp_entries(8, 64, seed=seed)
    got = _plain_hp(d)
    for e in range(8):
        assert T.solve_sg_entry(d, e) == (got[0, e], got[1, e]), e


def test_read_runs_match_pop_hpl_and_hps():
    d = T.random_hp_entries(B, 64, seed=7)
    hprs, hprl = dp_torch.read_runs(torch.from_numpy(d["s2chr"].astype(np.int32)))
    for e in range(B):
        hpl, hps = pop_hpl_and_hps(bytes(d["s2chr"][e]).decode("latin-1"))
        np.testing.assert_array_equal(hprs[e].numpy(), hps)
        np.testing.assert_array_equal(hprl[e].numpy(), hpl)


def test_dp_entries_hp_routes_cpu_tensors_to_plain():
    d = T.random_hp_entries(B, 32, seed=8)
    dp_cuda.reset_counts()
    out = dp_cuda.dp_entries_hp(*_tensors(d).values())
    assert (dp_cuda.hp_plain_calls, dp_cuda.hp_kernel_launches) == (1, 0)
    assert (dp_cuda.plain_calls, dp_cuda.kernel_launches) == (0, 0)
    np.testing.assert_array_equal(out.numpy(), _plain_hp(d))


@pytest.mark.parametrize("bad", ["codes_for_chars", "hpcs_shape", "pengop", "b2i"])
def test_dp_entries_hp_rejects_bad_inputs(bad):
    d = T.random_hp_entries(B, 32, seed=9)
    if bad == "codes_for_chars":
        d["s2chr"] = d["s2chr"].astype(np.int8)
        err = TypeError
    elif bad == "hpcs_shape":
        d["hpcs"] = d["hpcs"][:, :-1]
        err = ValueError
    elif bad == "pengop":
        d["pengop"] = d["pengop"][:10]
        err = ValueError
    else:
        d["b2i"] = d["b2i"].astype(np.int32)
        err = TypeError
    with pytest.raises(err):
        dp_cuda.dp_entries_hp(*_tensors(d).values())


LEN1 = 2400


def _hp_scorers(seed):
    d = T.random_hp_entries(4, 32, seed=seed, len1=LEN1)
    fw = bytes(d["refchr"][0, :LEN1]).decode()
    rc = bytes(d["refchr"][1, :LEN1]).decode()
    sms = d["sms"]
    jsc = je.Pass1Scorer(d["refs"][0], d["refs"][1], LEN1, sms[0], sms[1], warm=False,
                         batch=32, hp_seqs=(fw, rc))
    tsc = te.Pass1Scorer.from_state(
        te.state_from_numpy(jsc._refs_np, jsc._sms_np, "cpu", jsc._refchr_np,
                            jsc._hpcs_np, jsc._pengop_np),
        LEN1, batch=32,
    )
    return jsc, tsc, (fw, rc)


def test_hp_state_matches_jax_scorer():
    jsc, tsc, seqs = _hp_scorers(10)
    refchr, hpcs, pengop = te.hp_state_numpy(seqs, LEN1, jsc.WTOT)
    np.testing.assert_array_equal(refchr, jsc._refchr_np)
    np.testing.assert_array_equal(hpcs, jsc._hpcs_np)
    np.testing.assert_array_equal(pengop, jsc._pengop_np)
    sc = te.Pass1Scorer(jsc._refs_np[0], jsc._refs_np[1], LEN1, jsc._sms_np[0],
                        jsc._sms_np[1], batch=8, device="cpu", hp_seqs=seqs)
    assert sc.hp and tsc.hp
    for a, b in zip((sc.state.refchr, sc.state.hpcs, sc.state.pengop),
                    (tsc.state.refchr, tsc.state.hpcs, tsc.state.pengop)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed,n", [(11, 64), (12, 23)])
def test_hp_scorer_entries_match_jax_scorer(seed, n):
    jsc, tsc, _ = _hp_scorers(seed)
    d = T.random_hp_entries(n, je.L_MAX, seed=seed + 50, len1=LEN1)
    ents = [d[k] for k in ("ref_sel", "starts", "ivl", "s2chr", "lengths", "smidx")]
    ents[3] = d["s2chr"][:, :200]  # narrower than L_MAX: the scorer pads with 0
    want = jsc.collect_entries(jsc.dispatch_entries(*ents))
    dp_cuda.reset_counts()
    got = tsc.collect_entries(tsc.dispatch_entries(*ents))
    assert (dp_cuda.hp_plain_calls, dp_cuda.plain_calls) == (1, 0)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_hp_scorer_packed_batch_matches_jax_scorer():
    jsc, tsc, _ = _hp_scorers(13)
    n = 32
    rng = np.random.default_rng(13)
    d = T.random_hp_entries(n, je.L_MAX, seed=14, len1=LEN1)
    lens = rng.integers(20, 100, n).astype(np.int32)
    fw_ws = rng.integers(0, LEN1 - je.WIN_W, n).astype(np.int32)
    rc_ws = rng.integers(0, LEN1 - je.WIN_W, n).astype(np.int32)
    fw_ivg = np.zeros((n, je.MAX_INTERVALS, 2), np.int32)
    rc_ivg = np.zeros((n, je.MAX_INTERVALS, 2), np.int32)
    fw_ivg[:, 0, 0], fw_ivg[:, 0, 1] = fw_ws + 2, fw_ws + 300
    rc_ivg[:, 0, 0], rc_ivg[:, 0, 1] = rc_ws + 5, rc_ws + je.WIN_W
    flags = np.zeros(n, np.int32)
    flags[::5] = 4  # FLAG_WIDE
    args = (d["s2chr"], lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags)
    want = jsc.collect_arrays(jsc.dispatch_packed(*args))
    got = tsc.collect_arrays(tsc.dispatch_packed(*args))
    # the windowed reads as mia_tpu's scorer scores them; its WIDE reads'
    # entries are empty (mia_tpu leaves them to the native solve), and the
    # port scores them full width, each strand as dp_jax.batch_last_row_hp
    # on the strand's window (tests/test_torch_wide_pass1_hp.py)
    from mia_tpu_torch.core import entries

    from .test_torch_wide_pass1_hp import _dense

    wide = (flags & 4) != 0
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[~wide], w[~wide])
    rows = entries.wide_rows(flags, lens, d["s2chr"], fw_ivg, rc_ivg, hp=True)
    st = tsc.state
    last = np.asarray(dp_jax.batch_last_row_hp(**_dense(dict(
        refs=st.refs.numpy(), refchr=st.refchr.numpy(), hpcs=st.hpcs.numpy(),
        submat=st.sms[0].numpy(), pengop=st.pengop.numpy(), b2i=st.b2i.numpy(),
        strand=rows.strand, win_lo=rows.win_lo, ivl=rows.ivl, s2chr=rows.s2c,
        lengths=rows.lengths, width=rows.width))))
    jb, ja = (np.asarray(x) for x in dp_jax.batch_best_and_aec(last))
    fb, fa, rb, ra = got
    assert rows.n == 2 * wide.sum()
    for r in range(rows.n):
        b, a = (fb, fa) if rows.strand[r] == 0 else (rb, ra)
        i = rows.read[r]
        assert (b[i], a[i]) == (jb[r], ja[r] + rows.win_lo[r]), r
