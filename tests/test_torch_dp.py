"""The port's plain PyTorch DP scorer (mia_tpu_torch.ops.dp_torch) against
the JAX package's scan scorer (mia_tpu.ops.dp_jax) and its XLA entry program
(jax_engine._entries_core without Pallas, as the JAX package runs it on the
CPU), and against the exact host DP (dp_numpy.solve_sg).

Tolerance: exact int32 equality.  Both versions do the same integer
arithmetic with the same sentinels, so any difference is a fault.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mia_tpu.constants import HIM
from mia_tpu.core import jax_engine as je
from mia_tpu.ops import dp_jax
from mia_tpu_torch import testing as T
from mia_tpu_torch.ops import dp_cuda, dp_torch

B, L = 16, 32


def _scan_inputs(W, seed):
    """[B, W] codes, masks of random intervals, per-row scores, lengths
    (including 1, L and a length past L, which keeps row 0)."""
    rng = np.random.default_rng(seed)
    s1c = rng.integers(0, 5, (B, W)).astype(np.int32)
    mask = np.zeros((B, W), bool)
    for b in range(B):
        for _ in range(int(rng.integers(0, 4))):
            lo = int(rng.integers(0, W))
            mask[b, lo : int(rng.integers(lo, W + 1))] = True
    mask[0] = True
    mask[1] = False
    row_sm = rng.integers(-700, 300, (B, L, 5)).astype(np.int32)
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    lengths[2], lengths[3], lengths[4] = 1, L, L + 3
    return s1c, mask, row_sm, lengths


@pytest.mark.parametrize("W", [64, 384])
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_last_row_rowsm_matches_jax(W, seed):
    s1c, mask, row_sm, lengths = _scan_inputs(W, seed)
    want = np.asarray(dp_jax.batch_last_row_rowsm(
        jnp.asarray(s1c), jnp.asarray(mask), jnp.asarray(row_sm),
        jnp.asarray(lengths)))
    got = dp_torch.batch_last_row_rowsm(
        torch.from_numpy(s1c), torch.from_numpy(mask), torch.from_numpy(row_sm),
        torch.from_numpy(lengths)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("Ld", [L, 256])
def test_depths_for_matches_jax(Ld):
    lengths = np.array([1, 5, 15, 16, 29, 30, 31, 60, 256, 300], np.int32)
    want = dp_jax.depths_for(lengths, Ld)
    got = dp_torch.depths_for(torch.from_numpy(lengths), Ld).numpy()
    np.testing.assert_array_equal(got, want)


def test_best_and_aec_takes_earliest_tie():
    rows = np.array([[1, 7, 3, 7, 7], [-5, -5, -5, -5, -5], [0, 0, 9, 2, 9]], np.int32)
    wb, wa = dp_jax.batch_best_and_aec(jnp.asarray(rows))
    gb, ga = dp_torch.batch_best_and_aec(torch.from_numpy(rows))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(ga.numpy(), [1, 0, 2])


def _jax_entries(d):
    """jax_engine._entries_core as the JAX engine ships it: read codes
    nibble-packed, intervals int16, the scan scorer (use_pallas=False)."""
    s2c = d["s2c"].astype(np.uint8)
    packed = s2c[:, 0::2] | (s2c[:, 1::2] << 4)
    fn = je._plain_fn(False, je.BLOCK_B)
    out = fn(
        jnp.asarray(d["refs"]), jnp.asarray(d["ref_sel"]), jnp.asarray(d["starts"]),
        jnp.asarray(d["ivl"].astype(np.int16)), jnp.asarray(packed),
        jnp.asarray(d["lengths"]), jnp.asarray(d["smidx"]),
        jnp.zeros(1, jnp.int32), jnp.asarray(d["sms"]),
    )
    return np.asarray(out)


def _plain_entries(d):
    return dp_torch.entries_core_plain(
        *(torch.from_numpy(d[k]) for k in T.ENTRY_KEYS)
    ).numpy()


ENTRY_CASES = ["mixed", "length_one", "all_masked", "ties", "sixteen_intervals",
               "smidx_rc"]


def _case(name, seed):
    d = T.random_entries(B, L, seed=seed)
    kind = np.arange(B) % 6
    if name == "length_one":
        d["lengths"][:] = 1
    elif name == "all_masked":
        d["ivl"][:] = 0
    elif name == "ties":
        # every entry a homopolymer read in the reference's homopolymer stretch
        d["starts"][:] = d["starts"][kind == 4][0]
        d["s2c"][:] = 0
        d["ivl"][:] = 0
        d["ivl"][:, 0] = (0, je.WIN_W)
    elif name == "sixteen_intervals":
        d["ivl"][:] = d["ivl"][kind == 1][0]
    elif name == "smidx_rc":
        d["smidx"][:] = 1
    return d


@pytest.mark.parametrize("name", ENTRY_CASES)
def test_entries_core_plain_matches_jax(name):
    d = _case(name, seed=ENTRY_CASES.index(name))
    got = _plain_entries(d)
    np.testing.assert_array_equal(got, _jax_entries(d))
    if name == "all_masked":
        assert (got[0] == HIM).all() and (got[1] == 0).all()
    if name == "ties":
        # homopolymer against homopolymer: every full diagonal scores the
        # same, so the earliest one (ending at column len-1) is reported
        np.testing.assert_array_equal(got[1], d["lengths"] - 1)


@pytest.mark.parametrize("seed", [3, 4])
def test_entries_core_plain_matches_solve_sg(seed):
    d = T.oracle_entries(8, L, seed=seed)
    got = _plain_entries(d)
    for e in range(8):
        assert T.solve_sg_entry(d, e) == (got[0, e], got[1, e]), e


def test_dp_entries_routes_cpu_tensors_to_plain():
    d = T.random_entries(B, L, seed=9)
    args = [torch.from_numpy(d[k]) for k in T.ENTRY_KEYS]
    dp_cuda.reset_counts()
    out = dp_cuda.dp_entries(*args)
    assert (dp_cuda.plain_calls, dp_cuda.kernel_launches) == (1, 0)
    np.testing.assert_array_equal(out.numpy(), _plain_entries(d))


@pytest.mark.parametrize("bad", ["dtype", "shape", "rows"])
def test_dp_entries_rejects_bad_inputs(bad):
    d = T.random_entries(B, L, seed=10)
    if bad == "dtype":
        d["starts"] = d["starts"].astype(np.int64)
        err = TypeError
    elif bad == "shape":
        d["ivl"] = d["ivl"][:, :8]
        err = ValueError
    else:
        d["s2c"] = np.zeros((B, 300), np.int8)
        err = ValueError
    with pytest.raises(err):
        dp_cuda.dp_entries(*(torch.from_numpy(np.ascontiguousarray(d[k]))
                             for k in T.ENTRY_KEYS))


@pytest.mark.parametrize("W", [64, 384])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("sg5", [True, False])
def test_batch_last_row_matches_jax(W, shared, sg5):
    """The general form (any width, shared or per-read reference, one PSSM):
    dp_jax.batch_last_row on the inputs of the JAX package's Pallas test
    (banded and open masks), the whole [B, W] row, sentinels included."""
    from mia_tpu.ops.dp_pallas import make_row_sm

    d = T.last_row_inputs(B, W, L, seed=W + shared, shared=shared)
    np.testing.assert_array_equal(d["depths"], dp_jax.depths_for(d["lengths"], L))
    want = np.asarray(dp_jax.batch_last_row(
        *(jnp.asarray(d[k]) for k in T.LAST_ROW_KEYS), sg5=sg5))
    args = [torch.from_numpy(d[k]) for k in T.LAST_ROW_KEYS]
    got = dp_torch.batch_last_row(*args, sg5=sg5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == HIM).any() and (want[0] != HIM).all()
    # the same rows from precomputed per-row scores, as the Pallas kernel takes them
    row_sm = dp_torch.make_row_sm(args[5], args[2], args[4])
    np.testing.assert_array_equal(
        row_sm.numpy(), make_row_sm(d["submat"], d["s2c"], d["depths"]))
    s1c2d = args[0] if not shared else args[0][None, :].expand(B, W)
    np.testing.assert_array_equal(
        dp_torch.batch_last_row_rowsm(s1c2d, args[1], row_sm, args[3], sg5=sg5).numpy(),
        want)
    # the wrapper on the CPU takes the plain version, and counts it
    dp_cuda.reset_counts()
    assert torch.equal(dp_cuda.dp_last_row(*args, sg5=sg5), got)
    assert (dp_cuda.last_row_plain_calls, dp_cuda.last_row_launches) == (1, 0)


def test_dp_last_row_rejects_what_the_kernel_does_not_take():
    d = T.last_row_inputs(4, 64, 8, seed=3)
    args = [torch.from_numpy(d[k]) for k in T.LAST_ROW_KEYS]
    dp_cuda.reset_counts()
    with pytest.raises(ValueError, match="no kernel"):
        dp_cuda.dp_last_row(*(a.to("meta") for a in args))
    with pytest.raises(TypeError, match="s2c"):
        dp_cuda._last_row(args[0], args[1], args[2].to(torch.int64), args[3], args[4],
                          args[5], True)
    with pytest.raises(ValueError, match="s1c"):
        dp_cuda._last_row(args[0], args[1][:, :32], args[2], args[3], args[4], args[5],
                          True)
    assert (dp_cuda.last_row_plain_calls, dp_cuda.last_row_launches) == (0, 0)
