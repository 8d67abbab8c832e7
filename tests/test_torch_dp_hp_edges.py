"""The plain PyTorch ``-h`` scorer on the adversarial batch
(mia_tpu_torch.testing.edge_hp_entries) against jax_engine._entries_core_hp
and the exact host DP (dp_numpy.solve_sg with hp rows and columns).

Every (band, length) class of the batch is here with one entry a class (the
kinds of read take turns from class to class and from seed to seed); the CUDA
tests and chip_smoke.py run all three kinds of every class on the card.

Tolerance: exact int32 equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mia_tpu.core import jax_engine as je
from mia_tpu_torch import testing as T
from mia_tpu_torch.ops import dp_torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The batches are small: one thread a worker, so that several workers
    on one machine do not spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(d):
    return {k: torch.from_numpy(np.ascontiguousarray(d[k])) for k in T.HP_ENTRY_KEYS}


def _jax_entries_hp(d):
    """jax_engine._entries_core_hp as the JAX engine ships it: intervals
    int16, b2i int32; one compile per batch shape and process."""
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


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_hp_entries_plain_matches_jax(seed):
    """The adversarial -h batch (runs of 1, 2, 31, 32 and 33 rows, windows
    that start inside a reference run or on its first column, the band and
    length edges of the plain scorer's batch): the plain version against
    jax_engine._entries_core_hp, exact."""
    d = T.edge_hp_entries(seed, per_class=1)
    got = _plain_hp(d)
    np.testing.assert_array_equal(got, _jax_entries_hp(d))
    t = _tensors(d)
    s2c = t["b2i"][t["s2chr"].long()].contiguous()
    plain = dp_torch.entries_core_plain(t["refs"], t["sms"], t["ref_sel"], t["starts"],
                                        t["ivl"], s2c, t["lengths"], t["smidx"]).numpy()
    assert (got[0] != plain[0]).sum() >= 20  # the -h candidates win cells


@pytest.mark.parametrize("part", [0, 1, 2])
def test_edge_hp_entries_plain_matches_solve_sg(part):
    """24 entries of the full batch that the host DP can score: picked
    first, then only those go through the plain version."""
    full = T.edge_hp_entries(2)

    def can_score(e):
        iv = full["ivl"][e]
        open_iv = iv[iv[:, 1] > iv[:, 0]]
        read = bytes(full["s2chr"][e, : max(int(full["lengths"][e]), 0)]).decode("latin-1")
        return (len(open_iv) > 0 and open_iv[:, 0].min() >= 2
                and full["starts"][e] + je.WIN_W <= full["len1"]
                and 2 <= full["lengths"][e] <= je.L_MAX and not je.hp_routes_to_host(read))

    picked = [e for e in range(len(full["lengths"])) if can_score(e)][part::3][:24]
    assert len(picked) >= 16
    d = T.take_entries(full, picked)
    got = _plain_hp(d)
    for e in range(len(picked)):
        assert T.solve_sg_entry(d, e) == (got[0, e], got[1, e]), picked[e]
