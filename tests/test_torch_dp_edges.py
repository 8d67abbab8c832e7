"""The plain PyTorch entry scorer on the adversarial batch
(mia_tpu_torch.testing.edge_entries) against jax_engine._entries_core and
the exact host DP (dp_numpy.solve_sg).

Every (band, length) class of the batch is here with one entry a class (the
kinds of read take turns from class to class and from seed to seed); the CUDA
tests and chip_smoke.py run all three kinds of every class on the card.

Tolerance: exact int32 equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mia_tpu.constants import HIM
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


def _jax_entries(d):
    """jax_engine._entries_core as the JAX engine ships it: read codes
    nibble-packed, intervals int16, the scan scorer (use_pallas=False); one
    compile per batch shape and process (_plain_fn caches the program)."""
    s2c = d["s2c"].astype(np.uint8)
    packed = s2c[:, 0::2] | (s2c[:, 1::2] << 4)
    out = je._plain_fn(False, je.BLOCK_B)(
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


def _oracle_can_score(d, e):
    """The exact host DP scores over the whole strand: it sees what the
    window sees only for bands from column 2 on, windows inside the
    reference and reads of 2..L rows."""
    iv = d["ivl"][e]
    open_iv = iv[iv[:, 1] > iv[:, 0]]
    return (len(open_iv) > 0 and open_iv[:, 0].min() >= 2
            and d["starts"][e] + je.WIN_W <= d["len1"]
            and 2 <= d["lengths"][e] <= je.L_MAX)


def test_edge_batch_keeps_every_class():
    """One entry a class still holds every band shape with every length,
    and the two seeds differ in the kind of read of each class."""
    full = T._edge_layout()
    one = [T._edge_layout(1, turn) for turn in (0, 1)]
    classes = {(b, int(n)) for b, n in zip(full[0], full[1])}
    assert len(classes) == len(T._EDGE_BANDS) * len(T._EDGE_LENGTHS)
    for bands, lengths, kinds in one:
        assert {(b, int(n)) for b, n in zip(bands, lengths)} == classes
        assert len(bands) == len(classes) and set(kinds) == {0, 1, 2}
    assert (one[0][2] != one[1][2]).all()
    d = T.edge_entries(0, per_class=1)
    sub = T.take_entries(d, [3, 5])
    np.testing.assert_array_equal(sub["s2c"], d["s2c"][[3, 5]])
    assert sub["refs"] is d["refs"] and len(sub["lengths"]) == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_entries_plain_matches_jax(seed):
    """The adversarial batch (closed windows, one-column bands, lane-sized
    intervals, column 0, 16 intervals, the shortest and longest reads, ties):
    the plain version against jax_engine._entries_core, exact."""
    d = T.edge_entries(seed, per_class=1)
    got = _plain_entries(d)
    np.testing.assert_array_equal(got, _jax_entries(d))
    closed = (d["ivl"][:, :, 1] <= d["ivl"][:, :, 0]).all(axis=1)
    assert closed.any() and (got[0, closed] == HIM).all() and (got[1, closed] == 0).all()
    assert (got[0, ~closed] > HIM).all()


@pytest.mark.parametrize("part", [0, 1, 2])
def test_edge_entries_plain_matches_solve_sg(part):
    """24 entries of the full batch that the host DP can score: picked
    first, then only those go through the plain version."""
    full = T.edge_entries(2)
    picked = [e for e in range(len(full["lengths"]))
              if _oracle_can_score(full, e)][part::3][:24]
    assert len(picked) >= 16
    d = T.take_entries(full, picked)
    got = _plain_entries(d)
    for e in range(len(picked)):
        assert T.solve_sg_entry(d, e) == (got[0, e], got[1, e]), picked[e]
