"""The plain PyTorch pileup counts (parallel.sharded._pileup_counts) on the
adversarial inputs of mia_tpu_torch.testing.edge_pileup_inputs against
mia_tpu.parallel.sharded._pileup_counts, and the wrapper's routing of CPU
tensors.

Tolerance: exact int32 equality (sums that wrap included).  Codes outside
0..4 lie outside what the JAX package defines (its one-hot drops the count
but its gather still scores): that case holds the wrapper to the plain
version's stated rule only (such a base adds nothing), as the CUDA tests do
for the kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mia_tpu.parallel import sharded as jsharded
from mia_tpu_torch import testing as T
from mia_tpu_torch.parallel import sharded

NAMES = ["borders", "tile128", "one_column", "B0", "B1", "long_list", "wrap", "bad_codes"]


def _case(name):
    cases = {n: (d, W, ok) for n, d, W, ok in T.edge_pileup_inputs(5)}
    assert list(cases) == NAMES
    return cases[name]


@pytest.mark.parametrize("name", NAMES)
def test_edge_pileup_plain_matches_jax(name):
    d, W, in_range = _case(name)
    args = [torch.from_numpy(d[k]) for k in T.PILEUP_KEYS]
    sharded.reset_counts()
    counts, scores = sharded.pileup_counts(*args, W)
    assert (sharded.pileup_plain_calls, sharded.pileup_launches) == (1, 0)
    assert counts.dtype == scores.dtype == torch.int32
    assert counts.shape == (W, 5) and scores.shape == (W, 4)
    if in_range:
        wc, ws = jsharded._pileup_counts(*(jnp.asarray(d[k]) for k in T.PILEUP_KEYS), W)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(wc))
        np.testing.assert_array_equal(scores.numpy(), np.asarray(ws))
        return
    # codes outside 0..4: equal to the same reads with those bases cut out
    # by a length of their own (a base per read, so that nothing else moves)
    L = d["s2c"].shape[1]
    keep = (d["s2c"] >= 0) & (d["s2c"] <= 4)
    assert not keep.all()
    rows = np.arange(L)[None, :]
    flat = dict(d, s2c=np.where(keep, d["s2c"], 0).reshape(-1, 1),
                depths=d["depths"].reshape(-1, 1),
                starts=(d["starts"][:, None] + rows).reshape(-1).astype(np.int32),
                lengths=(keep & (rows < d["lengths"][:, None])).reshape(-1).astype(np.int32),
                strands=np.repeat(d["strands"], L))
    wc, ws = jsharded._pileup_counts(*(jnp.asarray(flat[k]) for k in T.PILEUP_KEYS), W)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(ws))


def test_edge_pileup_cases_reach_their_edges():
    """The cases hold what they claim: sums that wrap, a batch larger than
    a block's list, reads on both sides of every tile border."""
    d, W, _ = _case("wrap")
    args = [torch.from_numpy(d[k]) for k in T.PILEUP_KEYS]
    _, scores = sharded._pileup_counts(*args, W)
    exact = np.zeros((W, 4), np.int64)
    for b in range(len(d["lengths"])):
        for r in range(int(d["lengths"][b])):
            col = int(d["starts"][b]) + r
            if 0 <= col < W:
                psm = d["rpsm"] if d["strands"][b] else d["fpsm"]
                exact[col] += psm[d["depths"][b, r], :4, d["s2c"][b, r]]
    assert (np.abs(exact) >= 2**31).any()
    np.testing.assert_array_equal(scores.numpy(), exact.astype(np.int32))
    assert _case("long_list")[0]["s2c"].shape[0] > sharded.PILEUP_ROUND
    d, W, _ = _case("tile128")
    ends = d["starts"].astype(np.int64) + d["lengths"]
    for border in range(sharded.PILEUP_TILE, W, sharded.PILEUP_TILE):
        assert ((d["starts"] < border) & (ends > border)).any()
