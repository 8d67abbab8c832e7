"""The plain PyTorch general-width scorer (dp_torch.batch_last_row) on the
adversarial inputs of mia_tpu_torch.testing.edge_last_row_inputs against
mia_tpu.ops.dp_jax.batch_last_row, the reference the JAX package's own tests
hold its Pallas kernel to (they skip interpret mode), and the wrapper's
routing of CPU tensors.

Tolerance: exact int32 equality, the whole [B, W] row, sentinels included.
Lengths of 0 and of L + 1 are in: both versions keep row 0 for them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mia_tpu.constants import HIM
from mia_tpu.ops import dp_jax
from mia_tpu_torch import testing as T
from mia_tpu_torch.ops import dp_cuda, dp_torch

WIDTHS = ["W1", "W2", "W3", "W31", "W32", "W33", "W100", "W400"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small batches: one thread a worker, so that several workers on one
    machine do not spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("name", WIDTHS)
def test_edge_last_rows_plain_matches_jax(name, shared):
    cases = {n: (d, sg5) for n, d, sg5 in T.edge_last_row_inputs(3, shared)}
    assert list(cases) == WIDTHS
    d, sg5 = cases[name]
    want = np.asarray(dp_jax.batch_last_row(
        *(jnp.asarray(d[k]) for k in T.LAST_ROW_KEYS), sg5=sg5))
    args = [torch.from_numpy(d[k]) for k in T.LAST_ROW_KEYS]
    dp_cuda.reset_counts()
    got = dp_cuda.dp_last_row(*args, sg5=sg5)
    assert (dp_cuda.last_row_plain_calls, dp_cuda.last_row_launches,
            dp_cuda.last_row_wide_launches) == (1, 0, 0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, dp_torch.batch_last_row(*args, sg5=sg5))
    # a closed column holds HIM in every row; the closed row nothing else
    assert (want[~d["mask"]] == HIM).all() and (want[1] == HIM).all()
    assert (want[d["mask"]] > HIM).all()


def test_edge_last_row_cases_cover_the_kernel_layout():
    """The cases reach what they claim: every thread border of the register
    form inside a band, lengths on both sides of the row bound, both sg5
    settings, and a wide case past two warp borders."""
    C = dp_cuda.LAST_ROW_COLS
    cases = T.edge_last_row_inputs(0, True, wide=True)
    assert {sg5 for _, _, sg5 in cases} == {True, False}
    name, d, _ = cases[-1]
    W = d["mask"].shape[1]
    assert name == "W2300" and W > 2 * 32 * C
    for border in range(C, W, C):
        assert d["mask"][5, border - 1] and d["mask"][5, border]
        assert not d["mask"][15, border - 1]
    L = d["s2c"].shape[1]
    assert {0, 1, 2, L, L + 1} <= set(d["lengths"].tolist())
    assert W % C and 400 % C and 100 % C
