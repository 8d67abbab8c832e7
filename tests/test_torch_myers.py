"""The port's Myers wavefront (mia_tpu_torch/ops/myers_torch.py) against the
JAX package: ``waves_plain`` must equal ``myers_jax._waves`` (found_d,
found_k and every history row) on the same seeded bitmaps, and
``myers_diff_torch`` must equal ``myers_diff_jax`` and the host
``myers_diff`` (distance and both backtrace strings), across the three
modes, IUPAC panels, maxd too small, identical, empty and completely
different sequences, tiny pairs whose distance exceeds a length, one
full-size mt311 pair, and the adversarial pairs of
``testing.edge_myers_pairs`` (the kernel's edges: lengths around its
8- and 16-base snake steps and padding, N runs, bitmap-0 characters,
snakes ending at either or both ends, maxd 1 and clipped, bitmaps past its
shared memory).
JAX runs on its CPU backend, as in tests/test_myers_jax.py.

Tolerance: exact equality.
"""
import numpy as np
import pytest
import torch

from mia_tpu.cli.ccheck import load_mt311
from mia_tpu.ops.myers import UINT_MAX, Mode, myers_diff
from mia_tpu.ops.myers_jax import _waves, myers_diff_jax
from mia_tpu_torch import testing as T
from mia_tpu_torch.ops import myers_cuda
from mia_tpu_torch.ops.myers import Mode as PortMode
from mia_tpu_torch.ops.myers_torch import _NEG, bitmaps, myers_diff_torch, waves_plain

CPU = torch.device("cpu")


def _both_waves(a, mode, b, maxd):
    """(JAX, plain) results of the waves for one pair, as numpy/ints."""
    bm_a, bm_b = bitmaps(a, b)
    maxd = min(maxd, len(a) + len(b))
    flags = dict(maxd=maxd, mode_is_prefix=mode == Mode.IS_PREFIX,
                 mode_has_prefix=mode == Mode.HAS_PREFIX)
    fd, fk, hist = _waves(bm_a.astype(np.int32), bm_b.astype(np.int32),
                          np.int32(len(a)), np.int32(len(b)), **flags)
    pd, pk, phist = waves_plain(torch.from_numpy(bm_a), torch.from_numpy(bm_b),
                                len(a), len(b), **flags)
    return (int(fd), int(fk), np.asarray(hist)), (pd, pk, phist.numpy())


def _pairs(mode):
    # one seed for both tests below, so the second reuses the JAX programs
    # the first compiled (one per shape and maxd)
    return [p for p in T.myers_pairs(seed=1) if p[1].name == mode.name]


@pytest.mark.parametrize("mode", list(Mode))
def test_waves_plain_matches_jax_waves(mode):
    checked = 0
    for a, _, b, maxd in _pairs(mode):
        if min(maxd, len(a) + len(b)) <= 0:
            continue
        (fd, fk, hist), (pd, pk, phist) = _both_waves(a, mode, b, maxd)
        assert (pd, pk) == (fd, fk), (a, b, maxd)
        assert phist.dtype == np.int32
        np.testing.assert_array_equal(phist, hist)
        checked += 1
    assert checked >= 12


@pytest.mark.parametrize("mode", list(Mode))
def test_myers_diff_torch_matches_jax_and_host(mode):
    outcomes = set()
    for a, _, b, maxd in _pairs(mode):
        want = myers_diff(a, mode, b, maxd)
        assert myers_diff_torch(a, PortMode[mode.name], b, maxd, device=CPU) == want, (a, b, maxd)
        assert myers_diff_jax(a, mode, b, maxd) == want, (a, b, maxd)
        outcomes.add(want[0] == UINT_MAX)
    assert outcomes == {True, False}


@pytest.mark.parametrize("a,b,maxd", [
    ("", "", 3), ("", "ACG", 5), ("RYN", "", 4), ("ACGTAA", "ACGTAA", 2),
    ("ACGT", "RCGW", 5), ("AAAA", "TTTT", 3), ("AC", "GGGTTTAC", 20),
    ("A" * 30, "C" * 30, 100), ("ACGT", "ACGT", 0),
])
def test_myers_diff_torch_edge_cases(a, b, maxd):
    for mode in Mode:
        want = myers_diff(a, mode, b, maxd)
        assert myers_diff_torch(a, PortMode[mode.name], b, maxd, device=CPU) == want
        assert myers_diff_jax(a, mode, b, maxd) == want


@pytest.mark.parametrize("mode", list(Mode))
def test_waves_plain_matches_jax_waves_on_edge_pairs(mode):
    """Whole history, exact; ``myers_diff_torch`` also against the host
    aligner on each pair."""
    names = []
    for name, a, pmode, b, maxd in T.edge_myers_pairs(seed=0):
        if pmode.name != mode.name or min(maxd, len(a) + len(b)) <= 0:
            continue
        (fd, fk, hist), (pd, pk, phist) = _both_waves(a, mode, b, maxd)
        assert (pd, pk) == (fd, fk), name
        np.testing.assert_array_equal(phist, hist, err_msg=name)
        assert myers_diff_torch(a, pmode, b, maxd, device=CPU) == myers_diff(a, mode, b, maxd), \
            name
        names.append(name)
    assert len(names) >= 10
    assert any(n.startswith("past_smem") for n in names) == (mode != Mode.IS_PREFIX)


def test_edge_myers_pairs_cover_their_cases():
    """Every (snake end, mode) combination, and bitmaps past the kernel's
    shared memory (227 KB) with a small maxd."""
    pairs = T.edge_myers_pairs(seed=0)
    combos = {(n.rsplit("_", 1)[0], m.name) for n, _, m, _, _ in pairs
              if n.startswith(("both", "end_"))}
    assert len(combos) == 9
    big = [(a, b, maxd) for n, a, _, b, maxd in pairs if n.startswith("past_smem")]
    assert big and all(myers_cuda.padded_len(len(a)) + myers_cuda.padded_len(len(b))
                       > 227 * 1024 and maxd <= 8 for a, b, maxd in big)
    lengths = {len(s) for _, a, _, b, _ in pairs for s in (a, b)}
    assert lengths >= {0, 1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65}


def test_padded_bitmaps():
    """The kernel's view of the bitmaps: each at a 16-byte boundary, at
    least SLACK zero bytes past its length."""
    for la, lb in ((0, 0), (1, 7), (8, 16), (17, 33), (40, 1)):
        bm_a, bm_b = (torch.from_numpy(x) for x in bitmaps("ACGTN" * la, "RYK" * lb))
        pa, pb = myers_cuda.padded_bitmaps(bm_a, bm_b, 5 * la, 3 * lb)
        for p, bm, n in ((pa, bm_a, 5 * la), (pb, bm_b, 3 * lb)):
            assert p.numel() == myers_cuda.padded_len(n) and p.numel() % 16 == 0
            assert p.numel() >= n + myers_cuda.SLACK
            assert torch.equal(p[:n], bm[:n]) and not p[n:].any()
        assert (pb.data_ptr() - pa.data_ptr()) % 16 == 0


def test_full_size_mt311_pair():
    """ccheck's own size: mt311 (16,619 columns, IUPAC) against an
    mt311-derived sample, maxd = max(len) / 10."""
    _, sample, _ = T.ccheck_sample(seed=0)
    panel = load_mt311()
    maxd = max(len(panel), len(sample)) // 10
    (fd, fk, hist), (pd, pk, phist) = _both_waves(panel, Mode.GLOBAL, sample, maxd)
    assert (pd, pk) == (fd, fk)
    assert 100 < pd < maxd
    np.testing.assert_array_equal(phist[: pd + 1], hist[: fd + 1])
    assert (phist[pd + 1 :] == _NEG).all()
    assert myers_diff_torch(panel, PortMode.GLOBAL, sample, maxd, device=CPU) == \
        myers_diff(panel, Mode.GLOBAL, sample, maxd)


def test_cpu_route_counts_plain_calls():
    myers_cuda.reset_counts()
    d, _, _ = myers_diff_torch("ACGTTGCA", PortMode.GLOBAL, "ACGTGCA", 4, device=CPU)
    assert d == 1
    assert (myers_cuda.plain_calls, myers_cuda.kernel_launches) == (1, 0)
    # maxd <= 0 answers before any wave runs
    myers_diff_torch("ACGT", PortMode.GLOBAL, "ACGT", 0, device=CPU)
    assert (myers_cuda.plain_calls, myers_cuda.kernel_launches) == (1, 0)


def test_waves_rejects_mixed_devices_and_bad_inputs():
    bm_a, bm_b = (torch.from_numpy(x) for x in bitmaps("ACGTA", "ACGA"))
    flags = dict(maxd=3, mode_is_prefix=False, mode_has_prefix=False)
    myers_cuda.reset_counts()
    with pytest.raises(ValueError, match="bm_b"):
        myers_cuda.waves(bm_a, bm_b.to("meta"), 5, 4, **flags)
    with pytest.raises(TypeError, match="bm_a"):
        myers_cuda.waves(bm_a.to(torch.int32), bm_b, 5, 4, **flags)
    with pytest.raises(ValueError, match="shape"):
        myers_cuda.waves(bm_a, bm_b, 6, 4, **flags)
    with pytest.raises(ValueError, match="maxd"):
        myers_cuda.waves(bm_a, bm_b, 5, 4, maxd=0, mode_is_prefix=False,
                         mode_has_prefix=False)
    with pytest.raises(ValueError, match="no kernel"):
        myers_cuda.waves(bm_a.to("meta"), bm_b.to("meta"), 5, 4, **flags)
    assert (myers_cuda.plain_calls, myers_cuda.kernel_launches) == (0, 0)


def test_myers_diff_torch_needs_a_device(monkeypatch):
    """Without a card and without MIA_TORCH_DEVICE=cpu the default device
    raises instead of dropping to the CPU."""
    monkeypatch.delenv("MIA_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        myers_diff_torch("ACGT", PortMode.GLOBAL, "ACGA", 3)
