"""The port's scorer (mia_tpu_torch.core.torch_engine.Pass1Scorer) against
the JAX package's (mia_tpu.core.jax_engine.Pass1Scorer, CPU backend), fed
the same state and the same entries; plus the port's device selection,
kernel build keying, and a run with jax unimportable.

Tolerance: exact equality of (best, aec).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mia_tpu.core import jax_engine as je
from mia_tpu.ops import dp_jax
from mia_tpu.ops.pssm import init_flatsubmat
from mia_tpu_torch.core import entries
from mia_tpu_torch.core import torch_engine as te
from mia_tpu_torch.utils import torchcfg

from .conftest import FIXTURES, GOLDEN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEN1 = 2400


def _scorers(seed):
    rng = np.random.default_rng(seed)
    fw = rng.integers(0, 5, LEN1).astype(np.int8)
    rc = rng.integers(0, 5, LEN1).astype(np.int8)
    sm = (init_flatsubmat() + rng.integers(-40, 40, (31, 5, 5))).astype(np.int32)
    sm_b = (init_flatsubmat() + rng.integers(-40, 40, (31, 5, 5))).astype(np.int32)
    jsc = je.Pass1Scorer(fw, rc, LEN1, sm, sm_b, warm=False, batch=32)
    tsc = te.Pass1Scorer.from_state(
        te.state_from_numpy(jsc._refs_np, jsc._sms_np, "cpu"), LEN1, batch=32
    )
    return rng, jsc, tsc


def _entries(rng, n):
    ref_sel = rng.integers(0, 2, n).astype(np.int8)
    starts = rng.integers(0, LEN1 - 100, n).astype(np.int32)
    ivl = np.zeros((n, je.MAX_INTERVALS, 2), np.int32)
    for e in range(n):
        k = int(rng.integers(0, je.MAX_INTERVALS + 1))
        ivl[e, :k] = np.sort(rng.choice(je.WIN_W + 1, 2 * k, replace=False)).reshape(k, 2)
    lens = rng.integers(0, 90, n).astype(np.int32)  # 0: padded like length 1
    s2c = rng.integers(0, 5, (n, je.L_MAX)).astype(np.int8)
    smidx = rng.integers(0, 2, n).astype(np.int8)
    return ref_sel, starts, ivl, s2c, lens, smidx


@pytest.mark.parametrize("seed,n", [(0, 64), (1, 37), (2, 1)])
def test_scorer_entries_match_jax_scorer(seed, n):
    rng, jsc, tsc = _scorers(seed)
    ents = _entries(rng, n)
    want = jsc.collect_entries(jsc.dispatch_entries(*ents))
    h = tsc.dispatch_entries(*ents)
    assert tsc.ready(h)
    got = tsc.collect_entries(h)
    for w, g in zip(want, got):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


def test_scorer_packed_batch_matches_jax_scorer():
    rng, jsc, tsc = _scorers(3)
    n = 32
    s2c = rng.integers(0, 5, (n, je.L_MAX)).astype(np.int32)
    lens = rng.integers(20, 100, n).astype(np.int32)
    fw_ws = rng.integers(0, LEN1 - je.WIN_W, n).astype(np.int32)
    rc_ws = rng.integers(0, LEN1 - je.WIN_W, n).astype(np.int32)
    fw_ivg = np.zeros((n, je.MAX_INTERVALS, 2), np.int32)
    rc_ivg = np.zeros((n, je.MAX_INTERVALS, 2), np.int32)
    fw_ivg[:, 0, 0], fw_ivg[:, 0, 1] = fw_ws + 2, fw_ws + 300
    rc_ivg[:, 0, 0], rc_ivg[:, 0, 1] = rc_ws + 5, rc_ws + je.WIN_W
    flags = np.zeros(n, np.int32)
    wide = np.zeros(n, bool)
    wide[::5] = True
    flags[wide] = 4  # FLAG_WIDE: garbage on the TPU engine, scored full width here
    args = (s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags)
    want = [np.array(a, np.int64) for a in jsc.collect_arrays(jsc.dispatch_packed(*args))]
    # the WIDE reads: dp_jax.batch_last_row over each strand's window
    rows = entries.wide_rows(flags, lens, s2c, fw_ivg, rc_ivg)
    s1c, mask, rs2c, rlen, depths = entries.wide_inputs(rows, jsc._refs_np)
    last = dp_jax.batch_last_row(s1c, mask, rs2c, rlen, depths, jsc._sms_np[0])
    entries.merge_wide(*want, rows, *(np.asarray(x) for x in dp_jax.batch_best_and_aec(last)))
    h = tsc.dispatch_packed(*args)
    assert te.Pass1Scorer.ready(h)
    got = tsc.collect_arrays(h)
    assert rows.n == 2 * wide.sum()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_scorer_state_matches_jax_scorer():
    rng, jsc, _ = _scorers(4)
    fw = jsc._refs_np[0, :LEN1]
    rc = jsc._refs_np[1, :LEN1]
    refs, sms = te.padded_state_numpy(fw, rc, LEN1, jsc._sms_np[0], jsc._sms_np[1])
    np.testing.assert_array_equal(refs, jsc._refs_np)
    np.testing.assert_array_equal(sms, jsc._sms_np)
    sc = te.Pass1Scorer(fw, rc, LEN1, jsc._sms_np[0], jsc._sms_np[1], batch=8,
                        device="cpu")
    assert (sc.batch, sc.E, sc.WTOT) == (8, 16, jsc.WTOT)
    assert torch.equal(sc.state.refs, torch.from_numpy(jsc._refs_np))


def test_scorer_rejects_oversize_batch():
    rng, _, tsc = _scorers(5)
    with pytest.raises(ValueError):
        tsc.dispatch_entries(*_entries(rng, tsc.E + 1))
    assert tsc.collect_entries(tsc.dispatch_entries(*_entries(rng, 0)))[0].size == 0


def test_select_device_needs_card_or_request(monkeypatch):
    monkeypatch.delenv("MIA_TORCH_DEVICE", raising=False)
    if torch.cuda.is_available():
        assert torchcfg.select_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            torchcfg.select_device()
    monkeypatch.setenv("MIA_TORCH_DEVICE", "cpu")
    assert torchcfg.select_device().type == "cpu"


def test_kernel_library_path_keys_on_sources(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(torchcfg, "CSRC_DIR", str(tmp_path))
    p1 = torchcfg.library_path()
    assert p1 == torchcfg.library_path()
    src.write_text("// two\n")
    p2 = torchcfg.library_path()
    assert p1 != p2 and os.path.dirname(p2).startswith(torchcfg.BUILD_DIR)


def test_kernel_library_path_keys_on_headers(tmp_path, monkeypatch):
    """A header the sources include (csrc/*.cuh) keys the library too: an
    edited header rebuilds, though only the .cu files are compiled."""
    assert "band_dp.cuh" in [os.path.basename(s) for s in torchcfg._sources()]
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    head = tmp_path / "h.cuh"
    head.write_text("// one\n")
    monkeypatch.setattr(torchcfg, "CSRC_DIR", str(tmp_path))
    assert [os.path.basename(s) for s in torchcfg._sources()] == ["h.cuh", "k.cu"]
    p1 = torchcfg.library_path()
    head.write_text("// two\n")
    assert torchcfg.library_path() != p1


class _FakeKernelLibrary:
    """Stands in for the ctypes library: reports the given constants."""

    def __init__(self, values, myers=None, last_row=None, cons=None, pileup=None, band=None,
                 plain_band=None, strand=None, strand_hp=None):
        self.values = values
        self.strand = torchcfg.expected_strand_constants() if strand is None else strand
        self.strand_hp = (torchcfg.expected_strand_hp_constants() if strand_hp is None
                          else strand_hp)
        self.band = torchcfg.expected_band_hp_constants() if band is None else band
        self.plain_band = (torchcfg.expected_band_constants() if plain_band is None
                           else plain_band)
        self.myers = torchcfg.expected_myers_constants() if myers is None else myers
        self.last_row = (torchcfg.expected_last_row_constants() if last_row is None
                         else last_row)
        self.cons = torchcfg.expected_consensus_call_constants() if cons is None else cons
        self.pileup = torchcfg.expected_pileup_constants() if pileup is None else pileup

    @staticmethod
    def _fill(values, buf, n):
        for i, v in enumerate(values[:n]):
            buf[i] = v
        return len(values)

    def mia_dp_entries_constants(self, buf, n):
        return self._fill(self.values, buf, n)

    def mia_myers_constants(self, buf, n):
        return self._fill(self.myers, buf, n)

    def mia_dp_last_row_constants(self, buf, n):
        return self._fill(self.last_row, buf, n)

    def mia_dp_band_hp_constants(self, buf, n):
        return self._fill(self.band, buf, n)

    def mia_dp_band_constants(self, buf, n):
        return self._fill(self.plain_band, buf, n)

    def mia_dp_strand_constants(self, buf, n):
        return self._fill(self.strand, buf, n)

    def mia_dp_strand_hp_constants(self, buf, n):
        return self._fill(self.strand_hp, buf, n)

    def mia_consensus_call_constants(self, buf, n):
        return self._fill(self.cons, buf, n)

    def mia_pileup_counts_constants(self, buf, n):
        return self._fill(self.pileup, buf, n)


def _constants_with(index, delta):
    c = list(torchcfg.expected_constants())
    c[index] += delta
    return c


@pytest.mark.parametrize("values,ok", [
    (None, True),
    (_constants_with(0, 32), False),   # window width
    (_constants_with(1, 16), False),   # intervals per entry
    (_constants_with(2, -1), False),   # read rows
    (_constants_with(5, 1), False),    # GOP
    (_constants_with(6, -1), False),   # GEP
    (_constants_with(9, 1), False),    # -h row reach
    (_constants_with(10, -1), False),  # -h discount slots
    (list(torchcfg.expected_constants())[:-1], False),  # count
])
def test_kernel_library_constants_checked(values, ok):
    lib = _FakeKernelLibrary(values if values is not None
                             else torchcfg.expected_constants())
    if ok:
        torchcfg.check_constants(lib)
    else:
        with pytest.raises(RuntimeError, match="constants"):
            torchcfg.check_constants(lib)


@pytest.mark.parametrize("myers", [[-(2**30) + 1], [-(2**30), 0], [-(2**30), 16],
                                   [-(2**30) + 1, 24]])
def test_kernel_library_myers_constants_checked(myers):
    """The sentinel and the bitmaps' zero padding past their lengths."""
    assert torchcfg.expected_myers_constants() == [-(2**30), 24]
    with pytest.raises(RuntimeError, match="mia_myers_constants"):
        torchcfg.check_constants(_FakeKernelLibrary(torchcfg.expected_constants(), myers))
    src = open(os.path.join(torchcfg.CSRC_DIR, "myers_waves.cu")).read()
    for decl in ("kNeg = -(1 << 30);", "kSlack = 24;"):
        assert f"constexpr int {decl}" in src, decl


@pytest.mark.parametrize("which,values", [
    ("last_row", [1000, 200, -(2**30), -(2**30) - 2**29, 31, 227 * 1024, 34, 512,
                  256, 16, 32, 11, 17408]),                                  # smem limit
    ("last_row", [1000, 200, -(2**30), -(2**30) - 2**29, 31, 227 * 1024 - 1024, 34,
                  512, 256, 16, 32, 11]),                                    # count
    ("cons", [50, -400, 32]),                                                # MIN_SCORE_CONS
    ("cons", [50, -399, 4]),                                                 # parts a call sums
    ("cons", [50, -399]),                                                    # count
    ("last_row", [1000, 200, -(2**30), -(2**30) - 2**29, 31, 227 * 1024 - 1024, 17,
                  1024, 256, 16, 32, 11, 17408]),                            # columns a thread
    ("last_row", [1000, 200, -(2**30), -(2**30) - 2**29, 31, 227 * 1024 - 1024, 34,
                  512, 256, 16, 31, 11, 17408]),                             # -h row reach
    ("last_row", [1000, 200, -(2**30), -(2**30) - 2**29, 31, 227 * 1024 - 1024, 34,
                  512, 256, 16, 32, 11, 16384]),                             # -h widest row
    ("pileup", [31, 1024, 128]),                                             # a block's list
    ("pileup", [31, 2048, 512]),                                             # tile width
    ("band", [385, 16, 256, 31, 1000, 200, -(2**30), -(2**30) - 2**29, 32, 11, 3072]),  # a warp
    ("band", [384, 16, 256, 31, 1000, 200, -(2**30), -(2**30) - 2**29, 32, 11, 1536]),  # a row
    ("band", [384, 16, 256, 31, 1000, 200, -(2**30), -(2**30) - 2**29, 32, 11]),    # count
    ("plain_band", [512, 16, 256, 31, 15, 1000, 200, -(2**30), -(2**30) - 2**29, 3072]),  # a warp
    ("plain_band", [384, 16, 256, 31, 15, 1000, 200, -(2**30), -(2**30) - 2**29, 4096]),  # a row
    ("plain_band", [384, 16, 256, 31, 15, 1000, 200, -(2**30)]),                  # count
    ("strand", [17408, 9, 16, 128, 16, 256, 31, 15, 1000, 200, -(2**30),
                -(2**30) - 2**29]),                                               # band columns
    ("strand", [18432, 9, 8, 256, 16, 256, 31, 15, 1000, 200, -(2**30),
                -(2**30) - 2**29]),                                               # CTAs a row
    ("strand", [18432, 8, 16, 128, 16, 256, 31, 15, 1000, 200, -(2**30),
                -(2**30) - 2**29]),                                               # columns a thread
    ("strand", [18432, 9, 16, 128, 16, 256, 31, 15, 1000, 200, -(2**30)]),        # count
    ("strand_hp", [18432, 9, 16, 128, 16, 256, 31, 15, 1000, 200, -(2**30),
                   -(2**30) - 2**29, 31, 11]),                                    # -h row reach
    ("strand_hp", [18432, 9, 16, 128, 16, 256, 31, 15, 1000, 200, -(2**30),
                   -(2**30) - 2**29, 32]),                                        # count
])
def test_kernel_library_step_constants_checked(which, values):
    """The last-row scorer's, its band and strand forms', the consensus
    call's and the pileup counts' constants are held against the Python
    side's too."""
    assert torchcfg.expected_last_row_constants() == [
        1000, 200, -(2**30), -(2**30) - 2**29, 31, 227 * 1024 - 1024, 34, 512, 256, 16, 32,
        11, 17408]
    assert torchcfg.expected_consensus_call_constants() == [50, -399, 32]
    assert torchcfg.expected_pileup_constants() == [31, 2048, 128]
    assert torchcfg.expected_band_hp_constants() == [
        384, 16, 256, 31, 1000, 200, -(2**30), -(2**30) - 2**29, 32, 11, 3072]
    assert torchcfg.expected_band_constants() == [
        384, 16, 256, 31, 15, 1000, 200, -(2**30), -(2**30) - 2**29, 3072]
    assert torchcfg.expected_strand_constants() == [
        18432, 9, 16, 128, 16, 256, 31, 15, 1000, 200, -(2**30), -(2**30) - 2**29]
    assert torchcfg.expected_strand_hp_constants() == [
        *torchcfg.expected_strand_constants(), 32, 11]
    assert (entries.BAND_ROW_COLS, entries.STRAND_COLS) == (3072, 18432)
    assert entries.STRAND_COLS >= entries.HP_WIDE_COLS
    lib = _FakeKernelLibrary(torchcfg.expected_constants(), **{which: values})
    entry = {"last_row": "dp_last_row", "cons": "consensus_call", "pileup": "pileup_counts",
             "band": "dp_band_hp", "plain_band": "dp_band", "strand": "dp_strand",
             "strand_hp": "dp_strand_hp"}
    with pytest.raises(RuntimeError, match=f"mia_{entry[which]}_constants"):
        torchcfg.check_constants(lib)
    src = open(os.path.join(torchcfg.CSRC_DIR, "dp_last_row.cu")).read()
    for decl in ("GOP = 1000;", "GEP = 200;", "kDepth = 31;",
                 "kSmemLimit = 227 * 1024 - 1024;", "kCols = 34;", "kRegThreads = 512;",
                 "kLMax = 256;", "kK = 16;", "kHpw = 32;", "kPengop = 11;"):
        assert f"constexpr int {decl}" in src, decl
    # the two scorers of wide rows share band_dp.cuh's constants
    shared = open(os.path.join(torchcfg.CSRC_DIR, "band_dp.cuh")).read()
    src = open(os.path.join(torchcfg.CSRC_DIR, "dp_band.cu")).read() + shared
    assert '#include "band_dp.cuh"' in src
    for decl in ("kCPL = 12;", "kBand = 32 * kCPL;", "kK = 16;", "kLMax = 256;",
                 "kHpw = 32;", "kPengop = 11;", "GOP = 1000;", "GEP = 200;", "kWarps = 8;",
                 "kRowBand = kBand * kWarps;"):
        assert f"constexpr int {decl}" in src, decl
    src = open(os.path.join(torchcfg.CSRC_DIR, "dp_strand.cu")).read() + shared
    assert '#include "band_dp.cuh"' in src
    for decl in ("kC = 16;", "kThreads = 2048 / kC;", "kCPL = 9;",
                 "kSlice = kThreads * kCPL;", "kStrand = kC * kSlice;", "kK = 16;",
                 "kLMax = 256;", "kPssmDepth = 15;", "GOP = 1000;", "GEP = 200;"):
        assert f"constexpr int {decl}" in src, decl
    src = open(os.path.join(torchcfg.CSRC_DIR, "pileup_counts.cu")).read()
    for decl in ("kThreads = 1024;", "kPer = 2;", "kMaxTile = 128;", "kDepth = 31;"):
        assert f"constexpr int {decl}" in src, decl
    src = open(os.path.join(torchcfg.CSRC_DIR, "consensus_call.cu")).read()
    assert "constexpr int kPerc4Gap = 50;" in src
    assert "constexpr int kMinScoreCons = -399;" in src
    assert "constexpr int kMaxParts = 32;" in src


def test_kernel_constants_match_python_side():
    from mia_tpu.constants import GEP, GOP, HIM, PSSM_DEPTH
    from mia_tpu_torch.ops.dp_torch import _LOW

    assert torchcfg.expected_constants() == [
        je.WIN_W, je.MAX_INTERVALS, je.L_MAX, 31, PSSM_DEPTH, GOP, GEP, HIM, _LOW,
        je.HPW_ROUTE, len(je.hp_pengop_table())]
    # the kernel's own values, read from its source
    src = open(os.path.join(torchcfg.CSRC_DIR, "dp_entries.cu")).read()
    for decl in ("kW = 384;", "kK = 16;", "kLMax = 256;", "kPssmDepth = 15;",
                 "GOP = 1000;", "GEP = 200;", "kHpw = 32;", "kPengop = 11;"):
        assert f"constexpr int {decl}" in src, decl
    assert (je.WIN_W, je.MAX_INTERVALS, je.L_MAX, PSSM_DEPTH, GOP, GEP, je.HPW_ROUTE,
            len(je.hp_pengop_table())) == (384, 16, 256, 15, 1000, 200, 32, 11)
    src = open(os.path.join(torchcfg.CSRC_DIR, "myers_waves.cu")).read()
    assert "constexpr int kNeg = -(1 << 30);" in src
    assert torchcfg.expected_myers_constants() == [-(1 << 30), 24]


NO_JAX_RUN = r"""
import importlib, os, pkgutil, sys
sys.modules["jax"] = None
import mia_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mia_tpu_torch.__path__, "mia_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None), "jax imported"
from mia_tpu_torch.cli.mia import main
fx = sys.argv[1]
rc = main(["-r", os.path.join(fx, "tr1.fna"), "-f", os.path.join(fx, "tf.fna"),
           "-k", "12", "-m", "out.maln"])
print("IMPORTED", len(names))
sys.exit(rc)
"""


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["MIA_TORCH_DEVICE"] = "cpu"
    env["MIA_SCORE_BATCH"] = "64"
    env["MIA_TORCH_SERVER"] = "0"
    r = subprocess.run(
        [sys.executable, "-c", NO_JAX_RUN, FIXTURES], cwd=tmp_path, env=env,
        capture_output=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    assert int(r.stdout.decode().split("IMPORTED")[1]) >= 10
    golden = os.path.join(GOLDEN, "kmer")
    for fn in sorted(os.listdir(golden)):
        with open(tmp_path / fn, "rb") as a, open(os.path.join(golden, fn), "rb") as b:
            assert a.read().split(b"\n")[1:] == b.read().split(b"\n")[1:], fn


def test_device_trace_writes_a_torch_profiler_trace(tmp_path, monkeypatch):
    """utils/profiling.device_trace: a no-op without MIA_TORCH_TRACE_DIR, a
    Chrome trace of the region with it."""
    import json

    from mia_tpu_torch.utils import profiling

    monkeypatch.delenv("MIA_TORCH_TRACE_DIR", raising=False)
    with profiling.device_trace():
        pass
    assert os.listdir(tmp_path) == []
    monkeypatch.setenv("MIA_TORCH_TRACE_DIR", str(tmp_path / "trace"))
    with profiling.device_trace():
        torch.arange(1000).sum()
    (name,) = os.listdir(tmp_path / "trace")
    assert name == f"mia_trace_{os.getpid()}.json"
    with open(tmp_path / "trace" / name) as f:
        assert json.load(f)["traceEvents"]
