"""ccheck on the PyTorch port: ``mia_tpu_torch``'s ccheck under ``--engine
torch`` must print what ``mia_tpu``'s ccheck prints, byte for byte.

On the CPU (MIA_TORCH_DEVICE=cpu) the Myers wavefront and the scorer run
their plain PyTorch versions; the profile counters prove that they, not a
host engine, did the work.  The golden runs block jax in the process, as
tests/test_torch_golden.py does; the option sets run in this process
against ``mia_tpu.cli.ccheck --engine numpy`` (the exact per-read path).

Tolerance: exact equality (bytes of stdout, CachedPwaln fields).
"""
import contextlib
import dataclasses
import io
import os
import shutil
import subprocess
import sys

import pytest

from mia_tpu.cli import ccheck as tpu_ccheck
from mia_tpu.core import contamination as tpu_cc
from mia_tpu.io.maln import read_ma
from mia_tpu.ops.myers import Mode, myers_diff
from mia_tpu_torch import testing as T
from mia_tpu_torch.cli import ccheck as port_ccheck
from mia_tpu_torch.core import contamination as port_cc

from .conftest import GOLDEN
from .test_torch_golden import REPO, profile_counters

CC = os.path.join(GOLDEN, "ccheck")

NO_JAX_CCHECK = (
    "import sys; sys.modules['jax'] = None; "
    "from mia_tpu_torch.cli.ccheck import main; sys.exit(main(sys.argv[1:]))"
)


def run_port_cli(args, cwd=CC):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["MIA_TORCH_DEVICE"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-c", NO_JAX_CCHECK, *args, "--profile"],
                          cwd=cwd, env=env, capture_output=True, timeout=600)


def _golden(name):
    with open(os.path.join(CC, name), "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("args,golden", [
    (["cc.maln.1"], "prose.txt"),
    (["-T", "-a", "cc.maln.1"], "table_a.txt"),
])
def test_port_ccheck_golden(args, golden):
    r = run_port_cli(args)
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == _golden(golden)
    c = profile_counters(r.stderr)
    # one Myers alignment and the realignment, both as plain versions (CPU
    # tensors), never as a kernel here, and no read left to the host
    assert (c["myers.plain_calls"], c["myers.kernel_launches"]) == (1, 0), c
    assert c["dp.plain_calls"] > 0 and c["dp.kernel_launches"] == 0, c
    assert c["ccheck.device_entries"] > 0, c
    assert c["ccheck.device_entries"] + c["ccheck.host_entries"] == 361, c


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_port_cli_hands_host_engines_to_mia_tpu(engine):
    """The host engines run from the port's own copy of the host code, with
    jax blocked: the golden's bytes, and no device stage is called."""
    r = run_port_cli(["--engine", engine, "-T", "-a", "cc.maln.1"])
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == _golden("table_a.txt")
    c = profile_counters(r.stderr)
    assert set(c.values()) == {0}, c


def test_port_cli_refuses_jax_engine():
    r = run_port_cli(["--engine", "jax", "cc.maln.1"])
    assert r.returncode == 2
    assert b"--engine jax is not an engine of this port" in r.stderr
    assert r.stdout == b""


def _alignment(maln):
    panel = tpu_ccheck.load_mt311()
    maxd = max(len(panel), len(maln.ref.seq)) // 10
    d, aln_con, aln_ass = myers_diff(panel, Mode.GLOBAL, maln.ref.seq, maxd)
    assert d == 121
    return aln_con, aln_ass


def test_realign_all_matches_mia_tpu(monkeypatch):
    """The port's device realignment equals mia_tpu's, CachedPwaln for
    CachedPwaln: its JAX scorer path (on the JAX CPU backend) and the exact
    per-read path."""
    monkeypatch.setenv("MIA_SCORE_BATCH", "128")  # several scorer chunks
    maln = read_ma(os.path.join(CC, "cc.maln.2"))
    aln_con, aln_ass = _alignment(maln)
    port_cc.reset_counts()
    _, got = port_cc._realign_all(maln, port_cc.AlnIndex(aln_con, aln_ass), maln.fpsm,
                                  device="cpu")
    assert port_cc.device_entries > 0
    assert len(got) == len(maln.aln_seqs) == 361
    got = [dataclasses.astuple(c) for c in got]
    for engine in ("jax", "numpy"):
        want = tpu_cc._realign_all(maln, aln_con, aln_ass, maln.fpsm, engine)
        assert got == [dataclasses.astuple(c) for c in want], engine


def _run_in_process(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def contaminant_fa(tmp_path_factory):
    """A FASTA of another resolution of mt311: the -r contaminant."""
    path = tmp_path_factory.mktemp("ccheck") / "contaminant.fa"
    seq = T.ccheck_sample(seed=4)[2]
    path.write_text(">contaminant\n" + "".join(
        seq[i : i + 70] + "\n" for i in range(0, len(seq), 70)))
    return str(path)


@pytest.mark.parametrize("opts,rc", [
    (["-T"], 0),
    (["-a"], 0),
    (["-t"], 0),
    (["-s", "100-9000"], 0),
    (["-n", "2"], 0),
    (["-s", "1-1500"], 1),        # too few strongly diagnostic positions
    (["-s", "1-1500", "-F"], 0),  # ... unless forced
    (["-f", "-T"], 0),            # cc.maln.1 itself, not the highest iteration
    (["-r", "CONTAMINANT"], 0),
    (["-d", "50"], 1),            # "Could not align" within 50 differences
])
def test_option_sets_match_mia_tpu(opts, rc, contaminant_fa, tmp_path, monkeypatch):
    monkeypatch.setenv("MIA_TORCH_DEVICE", "cpu")
    for fn in ("cc.maln.1", "cc.maln.2"):
        shutil.copy(os.path.join(CC, fn), tmp_path / fn)
    monkeypatch.chdir(tmp_path)
    argv = [contaminant_fa if a == "CONTAMINANT" else a for a in opts] + ["cc.maln.1"]
    want = _run_in_process(tpu_ccheck.main, ["--engine", "numpy", *argv])
    port_ccheck.reset_counts()
    got = _run_in_process(port_ccheck.main, argv)
    assert got == want
    assert got[0] == rc
    c = port_ccheck.counts()
    assert (c["myers.plain_calls"], c["myers.kernel_launches"]) == (1, 0), c
    # a run that stops early realigns nothing
    assert (c["dp.plain_calls"] > 0) == (rc == 0), c
    assert (c["ccheck.device_entries"] > 0) == (rc == 0), c
    assert c["dp.kernel_launches"] == 0, c
