"""The port is a package of its own: no file of ``mia_tpu_torch`` and not
``chip_smoke.py`` imports jax, jaxlib or anything of ``mia_tpu``.  The
sources are parsed, so an import inside a function or a branch that no test
runs counts too; and the port's ``mia`` and ``ccheck`` run goldens in a
process whose import system refuses all three.  Under ``--engine native``
and ``--engine numpy`` the port's ``mia`` runs with torch refused too (a
client of the resident server likewise: tests/test_torch_serve.py).
"""
import ast
import glob
import os
import subprocess
import sys

import pytest

from .conftest import FIXTURES, GOLDEN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mia_tpu")
SOURCES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "mia_tpu_torch", "**", "*.py"), recursive=True)
) + ["chip_smoke.py"]


def forbidden_imports(path: str) -> list[str]:
    """Every import in the file at ``path`` whose top-level package is
    forbidden, as "line: module"."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              or isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"):
            names = [a.value for a in node.args[:1]
                     if isinstance(a, ast.Constant) and isinstance(a.value, str)]
        else:
            continue
        found += [f"{node.lineno}: {n}" for n in names if n.split(".")[0] in FORBIDDEN]
    return found


def test_sources_listed():
    assert len(SOURCES) > 40
    for must in ("mia_tpu_torch/core/assembler.py", "mia_tpu_torch/parallel/sharded.py",
                 "mia_tpu_torch/entry.py", "mia_tpu_torch/io/native.py", "chip_smoke.py",
                 "mia_tpu_torch/parallel/distributed.py", "mia_tpu_torch/cli/ma.py",
                 "mia_tpu_torch/cli/easy_consensus.py", "mia_tpu_torch/models/estimate.py",
                 "mia_tpu_torch/serve.py", "mia_tpu_torch/cli/serve.py"):
        assert must in SOURCES


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax_or_mia_tpu_import(path):
    assert forbidden_imports(os.path.join(REPO, path)) == []


def test_the_parser_sees_every_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import os, jax.numpy as jnp\n"
        "from mia_tpu.core import driver\n"
        "from . import mia_tpu\n"
        "def f():\n"
        "    if 0:\n"
        "        from jaxlib import x\n"
        "    __import__('mia_tpu.ops')\n"
        "    import importlib; importlib.import_module('jax')\n"
        "import mia_tpu_torch, jaxtyping\n"
    )
    assert forbidden_imports(str(src)) == [
        "1: jax.numpy", "2: mia_tpu.core", "6: jaxlib", "7: mia_tpu.ops", "8: jax"]


# a finder that refuses the packages, put before every other
REFUSE = r"""
import importlib.abc, sys
PACKAGES = PACKAGE_LIST
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in PACKAGES:
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
from mia_tpu_torch.cli.MODULE import main
rc = main(sys.argv[1:])
bad = [m for m in sys.modules if m.split(".")[0] in PACKAGES]
assert not bad, bad
sys.exit(rc)
"""
NO_TORCH = FORBIDDEN + ("torch",)


def _run_refusing(module, argv, cwd, packages=FORBIDDEN, **env):
    """The port's CLI ``module`` in a new process whose import system
    refuses ``packages``; ``env`` is added to its environment."""
    env = {**os.environ, "MIA_TORCH_DEVICE": "cpu", "MIA_SCORE_BATCH": "64",
           "MIA_TORCH_SERVER": "0", "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), **env}
    code = REFUSE.replace("MODULE", module).replace("PACKAGE_LIST", repr(tuple(packages)))
    return subprocess.run([sys.executable, "-c", code, *argv],
                          cwd=cwd, env=env, capture_output=True, timeout=600)


def test_cli_runs_where_jax_and_mia_tpu_are_refused(tmp_path):
    r = _run_refusing("mia", ["-r", os.path.join(FIXTURES, "tr1.fna"),
                              "-f", os.path.join(FIXTURES, "tf.fna"), "-k", "12",
                              "-m", "out.maln"], tmp_path)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    golden = os.path.join(GOLDEN, "kmer")
    for fn in sorted(os.listdir(golden)):
        with open(tmp_path / fn, "rb") as a, open(os.path.join(golden, fn), "rb") as b:
            assert a.read().split(b"\n")[1:] == b.read().split(b"\n")[1:], fn
    cc = os.path.join(GOLDEN, "ccheck")
    r = _run_refusing("ccheck", ["cc.maln.1"], cc)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    with open(os.path.join(cc, "prose.txt"), "rb") as f:
        assert r.stdout == f.read()


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_host_engines_run_where_torch_is_refused(engine, tmp_path):
    """The host engines import no torch (nor does the CLI around them): the
    ``fastq_UC`` golden's bytes with torch refused, and no kernel counted."""
    from .test_torch_golden import fixture_args, profile_counters

    r = _run_refusing("mia", [*fixture_args("fastq_UC"), "-m", "out.maln", "--engine",
                              engine, "--profile"], tmp_path, NO_TORCH)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    golden = os.path.join(GOLDEN, "fastq_UC")
    assert sorted(p for p in os.listdir(tmp_path) if p.startswith("out.maln.")) == sorted(
        os.listdir(golden))
    for fn in sorted(os.listdir(golden)):
        with open(tmp_path / fn, "rb") as a, open(os.path.join(golden, fn), "rb") as b:
            assert a.read().split(b"\n")[1:] == b.read().split(b"\n")[1:], fn
    c = profile_counters(r.stderr)
    assert c["dp.kernel_launches"] == c["dp.plain_calls"] == c["cons.plain_calls"] == 0, c
    assert "pass1.using_server" not in c and "pass1.in_process" not in c, c


def test_host_tools_run_where_jax_and_mia_tpu_are_refused(tmp_path):
    """ma and easy_consensus, as a user runs them, with the three packages
    refused: the JAX package's ma prints the same bytes."""
    import contextlib
    import io

    from mia_tpu.cli import ma as tpu_ma

    maln = os.path.join(GOLDEN, "sim200", "out.maln.2")
    r = _run_refusing("ma", ["-M", maln, "-f", "3"], tmp_path)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        tpu_ma.main(["-M", maln, "-f", "3"])
    assert r.stdout.decode() == want.getvalue()
    r = _run_refusing("easy_consensus", [os.path.join(FIXTURES, "tf.fna")], tmp_path)
    assert r.returncode == 0 and r.stdout.startswith(b">consensus\n"), r.stderr.decode()
