"""The port's copies of the JAX package's host modules.

The port keeps its own copy of every host module it needs.  Each module
listed here was copied unchanged: its case fails when the port's file
differs from ``mia_tpu``'s after the package name is put back (and the
reference sources' path prefix that ``core/hostbatch.py`` cites is dropped,
and a path into the port's ``native/`` sources read as the root's).
A change made to a copy on purpose takes its case out of this list, with the
reason in CHANGES.md.  Not listed, because they differ on purpose:
``utils/profiling.py`` (``device_trace`` on torch.profiler), ``core/driver.py``,
``core/contamination.py``, ``core/assembler.py`` and the CLIs but
``easy_consensus`` (the port's device engine in place of the JAX one; ``ma``
without the JAX platform override); ``core/fsdb.py`` and ``core/columns.py``
(the cull's recount and the insertion columns' consensus in one pass each;
``tests/test_torch_gapcols.py`` holds them, and the rest of both files, to
``mia_tpu``); ``io/native.py``, ``ops/dp_numpy.py`` and ``core/hostbatch.py``
(they load the port's own native library, built from
``mia_tpu_torch/native/`` into ``mia_tpu_torch/_build/``).

That native library's sources are copies too: each case of
``NATIVE_COPIED`` holds the port's file to the root ``native/`` one (the
machine-specific prefix of the reference sources' path dropped), until a
change made on purpose takes it out of the list and into ``NATIVE_LEFT``:
``src/hostbatch.cc`` (pass 1's banding, ``mia_p1_prepare``, threaded over
reads; ``tests/test_torch_prepare_threads.py`` holds it to the root's).  No port source and not
``chip_smoke.py`` names the root ``native/``, and the library the port loads
lies under ``mia_tpu_torch/_build/``.

The numpy entry helpers that moved from ``mia_tpu/core/jax_engine.py`` into
``core/entries.py`` are held to their originals function by function: by
their code, or, for ``diag_gapfree`` (which sums each diagonal over the
reads' bases end to end instead of over a padded rectangle), by the arrays
it returns on seeded inputs.

Beside it, the port's host engines (``--engine native`` and ``--engine
numpy``), which run from those copies, write ``mia_tpu``'s bytes.
"""
import contextlib
import io
import os
import re

import pytest

from mia_tpu.cli import mia as tpu_mia
from mia_tpu_torch.cli import mia as port_mia

from .test_torch_golden import _norm, fixture_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIED = [
    "__init__.py", "config.py", "constants.py", "core/types.py",
    "core/merge.py", "io/fasta.py", "io/ids.py",
    "io/maln.py", "io/pssm_io.py", "ops/kmer.py", "ops/pssm.py",
    "ops/myers.py", "ops/consensus.py", "utils/encoding.py",
    "utils/hostmem.py", "models/simulate.py", "models/damage.py", "data/mt311.fa",
    "data/matrices/ancient.submat.txt", "data/matrices/ancient.submat.solexa.pe.txt",
    "data/matrices/ancient.submat.solexa.onepass.txt", "io/formats.py", "io/align_reader.py",
    "cli/easy_consensus.py", "models/estimate.py",
]


def _normalised(text: str) -> str:
    # the port's native sources are its copy of the root native/ ones
    text = text.replace("mia_tpu_torch/native/", "native/")
    text = text.replace("mia_tpu_torch", "mia_tpu")
    # the reference sources are cited as src/...: drop an absolute prefix
    text = re.sub(r"/\w+/reference/src/", "src/", text)
    # the one comment of the package's __init__ may name another reason
    return re.sub(r"(_tune_malloc\(\))  #.*", r"\1", text)


NATIVE_COPIED = ["Makefile", "src/dpkernel.cc", "src/fastaio.cc", "src/scorecut.cc"]
NATIVE_LEFT = ["src/hostbatch.cc"]


@pytest.mark.parametrize("path", COPIED)
def test_copy_equals_mia_tpu(path):
    with open(os.path.join(REPO, "mia_tpu_torch", path)) as f:
        port = f.read()
    with open(os.path.join(REPO, "mia_tpu", path)) as f:
        tpu = f.read()
    assert _normalised(port) == _normalised(tpu)


@pytest.mark.parametrize("path", NATIVE_COPIED)
def test_native_copy_equals_root_native(path):
    """The port's native sources against the ones the JAX package builds."""
    with open(os.path.join(REPO, "mia_tpu_torch", "native", path)) as f:
        port = f.read()
    with open(os.path.join(REPO, "native", path)) as f:
        root = f.read()
    assert _normalised(port) == _normalised(root)
    assert sorted(os.listdir(os.path.join(REPO, "mia_tpu_torch", "native", "src"))) == sorted(
        p[len("src/"):] for p in NATIVE_COPIED + NATIVE_LEFT if p.startswith("src/"))


# the root native/ named as a path: a path component (not the port's
# mia_tpu_torch/native/), a make target, or a join onto the repository's root
ROOT_NATIVE = re.compile(
    r"(?<![\w/])native/(?=src\b|libmiaio|Makefile|\.build|[`'\"\s)]|$)|-C[\"']?\s*,?\s*[\"']?native\b|join\(\s*(REPO|ROOT|repo|root)\w*\s*,\s*[\"']native[\"']"
    r"|dirname\(os\.path\.abspath\(__file__\)\)\)\)\s*,\s*[\"']native[\"']")


def test_no_port_source_names_root_native():
    """No module or kernel source of the port, and not chip_smoke.py,
    reads, builds or locks anything under the root ``native/`` (the JAX
    package's).  The native sources are left out: they are the root's
    copies (``test_native_copy_equals_root_native``), whose comments name
    their own directory."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, dirs, files in os.walk(os.path.join(REPO, "mia_tpu_torch")):
        dirs[:] = [x for x in dirs if x not in ("__pycache__", "_build", "native")]
        paths += [os.path.join(d, f) for f in files if f.endswith((".py", ".cu", ".cuh"))]
    found = []
    for path in paths:
        with open(path) as f:
            for no, line in enumerate(f, 1):
                if ROOT_NATIVE.search(line):
                    found.append(f"{os.path.relpath(path, REPO)}:{no}: {line.strip()}")
    assert not found, "\n".join(found)
    # the pattern finds what it is for
    for line in ('lib = os.path.join(REPO, "native", "libmiaio.so")',
                 'subprocess.run(["make", "-C", "native"])', "make -C native",
                 "see native/src/hostbatch.cc", "builds ``native/``"):
        assert ROOT_NATIVE.search(line), line
    for line in ("mia_tpu_torch/native/src/hostbatch.cc", "the batched native/device path"):
        assert not ROOT_NATIVE.search(line), line


def test_port_loads_its_own_native_library():
    """The library behind the parser, the host DP and the batched pass-1
    engine is the port's build under ``mia_tpu_torch/_build/``, keyed on
    its sources."""
    from mia_tpu_torch.core import hostbatch
    from mia_tpu_torch.io import native
    from mia_tpu_torch.ops import dp_numpy

    build = os.path.join(REPO, "mia_tpu_torch", "_build") + os.sep
    lib = native._load()
    assert lib is not None, native.build_error()
    assert lib._name == native.library_path()
    assert os.path.realpath(lib._name).startswith(build)
    assert hostbatch._lib() is lib
    assert dp_numpy._load_native() in (lib, None)  # None: MIA_TPU_NO_NATIVE or other penalties
    assert os.path.basename(os.path.dirname(lib._name)).startswith("native-")


def _run(main, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert main(argv) == 0
    return err.getvalue()


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("name", ["fastq_UC", "distant", "hp_k"])
def test_host_engines_equal_mia_tpu(engine, name, tmp_path, monkeypatch):
    """The port's own host engines against mia_tpu's, iteration file by
    iteration file (-U -C2 on fastq, -D and -h -k 12)."""
    monkeypatch.delenv("MIA_JAX_PLATFORM", raising=False)
    outs = {}
    for tag, main in (("tpu", tpu_mia.main), ("port", port_mia.main)):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        _run(main, [*fixture_args(name), "-m", "out.maln", "--engine", engine])
        outs[tag] = {fn: _norm(d / fn) for fn in sorted(os.listdir(d))}
    assert outs["port"] and outs["port"] == outs["tpu"]


def _code_of(module, name):
    """The function's code as an AST dump, without its docstring, comments
    and line numbers."""
    import ast
    import inspect
    import textwrap

    fn = ast.parse(textwrap.dedent(inspect.getsource(getattr(module, name)))).body[0]
    if isinstance(fn.body[0], ast.Expr) and isinstance(fn.body[0].value, ast.Constant):
        fn.body = fn.body[1:]
    return ast.dump(fn)


# rewritten on purpose, and held to the original by what it returns:
# diag_gapfree sums each diagonal over the reads' bases laid end to end
REWRITTEN = ("diag_gapfree",)


@pytest.mark.parametrize("name", [
    "hp_routes_to_host", "build_pass1_entries", "split_pass1_results", "mask_intervals",
    "pack_s2c", "pack_chars", "diag_gapfree", "hp_pengop_table", "windowed_exact_dp",
])
def test_entry_helpers_equal_jax_engine(name):
    """core/entries.py holds the numpy helpers of mia_tpu/core/jax_engine.py:
    the same code, docstrings and comments aside, and the same constants; a
    helper in REWRITTEN returns the original's arrays on seeded inputs."""
    from mia_tpu.core import jax_engine
    from mia_tpu_torch.core import entries

    from .test_torch_merge_batch import assert_diag_gapfree_equal

    if name in REWRITTEN:
        for seed in (4, 5, 6):
            for ndim in (3, 4):
                assert_diag_gapfree_equal(seed, ndim)
    else:
        assert _code_of(entries, name) == _code_of(jax_engine, name)
    for const in ("HPW_ROUTE", "SCORE_BATCH", "MAX_INTERVALS", "WIN_W", "L_MAX",
                  "REF_BUCKET"):
        assert getattr(entries, const) == getattr(jax_engine, const), const
