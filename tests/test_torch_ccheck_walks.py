"""ccheck's per-read walks on the PyTorch port: the alignment index
(``mia_tpu_torch.core.contamination.AlnIndex``) against the walks from
column 0 that ``mia_tpu``'s ccheck makes for every read, and a whole ccheck
on a circular sample against ``mia_tpu``'s.

* ``AlnIndex.walk(k)`` must stop where the walk of ``mia_tpu``'s
  ``check_contamination`` towards assembly position ``k`` stops
  (``mia_tpu/core/contamination.py:455-462``, repeated below as
  :func:`walk_from_0`), and ``AlnIndex.lift(s, e)`` must equal
  ``mia_tpu.core.contamination.lift_over`` for every ``(s, e)`` around
  the assembly, on seeded random gapped alignment pairs made with numpy
  that hold the edge cases, and on a real alignment: mt311 against a ccheck
  sample.  ``mk_dp_list``, which starts from ``AlnIndex.walk(span_from)``,
  must equal ``mia_tpu``'s on the same pairs.
* ccheck on a circular sample of a few hundred reads of
  ``testing.ccheck_sample`` with ``_f``/``_b`` split reads, ``-a`` and
  ``-s``: the port's ``--engine torch`` (plain versions on the CPU) and
  ``--engine native`` against ``mia_tpu.cli.ccheck --engine numpy`` (the
  exact per-read path), with the profile counters that prove the path.

Tolerance: exact equality (columns, strings, exit codes, stdout, stderr).
"""
import contextlib
import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from mia_tpu.cli import ccheck as tpu_ccheck
from mia_tpu.core import contamination as tpu_cc
from mia_tpu.io.maln import read_ma
from mia_tpu.ops.myers import Mode, myers_diff
from mia_tpu_torch import testing as T
from mia_tpu_torch.cli import ccheck as port_ccheck
from mia_tpu_torch.cli.mia import main as port_mia
from mia_tpu_torch.core import contamination as port_cc
from mia_tpu_torch.core.contamination import AlnIndex
from mia_tpu_torch.models.simulate import SimConfig, simulate_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBMAT = os.path.join(REPO, "mia_tpu_torch", "data", "matrices",
                      "ancient.submat.solexa.pe.txt")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions' tensors are small: one thread a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def walk_from_0(aln_con: str, aln_ass: str, k: int) -> tuple[int, int]:
    """mia_tpu's walk of the global alignment to a read's start."""
    p = 0
    ass_pos = 0
    n_aln = min(len(aln_con), len(aln_ass))
    while ass_pos != k and p < n_aln:
        if aln_ass[p] != "-":
            ass_pos += 1
        p += 1
    return p, ass_pos


def gapped(rng, n: int, alphabet: str, gap: float, run: int = 1) -> str:
    """n columns of ``alphabet`` with gap runs of up to ``run`` columns
    starting at a share ``gap`` of the columns."""
    out = []
    while len(out) < n:
        if rng.random() < gap:
            out.extend("-" * int(rng.integers(1, run + 1)))
        else:
            out.append(alphabet[int(rng.integers(len(alphabet)))])
    return "".join(out[:n])


def alignment_pair(case: str, seed: int) -> tuple[str, str]:
    """(aln_con, aln_ass) for one edge case, from a numpy seed."""
    rng = np.random.default_rng(seed)
    n = 70
    if case == "empty":
        return "", ""
    if case == "ass_all_gaps":
        return gapped(rng, n, "ACGT", 0.1), "-" * n
    con = gapped(rng, n, "ACGT", 0.1)
    ass = gapped(rng, n, "ACGT", 0.1)
    if case == "leading_ass_gaps":      # s == 0 starts before the first base
        ass = "---" + ass[3:]
    elif case == "ass_gap_runs":        # gaps right after base k walk from k
        ass = gapped(rng, n, "ACGT", 0.3, run=5)
    elif case == "trailing_ass_gaps":   # end + 1, end + 2 past the last base
        ass = ass[:-4] + "----"
    elif case == "con_gap_runs":
        con = gapped(rng, n, "ACGT", 0.3, run=5)
    elif case == "con_longer":          # zip and min truncate
        con += gapped(rng, 6, "ACGT", 0.2)
    elif case == "ass_longer":
        ass += gapped(rng, 6, "ACGT", 0.2)
    elif case == "lower_and_iupac":     # only '-' is special
        con = gapped(rng, n, "acgtACGTRYKMSWBDHVNryn", 0.15)
        ass = gapped(rng, n, "ACGTacgtN", 0.15)
    return con, ass


CASES = ["random", "empty", "ass_all_gaps", "leading_ass_gaps", "ass_gap_runs",
         "trailing_ass_gaps", "con_gap_runs", "con_longer", "ass_longer",
         "lower_and_iupac"]


def dp_list(dps: dict) -> dict:
    return {k: dataclasses.astuple(v) for k, v in dps.items()}


def check_index(aln_con: str, aln_ass: str, ks, spans, dp_spans) -> None:
    idx = AlnIndex(aln_con, aln_ass)
    assert idx.total == sum(c != "-" for c in aln_ass[: min(len(aln_con), len(aln_ass))])
    for k in ks:
        assert idx.walk(k) == walk_from_0(aln_con, aln_ass, k), k
    for s, e in spans:
        assert idx.lift(s, e) == tpu_cc.lift_over(aln_con, aln_ass, s, e), (s, e)
    assert idx.weak == [tpu_cc.is_weakly_diagnostic(a, b) for a, b in zip(aln_con, aln_ass)]
    for f, t in dp_spans:
        got = port_cc.mk_dp_list(aln_con, aln_ass, idx, f, t)
        assert dp_list(got) == dp_list(tpu_cc.mk_dp_list(aln_con, aln_ass, f, t)), (f, t)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_index_matches_walks_from_column_0(case, seed):
    """Every start and end around the assembly, the empty and inverted
    ranges and the negative ones included."""
    aln_con, aln_ass = alignment_pair(case, seed)
    ks = range(-2, sum(c != "-" for c in aln_ass) + 4)
    spans = [(s, e) for s in ks for e in ks]
    check_index(aln_con, aln_ass, ks, spans, spans)


def test_index_on_mt311_alignment(sample_maln):
    """A real alignment with gaps on both sides: mt311 against the ccheck
    sample; the starts and both lifts (pass 1: to end + 2, pass 2: to
    end + 1) of the sample's reads, and the ends of the assembly."""
    panel = tpu_ccheck.load_mt311()
    sample = T.ccheck_sample(seed=5)[1]
    d, aln_con, aln_ass = myers_diff(panel, Mode.GLOBAL, sample, len(panel) // 10)
    assert d > 0 and "-" in aln_con and "-" in aln_ass
    n = len(sample)
    reads = read_ma(sample_maln).aln_seqs
    ks = [s.start for s in reads] + [0, 1, n - 1, n, n + 1, n + 2]
    spans = [(s.start, s.end + k) for s in reads for k in (1, 2)]
    spans += [(s, e) for s in (0, n - 3, n - 1, n, n + 1) for e in (n - 1, n, n + 1, n + 2)]
    dp_spans = [(0, 2**31 - 1), (2000, 15000), (100, 9000), (1, 1500), (n - 5, n + 5)]
    check_index(aln_con, aln_ass, ks, spans, dp_spans)


# ---- ccheck on a circular sample with split reads ----

@pytest.fixture(scope="module")
def sample_maln(tmp_path_factory):
    """The final maln of a circular assembly (the port's mia, ``--engine
    native``) of 300 reads of a ccheck sample, 40 of its contaminant and 8
    that cross the origin, so that the assembly holds ``_f``/``_b`` halves."""
    d = tmp_path_factory.mktemp("ccheck_walks")
    reference, sample, contaminant = T.ccheck_sample(seed=5)
    (d / "ref.fna").write_text(">ref\n" + reference + "\n")
    with open(d / "reads.fastq", "w") as f:
        for tag, src, n, seed in (("e", sample, 300, 11), ("c", contaminant, 40, 12)):
            for name, seq, qual in simulate_reads(src, SimConfig(num_reads=n, seed=seed)):
                f.write(f"@{tag}_{name}\n{seq}\n+\n{qual}\n")
        for k in range(8, 56, 6):
            seq = sample[len(sample) - k :] + sample[: 60 - k]
            f.write(f"@w_{k}\n{seq}\n+\n{'I' * len(seq)}\n")
    root = str(d / "out.maln")
    rc, _, err = run_in_process(port_mia, [
        "-r", str(d / "ref.fna"), "-f", str(d / "reads.fastq"), "-c", "-u", "-k", "12",
        "-s", SUBMAT, "-m", root, "--engine", "native"])
    assert rc == 0, err
    return port_ccheck.find_maln(root + ".1")


def run_in_process(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_sample_has_split_reads(sample_maln):
    segments = [s.segment for s in read_ma(sample_maln).aln_seqs]
    assert segments.count("f") >= 1 and segments.count("b") >= 1, segments
    assert len(segments) >= 300


@pytest.mark.parametrize("engine", ["torch", "native"])
@pytest.mark.parametrize("opts", [["-a"], ["-s", "2000-15000"]], ids=["a", "s"])
def test_ccheck_sample_matches_mia_tpu(opts, engine, sample_maln, monkeypatch):
    monkeypatch.setenv("MIA_TORCH_DEVICE", "cpu")
    want = run_in_process(tpu_ccheck.main, ["--engine", "numpy", *opts, sample_maln])
    port_ccheck.reset_counts()
    got = run_in_process(port_ccheck.main, ["--engine", engine, *opts, sample_maln])
    assert got == want
    assert got[0] == 0 and "polluting fragments" in got[1]
    c = port_ccheck.counts()
    if engine == "native":
        assert set(c.values()) == {0}, c
        return
    # the Myers alignment and the realignment as plain versions (CPU tensors),
    # never as a kernel here, and every read realigned by the scorer
    assert (c["myers.plain_calls"], c["myers.kernel_launches"]) == (1, 0), c
    assert c["dp.plain_calls"] > 0 and c["dp.kernel_launches"] == 0, c
    n_reads = len(read_ma(sample_maln).aln_seqs)
    assert c["ccheck.device_entries"] + c["ccheck.host_entries"] == n_reads, c
    assert c["ccheck.device_entries"] > 0, c
