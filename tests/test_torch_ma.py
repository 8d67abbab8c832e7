"""The port's host tools: ``ma`` (``cli/ma.py``, ``io/formats.py``,
``io/align_reader.py``), ``easy_consensus`` and the damage-model fit
(``models/estimate.py``), held to ``mia_tpu``'s on the committed goldens,
byte for byte.  None of them does device work; the port's ``ma`` differs from
the JAX package's only by its platform override, which is gone."""
import contextlib
import io
import os
from dataclasses import asdict

import numpy as np
import pytest

from mia_tpu.cli import easy_consensus as tpu_ec
from mia_tpu.cli import ma as tpu_ma
from mia_tpu.io.align_reader import iter_align_aln as tpu_iter_align_aln
from mia_tpu.io.maln import read_ma as tpu_read_ma
from mia_tpu.io.maln import write_ma as tpu_write_ma
from mia_tpu.models import estimate as tpu_estimate
from mia_tpu_torch.cli import easy_consensus, ma
from mia_tpu_torch.constants import PSSM_DEPTH
from mia_tpu_torch.io.align_reader import iter_align_aln
from mia_tpu_torch.io.maln import read_ma, write_ma
from mia_tpu_torch.io.pssm_io import read_pssm
from mia_tpu_torch.models.estimate import count_substitutions, estimate_from_maln, fit_pssm

from .conftest import FIXTURES, GOLDEN
from .test_more_io import _assert_roundtrip

# kmer's first iteration (its reference differs from its consensus, so -f 4
# prints rows) and sim200's last (insertion columns)
MALNS = ["kmer/out.maln.1", "sim200/out.maln.2"]
FORMATS = ["1", "2", "3", "4", "41", "5", "6", "61", "7"]


def _stdout(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("maln", MALNS)
def test_ma_format_equals_mia_tpu(maln, fmt):
    argv = ["-M", os.path.join(GOLDEN, maln), "-f", fmt]
    got = _stdout(ma.main, argv)
    assert got, "ma printed nothing"
    assert got == _stdout(tpu_ma.main, argv)


@pytest.mark.parametrize("extra", [
    ["-f", "6", "-R", "5:60"], ["-f", "61", "-R", "40:12"], ["-f", "6", "-R", "5:40", "-C"],
    ["-f", "3", "-c", "2"], ["-f", "5", "-I", "renamed"], ["-f", "4", "-s", "2", "-b", "1"],
], ids=["region", "region_swapped", "color", "cons_code_2", "assign_id", "score_line"])
def test_ma_options_equal_mia_tpu(extra):
    argv = ["-M", os.path.join(GOLDEN, "sim200", "out.maln.2"), *extra]
    assert _stdout(ma.main, argv) == _stdout(tpu_ma.main, argv)


def test_ma_writes_mia_tpus_maln(tmp_path):
    src = os.path.join(GOLDEN, "sim200", "out.maln.2")
    for tag, main in (("port", ma.main), ("tpu", tpu_ma.main)):
        _stdout(main, ["-M", src, "-f", "5", "-m", str(tmp_path / tag)])
    port, tpu = ((tmp_path / t).read_bytes().split(b"\n")[1:] for t in ("port", "tpu"))
    assert port and port == tpu


def test_ma_help_without_input():
    assert _stdout(ma.main, ["-f", "2"]) == _stdout(tpu_ma.main, ["-f", "2"])
    assert "ma -M <maln input file>" in _stdout(ma.main, [])


@pytest.mark.parametrize("src", ["default/out.maln.4", "sim200/out.maln.2"],
                         ids=["plain", "with_inserts"])
def test_maln_roundtrip(src, tmp_path):
    src = os.path.join(GOLDEN, src)
    write_ma(str(tmp_path / "rt.maln"), read_ma(src))
    _assert_roundtrip(src, tmp_path / "rt.maln")
    tpu_write_ma(str(tmp_path / "tpu.maln"), tpu_read_ma(src))
    assert ((tmp_path / "rt.maln").read_bytes().split(b"\n")[1:]
            == (tmp_path / "tpu.maln").read_bytes().split(b"\n")[1:])


def test_align_reader(tmp_path):
    p = tmp_path / "t.aln"
    p.write_text(
        ">ref + 11-16 score=1200\n"
        "--ACGTAC\n"
        ">frag1 something\n"
        "--ACGTA-\n"
        ">ref - 21-24 score=-500\n"
        "ACGT\n"
        ">frag2 with adapter cut off\n"
        "AGGT\n"
    )
    recs = list(iter_align_aln(str(p)))
    assert len(recs) == 2
    a, b = recs
    assert (a.start, a.end) == (12, 14)
    assert a.ref_seq == "ACGTA" and a.frag_seq == "ACGTA"
    assert a.score == 1200 and not a.revcom and not a.trimmed
    assert b.revcom and b.trimmed and b.score == -500
    assert b.ref_seq == "GTACGT"[2:]
    assert b.frag_seq == "ACCT"
    assert [asdict(r) for r in recs] == [asdict(r) for r in tpu_iter_align_aln(str(p))]


def test_easy_consensus_calls():
    call_cons, to_ambicode, to_nucleotide = (
        easy_consensus.call_cons, easy_consensus.to_ambicode, easy_consensus.to_nucleotide)
    assert call_cons("AAAA", 1.0, to_ambicode) == "A"
    assert call_cons("AAAT", 1.0, to_ambicode) == "W"
    assert call_cons("AAAT", 0.5, to_ambicode) == "A"
    assert call_cons("AA--", 1.0, to_ambicode) == "a"  # optional gap
    assert call_cons("NNNN", 1.0, to_ambicode) == "A"  # all-uncounted quirk
    assert call_cons("ACGT", 1.0, to_nucleotide) == "N"
    assert easy_consensus.consensus(["AC-T", "ACGT"], 1.0, to_ambicode) == "ACgT"
    rng = np.random.default_rng(5)
    for _ in range(200):
        col = "".join(rng.choice(list("ACGT-N"), rng.integers(0, 12)))
        pct = float(rng.choice([0.3, 0.5, 0.9, 1.0]))
        for fn in ("to_ambicode", "to_nucleotide"):
            assert call_cons(col, pct, getattr(easy_consensus, fn)) == tpu_ec.call_cons(
                col, pct, getattr(tpu_ec, fn)), (col, pct, fn)


@pytest.mark.parametrize("flags", [[], ["-p", "60"], ["-n"], ["-i", "-p", "80"], ["-g"]],
                         ids=["default", "p60", "only_n", "iupac_p80", "gaps"])
def test_easy_consensus_cli_equals_mia_tpu(flags, tmp_path):
    panel = os.path.join(FIXTURES, "tf.fna")
    got = _stdout(easy_consensus.main, [*flags, panel])
    assert got.startswith(">consensus\n")
    assert got == _stdout(tpu_ec.main, [*flags, panel])
    easy_consensus.main([*flags, "-o", str(tmp_path / "c.fa"), panel])
    assert (tmp_path / "c.fa").read_text() == got


def test_estimate_roundtrip(tmp_path):
    src = os.path.join(GOLDEN, "sim200", "out.maln.2")
    out = tmp_path / "fit.submat.txt"
    scores = estimate_from_maln(read_ma(src), str(out))
    assert scores.shape == (31, 4, 4)
    sm = read_pssm(str(out))
    np.testing.assert_array_equal(sm[:, :4, :4], scores)
    assert (sm[:, :4, 4] == -100).all()
    assert (sm[:, 4, :] == -10).all()
    want = tpu_estimate.estimate_from_maln(tpu_read_ma(src), str(tmp_path / "tpu.txt"))
    assert np.array_equal(scores, want)
    assert out.read_bytes() == (tmp_path / "tpu.txt").read_bytes()


def test_estimate_sees_end_damage():
    maln = read_ma(os.path.join(GOLDEN, "sim200", "out.maln.2"))
    counts = count_substitutions(maln)
    assert np.array_equal(counts, tpu_estimate.count_substitutions(
        tpu_read_ma(os.path.join(GOLDEN, "sim200", "out.maln.2"))))
    scores = fit_pssm(counts)
    assert scores[0, 1, 3] > scores[PSSM_DEPTH, 1, 3]  # C->T at the 5' end
    for d in (0, PSSM_DEPTH, 30):
        for b in range(4):
            assert scores[d, b, b] > 100
