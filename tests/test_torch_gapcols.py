"""The port's gap-column host code against ``mia_tpu``'s.

``mia_tpu_torch/core/fsdb.py`` recounts the cull's largest insertion per
column in one pass over the records' insertions, and
``mia_tpu_torch/core/columns.py`` calls every insertion column's consensus
in one batch; ``mia_tpu`` keeps the reference's loops (every record for
every gap column, one accumulator per column).  The rest of both files is
still ``mia_tpu``'s, function by function.  Every comparison runs the two
packages' functions on the same state, captured from ``mia_tpu``'s host
engine (``--engine native``) on the goldens' inputs and on seeded reads
with homopolymer-length errors.
"""
import ast
import contextlib
import copy
import io
import os

import numpy as np
import pytest

import mia_tpu.core.assembler as tpu_assembler
from benchmark.cells import homopolymer_indels, homopolymer_share
from mia_tpu.cli import mia as tpu_mia
from mia_tpu.core import columns as tpu_columns
from mia_tpu.core import fsdb as tpu_fsdb
from mia_tpu.core import types as tpu_types
from mia_tpu.models.simulate import SimConfig, random_reference, simulate_reads
from mia_tpu_torch.core import columns as port_columns
from mia_tpu_torch.core import fsdb as port_fsdb
from mia_tpu_torch.core import types as port_types

from .test_torch_golden import fixture_args
from .test_torch_host_copies import REPO, _normalised

# top-level definitions each package has on its own account
REWRITTEN = {
    "core/fsdb.py": {"cull_maln_from_fsdb"},
    "core/columns.py": {"_covering", "_record_spans", "insertion_consensus",
                        "find_ins_cons", "consensus_assembly_string"},
}


def _top_level(package: str, path: str) -> list[str]:
    """The file's top-level statements as AST dumps, the module docstring
    and the rewritten definitions left out."""
    with open(os.path.join(REPO, package, path)) as f:
        body = ast.parse(_normalised(f.read())).body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    return [ast.dump(node) for node in body
            if getattr(node, "name", None) not in REWRITTEN[path]]


@pytest.mark.parametrize("path", sorted(REWRITTEN))
def test_rest_of_file_equals_mia_tpu(path):
    port, tpu = _top_level("mia_tpu_torch", path), _top_level("mia_tpu", path)
    assert len(port) == len(tpu) and port == tpu


# ---- state captured from mia_tpu's host engine ----

SIM_SEEDS = (1, 2, 3)


def _write_sim(d, seed: int) -> list[str]:
    """A 3 kb reference and 300 reads from it with homopolymer-length
    errors at the -h cell's rate (0.38 per 100 bases, min run 2), and the
    cell's matrix, whose scores depend on depth and strand."""
    ref = random_reference(3000, seed=100 + seed)
    rng = np.random.default_rng([seed, 1])
    per_run_base = 0.0038 / homopolymer_share(ref, 2)
    ref_fn, reads_fn = os.path.join(d, "ref.fna"), os.path.join(d, "reads.fastq")
    with open(ref_fn, "w") as f:
        f.write(">ref\n" + ref + "\n")
    with open(reads_fn, "w") as f:
        for name, seq, qual in simulate_reads(ref, SimConfig(num_reads=300, seed=seed)):
            seq, qual, _ = homopolymer_indels(seq, qual, per_run_base, 2, rng)
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")
    return ["-r", ref_fn, "-f", reads_fn, "-h", "-c", "-s",
            os.path.join(REPO, "mia_tpu", "data", "matrices", "ancient.submat.solexa.pe.txt")]


_CAPTURED: dict = {}


def captured(name: str, tmp_dir) -> dict:
    """One ``mia_tpu --engine native`` run of the input ``name`` (a golden
    config or ``sim<seed>``), with a copy of the state before every cull
    and of the maln at every consensus."""
    if name in _CAPTURED:
        return _CAPTURED[name]
    d = tmp_dir / name
    d.mkdir()
    args = (_write_sim(str(d), int(name[3:])) if name.startswith("sim")
            else fixture_args(name))
    culls, malns = [], []
    real_cull = tpu_assembler.cull_maln_from_fsdb
    real_cons = tpu_assembler.consensus_assembly_string

    def cull(culled, fsdb, *rest):
        culls.append(copy.deepcopy((culled, fsdb, rest)))
        return real_cull(culled, fsdb, *rest)

    def consensus(maln, *a, **k):
        malns.append(copy.deepcopy(maln))
        return real_cons(maln, *a, **k)

    cwd = os.getcwd()
    env = os.environ.pop("MIA_JAX_PLATFORM", None)
    tpu_assembler.cull_maln_from_fsdb = cull
    tpu_assembler.consensus_assembly_string = consensus
    try:
        os.chdir(d)
        with contextlib.redirect_stderr(io.StringIO()):
            assert tpu_mia.main([*args, "-m", "out.maln", "--engine", "native"]) == 0
    finally:
        os.chdir(cwd)
        tpu_assembler.cull_maln_from_fsdb = real_cull
        tpu_assembler.consensus_assembly_string = real_cons
        if env is not None:
            os.environ["MIA_JAX_PLATFORM"] = env
    assert culls and malns
    _CAPTURED[name] = {"culls": culls, "malns": malns}
    return _CAPTURED[name]


@pytest.fixture(scope="module")
def tmp_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("gapcols")


def _cull_both(state):
    """Both packages' culls, each on its own copy of ``state``; returns the
    two culled malns."""
    out = []
    for cull in (tpu_fsdb.cull_maln_from_fsdb, port_fsdb.cull_maln_from_fsdb):
        culled, fsdb, rest = copy.deepcopy(state)
        cull(culled, fsdb, *rest)
        out.append(culled)
    return out


def _assert_same_cull(tpu, port):
    assert np.array_equal(port.ref.gaps, tpu.ref.gaps)
    assert [(a.id, a.dropped) for a in port.aln_seqs] == [
        (a.id, a.dropped) for a in tpu.aln_seqs]


@pytest.mark.parametrize("seed", SIM_SEEDS)
def test_cull_equals_mia_tpu_on_hp_reads(seed, tmp_dir):
    culls = captured(f"sim{seed}", tmp_dir)["culls"]
    live = 0
    for state in culls:
        tpu, port = _cull_both(state)
        _assert_same_cull(tpu, port)
        live += int((tpu.ref.gaps > 0).sum())
    assert live > 0, "the reads put no insertion in the assembly"


# ---- the recount's edge cases, by hand ----

N = 20  # seq_len; gaps has N + 1 entries, as a circular wrap of 0 leaves it


def _edge_maln(types, gaps: dict, records: list):
    """A culled maln and its FSDB: ``records`` are (start, end, ins,
    dropped); a dropped record's read scores below the hard cut of 10."""
    g = np.zeros(N + 1, dtype=np.int32)
    for i, v in gaps.items():
        g[i] = v
    culled = types.MapAlignment(ref=types.RefSeq(seq_len=N, wrap_seq_len=N, gaps=g))
    fsdb = types.FSDB()
    for k, (start, end, ins, dropped) in enumerate(records):
        a = types.AlnSeq(id=f"r{k}", start=start, end=end, ins=dict(ins),
                         seq="A" * (end - start + 1), smp="A" * (end - start + 1))
        fsdb.fss.append(types.FragSeq(id=f"r{k}", seq_len=end - start + 1,
                                      score=1 if dropped else 100, unique_best=True,
                                      front_asp=a))
    return culled, fsdb


# (gaps before, records, {column: gaps after})
EDGES = {
    "key_0_excluded": ({5: 3}, [(5, 12, {0: "AA"}, False)], {5: 0}),
    "key_at_end": ({12: 5}, [(5, 12, {7: "GGG", 8: "TTTT"}, False)], {12: 3}),
    "at_or_past_seq_len": ({19: 2, 20: 4}, [(15, 24, {4: "T", 5: "TT", 6: "TTT"}, False)],
                           {19: 1, 20: 4}),
    "start_below_0": ({2: 4, 19: 1}, [(-3, 6, {2: "C", 5: "CC"}, False)], {2: 2, 19: 0}),
    "dropped_longest": ({8: 1}, [(2, 10, {6: "A"}, False), (4, 9, {4: "AAAA"}, True)],
                        {8: 4}),
    "uncovered_gap_column": ({3: 2, 9: 1}, [(5, 12, {4: "G"}, False)], {3: 0, 9: 1}),
    "no_gap_untouched": ({}, [(5, 12, {3: "GG"}, False)], {8: 0}),
}


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_cull_edge_cases(edge):
    gaps, records, want = EDGES[edge]
    tpu, port = (_edge_maln(types, gaps, records) for types in (tpu_types, port_types))
    tpu_fsdb.cull_maln_from_fsdb(*tpu, 10, True, 1.0, 0.0)
    port_fsdb.cull_maln_from_fsdb(*port, 10, True, 1.0, 0.0)
    _assert_same_cull(tpu[0], port[0])
    assert {i: int(port[0].ref.gaps[i]) for i in want} == want


# ---- the insertion columns' consensus ----

CONSENSUS_INPUTS = ["hp", "hp_k", "A454", "default", "sim1", "sim2"]


class Recorder:
    """A stand-in for the multi-host all-reduce: keeps a copy of every
    accumulator it is given, and doubles the counts (so the decision of a
    column whose accumulator was left out of the reduce would differ)."""

    def __init__(self):
        self.seen = []

    def __call__(self, cc):
        self.seen.append(copy.deepcopy(cc))
        for k in ("counts", "cov", "scores"):
            setattr(cc, k, 2 * getattr(cc, k))
        return cc


def _ins_positions(maln):
    gaps = maln.ref.gaps[: maln.ref.seq_len]
    return [p for p in np.flatnonzero(gaps > 0).tolist() if p > 0]


def _concat(ccs):
    return [np.concatenate([getattr(c, k) for c in ccs]) for k in ("counts", "cov", "scores")]


@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("name", CONSENSUS_INPUTS)
def test_consensus_equals_mia_tpu(name, reduce, tmp_dir):
    malns = captured(name, tmp_dir)["malns"]
    for maln in malns:
        rec_tpu, rec_port = (Recorder(), Recorder()) if reduce else (None, None)
        want = tpu_columns.consensus_assembly_string(copy.deepcopy(maln), reduce_cc=rec_tpu)
        got = port_columns.consensus_assembly_string(copy.deepcopy(maln), reduce_cc=rec_port)
        assert got == want
        if reduce:
            # the main columns, then every insertion column in one accumulator
            # holding what the per-column path reduced, column by column
            positions = _ins_positions(maln)
            assert len(rec_tpu.seen) == 1 + len(positions)
            assert len(rec_port.seen) == (2 if positions else 1)
            if positions:
                for a, b in zip(_concat(rec_port.seen[1:]), _concat(rec_tpu.seen[1:])):
                    assert np.array_equal(a, b)
    if name.startswith("sim"):
        assert any(_ins_positions(m) for m in malns)


@pytest.mark.parametrize("name", CONSENSUS_INPUTS)
def test_find_ins_cons_equals_mia_tpu(name, tmp_dir):
    maln = captured(name, tmp_dir)["malns"][-1]
    seen = 0
    for pos in [*_ins_positions(maln), 0, maln.ref.seq_len - 1]:
        want_chars, want_cc, want_frac = tpu_columns.find_ins_cons(maln, pos)
        chars, cc, frac = port_columns.find_ins_cons(maln, pos)
        assert np.array_equal(chars, want_chars) and np.array_equal(frac, want_frac)
        assert all(np.array_equal(a, b) for a, b in zip(_concat([cc]), _concat([want_cc])))
        seen += int(cc.cov.sum() > 0)
    assert seen > 0 or name in ("default", "A454")


def _hand_maln(types, seed: int):
    """A small maln of random records: insertions longer than their column's
    width, keys past the span, PSSM codes shorter than the span, both
    strands, dropped records, a gap at column 0 and gap columns no record
    covers; random matrices, so depth and strand move the scores."""
    rng = np.random.default_rng(seed)
    n = 30
    gaps = np.zeros(n + 1, dtype=np.int32)
    gaps[[0, 4, 10, 11, 20, 27]] = [2, 2, 3, 1, 4, 2]
    maln = types.MapAlignment(ref=types.RefSeq(seq_len=n, wrap_seq_len=n, gaps=gaps))
    maln.fpsm = rng.integers(-40, 40, (31, 5, 5)).astype(np.int32)
    maln.rpsm = rng.integers(-40, 40, (31, 5, 5)).astype(np.int32)
    recs = []
    for k in range(40):
        start = int(rng.integers(-3, 24))
        span = int(rng.integers(4, 16))
        smp_len = max(0, span - int(rng.integers(0, 6))) if rng.random() < 0.3 else span
        ins = {int(key): "".join(rng.choice(list("ACGTN-"), int(rng.integers(1, 7))))
               for key in rng.integers(0, span + 2, int(rng.integers(0, 5)))}
        recs.append(types.AlnSeq(
            id=f"h{k}", start=start, end=start + span - 1, ins=ins,
            seq="".join(rng.choice(list("ACGT-N"), span)),
            smp="".join(chr(65 + int(d)) for d in rng.integers(0, 31, smp_len)),
            revcom=bool(rng.random() < 0.5), dropped=bool(rng.random() < 0.2)))
    maln.set_aln_seqs(recs)
    return maln


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_consensus_hand_made(seed):
    for reduce in (False, True):
        rec_tpu, rec_port = (Recorder(), Recorder()) if reduce else (None, None)
        want = tpu_columns.consensus_assembly_string(_hand_maln(tpu_types, seed),
                                                     reduce_cc=rec_tpu)
        got = port_columns.consensus_assembly_string(_hand_maln(port_types, seed),
                                                     reduce_cc=rec_port)
        assert got == want
        if reduce:
            assert len(rec_port.seen) == 2 and len(rec_tpu.seen) == 6
            for a, b in zip(_concat(rec_port.seen[1:]), _concat(rec_tpu.seen[1:])):
                assert np.array_equal(a, b)
    tpu, port = _hand_maln(tpu_types, seed), _hand_maln(port_types, seed)
    for pos in range(30):
        want_chars, want_cc, want_frac = tpu_columns.find_ins_cons(tpu, pos)
        chars, cc, frac = port_columns.find_ins_cons(port, pos)
        assert np.array_equal(chars, want_chars) and np.array_equal(frac, want_frac)
        assert all(np.array_equal(a, b) for a, b in zip(_concat([cc]), _concat([want_cc])))
