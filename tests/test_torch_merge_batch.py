"""The port's array-driven pass-1 drain and merge and its array-driven
realignment (``mia_tpu_torch.core.assembler`` / ``core.driver``) against the
per-read path they replace, on the CPU.

* ``finish_gapfree`` against ``finish_alignment`` (the port's and the JAX
  package's) and ``merge_realigned_gapfree`` against ``merge_realigned``, on
  hand-made reads: the same pool slots, ``AlnSeq`` and ``FragSeq`` fields,
  ``front_asp`` / ``back_asp`` identity and FSDB entries.
* ``plan_batch``, ``realign_windows`` and ``entries.longest_runs`` against
  the per-read logic they replace, and ``entries.diag_gapfree`` against the
  JAX package's on seeded inputs.
* Whole runs of the port's mia (``--engine torch``, plain versions of the
  kernels): every pass-1 and realignment state, and every maln byte, equal
  a run whose fast merges are turned off, so that every read takes
  ``finish_alignment`` / ``merge_realigned``.

Tolerance: exact equality everywhere.
"""
import copy
import os

import numpy as np
import pytest
import torch

from mia_tpu.core import driver as tpu_driver
from mia_tpu.core import jax_engine
from mia_tpu_torch.cli import mia as port_mia
from mia_tpu_torch.constants import FIRST_ROUND_SCORE_CUTOFF, PSSM_DEPTH, REALIGN_BUFFER
from mia_tpu_torch.core import assembler, driver, entries
from mia_tpu_torch.core.hostbatch import FLAG_HOST_ONLY, FLAG_SKIP, FLAG_WIDE, BatchHost
from mia_tpu_torch.core.merge import add_ref_wrap
from mia_tpu_torch.core.types import FSDB, AlnSeq, FragSeq, MapAlignment, RefSeq
from mia_tpu_torch.models.simulate import SimConfig, random_reference, simulate_reads
from mia_tpu_torch.utils.encoding import encode_seq, revcom

from .test_torch_golden import _norm

CUT = FIRST_ROUND_SCORE_CUTOFF
SLOT_FIELDS = ("id", "desc", "seq", "smp", "ins", "start", "end", "score", "num_inputs",
               "segment", "revcom", "trimmed", "dropped")
FS_FIELDS = ("id", "desc", "seq", "qual", "qual_sum", "trim_point", "trimmed", "seq_len",
             "strand_known", "rc", "as_", "ae", "score", "back_fresh", "unique_best",
             "num_inputs", "qss", "gid")


def state(maln: MapAlignment, fsdb: FSDB) -> dict:
    """Every pool slot's fields, the live count, and every FSDB read's fields
    with its slots named by their place in the pool."""
    where = {id(s): k for k, s in enumerate(maln.pool)}

    def slot(s):
        return None if s is None else where.get(id(s), "outside the pool")

    return {
        "num_aln_seqs": maln.num_aln_seqs,
        "pool": [{f: getattr(s, f) for f in SLOT_FIELDS} for s in maln.pool],
        "fss": [{**{f: getattr(fs, f) for f in FS_FIELDS}, "front": slot(fs.front_asp),
                 "back": slot(fs.back_asp)} for fs in fsdb.fss],
        "gaps": None if maln.ref.gaps is None else maln.ref.gaps.tolist(),
    }


# --- pass 1: finish_gapfree against finish_alignment ------------------------

REF_LEN = 400


def _maln(distant: bool = False) -> MapAlignment:
    """A circular 400-base reference and a pool of four used slots, two of
    them live: merges reuse slot 2 with its stale ``dropped`` and ``smp``."""
    seq = random_reference(REF_LEN, seed=5)
    m = MapAlignment()
    m.ref = RefSeq(id="ref", desc="d", seq=seq, rcseq=revcom(seq), seq_len=REF_LEN,
                   size=REF_LEN + 1)
    add_ref_wrap(m.ref)
    m.ref.gaps = np.zeros(m.ref.wrap_seq_len + 1, np.int64)
    m.distant_ref = distant
    m.pool = [AlnSeq(id=f"old{k}", seq="ACGT", smp="ABCD", dropped=k % 2 == 0, start=k)
              for k in range(4)]
    m.num_aln_seqs = 2
    return m


def _read(maln, rc: bool, start: int, length: int, trim: int | None = None,
          prev: FragSeq | None = None) -> FragSeq:
    """A read that is exactly the reference strand's columns start..start +
    length - 1 (the wrapped strand, so a span may run past seq_len), plus an
    adapter tail cut at ``trim`` when given."""
    strand = maln.ref.rcseq if rc else maln.ref.seq
    seq = strand[start : start + length]
    f = FragSeq(id=f"r{start}{'r' if rc else 'f'}", desc="x", qual_sum=7)
    if trim is not None:
        seq = seq[:trim] + "GGCCTTGGAA"
        f.trimmed, f.trim_point = True, trim - 1
    f.seq, f.seq_len = seq, len(seq)
    f.qual = "".join(chr(33 + (k * 7) % 40) for k in range(len(seq)))
    if prev is not None:
        f.front_asp, f.back_asp = prev.front_asp, prev.back_asp
    return f


PASS1_CASES = {
    # name: (rc, start, length, score, trim, distant)
    "fw": (False, 30, 60, CUT + 5000, None, False),
    "rc": (True, 50, 48, CUT + 5000, None, False),
    "fw_trimmed": (False, 100, 70, CUT + 5000, 55, False),
    "rc_trimmed": (True, 120, 70, CUT + 5000, 41, False),
    "fw_past_the_origin": (False, REF_LEN - 20, 50, CUT + 5000, None, False),
    "rc_past_the_origin": (True, REF_LEN - 25, 60, CUT + 5000, None, False),
    "gated": (True, 200, 40, CUT - 1, None, False),
    "at_the_cutoff": (True, 210, 40, CUT, None, False),
    "distant_below_the_cutoff": (True, 220, 40, CUT - 900, None, True),
    "distant_fw": (False, 230, 40, CUT + 10, None, True),
}


@pytest.mark.parametrize("case", sorted(PASS1_CASES))
def test_finish_gapfree_equals_finish_alignment(case):
    rc, start, length, score, trim, distant = PASS1_CASES[case]
    base = _maln(distant)
    fs = _read(base, rc, start, length, trim)
    abc, aec = start, start + (trim or length) - 1
    strand = base.ref.rcseq if rc else base.ref.seq
    used = trim or length
    pw = (strand[abc : aec + 1], fs.seq[:used])
    assert "-" not in pw[0] and len(pw[0]) == len(pw[1])

    want = {}
    for name, finish in (("port", driver.finish_alignment),
                         ("jax package", tpu_driver.finish_alignment)):
        maln, f, db = copy.deepcopy((base, fs, FSDB()))
        finish(maln, f, db, rc, score, abc, aec, pw)
        want[name] = (state(maln, db), {k: getattr(f, k) for k in FS_FIELDS})
    assert want["port"] == want["jax package"]

    maln, f, db = copy.deepcopy((base, fs, FSDB()))
    before = state(maln, db), {k: getattr(f, k) for k in FS_FIELDS}
    took = driver.finish_gapfree(maln, f, db, rc, score, abc, aec)
    assert took == ("past_the_origin" not in case)
    if not took:
        # a span across the origin: untouched, the caller splits it
        assert (state(maln, db), {k: getattr(f, k) for k in FS_FIELDS}) == before
        driver.finish_alignment(maln, f, db, rc, score, abc, aec, pw)
    assert (state(maln, db), {k: getattr(f, k) for k in FS_FIELDS}) == want["port"]


# --- realignment: merge_realigned_gapfree against merge_realigned ------------

REALIGN_CASES = {
    # name: (rc, abc, length, split in pass 1, num_inputs, trimmed)
    "fw": (False, 40, 60, False, 1, False),
    "rc": (True, 140, 45, False, 3, True),
    "past_the_origin": (False, REF_LEN - 15, 40, False, 1, False),
    "stale_back_asp": (True, 300, 50, True, 1, False),
    "ends_at_seq_len": (False, REF_LEN - 40, 41, False, 2, False),
}


@pytest.mark.parametrize("case", sorted(REALIGN_CASES))
def test_merge_realigned_gapfree_equals_merge_realigned(case):
    rc, abc, length, split, num_inputs, trimmed = REALIGN_CASES[case]
    base = _maln()
    # the realignment runs against the forward consensus; the FSDB holds
    # reads in reference orientation
    fs = _read(base, False, abc, length)
    fs.rc, fs.num_inputs, fs.trimmed, fs.strand_known = rc, num_inputs, trimmed, True
    if split:
        # pass 1 split this read: its back half still names slot 1
        fs.front_asp, fs.back_asp, fs.back_fresh = base.pool[0], base.pool[1], True
    aec = abc + length - 1
    pw = (base.ref.seq[abc : aec + 1], fs.seq)

    maln, f = copy.deepcopy((base, fs))
    driver.merge_realigned(maln, f, 9000, abc, aec, pw)
    db = FSDB()
    db.add(f)
    want = state(maln, db)
    if split:
        assert want["fss"][0]["back"] == 1 and not want["fss"][0]["back_fresh"]

    maln, f = copy.deepcopy((base, fs))
    db = FSDB()
    db.add(f)
    before = state(maln, db)
    took = driver.merge_realigned_gapfree(maln, f, 9000, abc, aec)
    assert took == (case != "past_the_origin")
    if not took:
        assert state(maln, db) == before
        driver.merge_realigned(maln, f, 9000, abc, aec, pw)
    assert state(maln, db) == want


# --- the array forms against the per-read logic they replace ----------------

def _plan_per_read(flags, fb, fa, rb, ra, distant):
    """The drain's per-read selection as it was: flags first, then the
    strand, the gate and the winner."""
    out = []
    for i, fl in enumerate(flags):
        if fl & FLAG_SKIP:
            out.append((assembler.SKIP,))
        elif fl & FLAG_HOST_ONLY:
            out.append((assembler.HOST,))
        elif fl & FLAG_WIDE:
            out.append((assembler.WIDE,))
        else:
            rc = not (fb[i] > rb[i])
            best = int(rb[i] if rc else fb[i])
            if best < CUT and not distant:
                out.append((assembler.GATED, best))
            else:
                out.append((assembler.TRACED, rc, best, int(ra[i] if rc else fa[i])))
    return out


@pytest.mark.parametrize("distant", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_batch_equals_per_read(seed, distant):
    rng = np.random.default_rng(seed)
    n = 500
    flags = rng.choice([0, 0, 0, 0, FLAG_SKIP, FLAG_HOST_ONLY, FLAG_WIDE,
                        FLAG_SKIP | FLAG_WIDE, FLAG_HOST_ONLY | FLAG_WIDE, 7], n).astype(np.int32)
    fb = rng.integers(CUT - 300, CUT + 300, n).astype(np.int32)
    rb = np.where(rng.random(n) < 0.2, fb, rng.integers(CUT - 300, CUT + 300, n)).astype(np.int32)
    fa = rng.integers(0, 20000, n).astype(np.int64)
    ra = rng.integers(0, 20000, n).astype(np.int64)
    kind, rc, best, aec = assembler.plan_batch(flags, fb, fa, rb, ra, distant)
    got = []
    for i in range(n):
        k = int(kind[i])
        if k == assembler.GATED:
            got.append((k, int(best[i])))
        elif k == assembler.TRACED:
            got.append((k, bool(rc[i]), int(best[i]), int(aec[i])))
        else:
            got.append((k,))
    assert got == _plan_per_read(flags, fb, fa, rb, ra, distant)
    assert {assembler.GATED, assembler.TRACED} <= set(kind.tolist()) or distant


def _window_per_read(as_, ae, len2, wrap):
    """The realignment's window as it was (src/mia_main.c:191-212)."""
    ref_start = max(as_ - REALIGN_BUFFER, 0)
    ref_end = wrap if ae + REALIGN_BUFFER + 1 > wrap else ae + REALIGN_BUFFER
    if ref_start + len2 > ref_end:
        ref_start, ref_end = 0, wrap
    return ref_start, ref_end


@pytest.mark.parametrize("seed", [0, 1])
def test_realign_windows_equal_per_read(seed):
    rng = np.random.default_rng(seed)
    wrap = 16825
    n = 2000
    as_ = rng.integers(-10, wrap + 300, n)
    ae = as_ + rng.integers(-200, 300, n)
    len2 = rng.integers(0, 257, n)
    lo, hi = driver.realign_windows(as_, ae, len2, wrap)
    want = [_window_per_read(int(a), int(e), int(k), wrap) for a, e, k in zip(as_, ae, len2)]
    assert list(zip(lo.tolist(), hi.tolist())) == want
    assert [tuple(int(v) for v in driver.realign_windows(int(a), int(e), int(k), wrap))
            for a, e, k in zip(as_[:50], ae[:50], len2[:50])] == want[:50]


def _hp_reads(seed: int) -> list[str]:
    """Reads with homopolymer runs of 28-36 bases (around HPW_ROUTE), at the
    start, the end or inside, short reads and empty ones."""
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(300):
        kind = rng.integers(0, 5)
        if kind == 0:
            reads.append("")
        elif kind == 1:
            reads.append("".join(rng.choice(list("ACGT"), rng.integers(1, 40))))
        else:
            run = str(rng.choice(list("ACGTN"))) * int(rng.integers(28, 37))
            left = "".join(rng.choice(list("ACGT"), rng.integers(0, 60)))
            right = "".join(rng.choice(list("ACGT"), rng.integers(0, 60)))
            reads.append({2: run + right, 3: left + run, 4: left + run + right}[int(kind)])
    return reads


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_longest_runs_route_like_hp_routes_to_host(seed):
    reads = _hp_reads(seed)
    want = [entries.hp_routes_to_host(r) for r in reads]
    assert want == [jax_engine.hp_routes_to_host(r) for r in reads]
    assert 20 < sum(want) < len(reads) - 20
    arena, off, lens = BatchHost.pack_reads(reads)
    for o in (off, off[:-1]):
        assert (entries.longest_runs(arena, o, lens) >= entries.HPW_ROUTE).tolist() == want
    # a subset in another order, read in place from the same arena
    pick = np.random.default_rng(seed).permutation(len(reads))[:150]
    got = entries.longest_runs(arena, off[:-1][pick], lens[pick]) >= entries.HPW_ROUTE
    assert got.tolist() == [want[k] for k in pick]


def _diag_sums(reads, abcs, sel, ref_fw, ref_rc, sm, sm_sel):
    """Each read's diagonal sum, one term at a time (src/pssm.c:36-46)."""
    out = []
    for k, r in enumerate(reads):
        codes, total = encode_seq(r), 0
        for row, b in enumerate(codes):
            fb = len(r) - row - 1
            d = row if row < PSSM_DEPTH else (2 * PSSM_DEPTH - fb if fb < PSSM_DEPTH
                                              else PSSM_DEPTH)
            c = min(max(abcs[k] + row, 0), len(ref_fw) - 1)
            s1 = (ref_rc if sel[k] == 1 else ref_fw)[c]
            table = sm[sm_sel[k]] if sm.ndim == 4 else sm
            total += int(table[min(max(d, 0), 2 * PSSM_DEPTH), s1, b])
        out.append(total)
    return np.array(out, np.int64)


def assert_diag_gapfree_equal(seed: int, ndim: int) -> None:
    """``entries.diag_gapfree`` returns the JAX package's arrays on seeded
    reads: most score their diagonal exactly, some miss it by one, empty
    reads, uncovered spans, spans past either end of the reference."""
    rng = np.random.default_rng(seed)
    len1 = int(rng.integers(150, 400))
    ref_fw = encode_seq("".join(rng.choice(list("ACGTN"), len1)))
    ref_rc = encode_seq("".join(rng.choice(list("ACGT"), len1)))
    n = 120
    lens = rng.integers(0, 70, n)
    lens[:3] = 0
    reads = ["".join(rng.choice(list("ACGTNa-"), k)) for k in lens]
    sel = rng.integers(0, 2, n).astype(np.uint8)
    aec = rng.integers(-5, len1 + 40, n).astype(np.int64)
    ivg = np.zeros((n, 3, 2), np.int64)
    for k in range(n):
        for j in range(int(rng.integers(0, 4))):
            a = int(rng.integers(-10, len1))
            ivg[k, j] = (a, a + int(rng.integers(0, len1 + 20)))
        if rng.random() < 0.6:
            ivg[k, 0] = (0, len1 + int(rng.integers(0, 60)))
    sm = rng.integers(-900, 900, (2, 31, 5, 5) if ndim == 4 else (31, 5, 5)).astype(np.int32)
    sm_sel = rng.integers(0, 2, n).astype(np.int8)
    arena, off, _ = BatchHost.pack_reads(reads)
    abcs = aec - lens + 1
    # most reads score their diagonal exactly, some miss it by one, three
    # empty reads score 0 or 1
    bests = _diag_sums(reads, abcs, sel, ref_fw, ref_rc, sm, sm_sel)
    bests += (rng.random(n) < 0.25).astype(np.int64)
    order = rng.permutation(n)
    args = (arena, off[:-1][order], lens[order], bests[order], aec[order], ivg[order],
            ref_fw, ref_rc, sel[order], sm)
    ok, abc = entries.diag_gapfree(*args, sm_sel=sm_sel[order])
    ok_j, abc_j = jax_engine.diag_gapfree(*args, sm_sel=sm_sel[order])
    assert ok.tolist() == ok_j.tolist() and abc.tolist() == abc_j.tolist()
    assert abc.dtype == abc_j.dtype == np.int32
    assert 10 < ok.sum() < n - 10


@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_diag_gapfree_equals_jax_engine(seed, ndim):
    assert_diag_gapfree_equal(seed, ndim)


# --- whole runs: the fast merges against the per-read path -------------------

@pytest.fixture(scope="module")
def one_torch_thread():
    """The plain versions' tensors are small: one thread a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ADAPTER = "GGCCTTGGAA"


def _write_inputs(d, seed: int, dash: bool) -> tuple[str, str]:
    """A 3,000-base circular reference and 400 simulated reads with indels,
    plus reads across the origin on both strands, reads with adapters, reads
    with 34-40-base homopolymer runs and random reads the gate rejects.
    Under ``dash`` the reference holds '--' at column 2,500 and the reads
    come from its first 2,000 columns (a read across a '-' of the
    reference is no input the assembler handles)."""
    ref = random_reference(3000, seed=seed)
    rng = np.random.default_rng(seed)
    source = ref[:2000] if dash else ref
    reads = [(name, seq) for name, seq, _ in simulate_reads(
        source, SimConfig(num_reads=400, seed=seed, indel_rate=0.01, circular=not dash))]
    for k in range(20):
        if not dash:
            span = ref[-int(rng.integers(10, 50)):] + ref[: int(rng.integers(10, 50))]
            reads.append((f"origin{k}", revcom(span) if k % 2 else span))
        s = int(rng.integers(0, len(source) - 100))
        reads.append((f"adapter{k}", source[s : s + int(rng.integers(30, 70))] + ADAPTER))
        s = int(rng.integers(0, len(source) - 100))
        reads.append((f"hp{k}", source[s : s + 25] + "A" * int(rng.integers(34, 41))
                      + source[s + 25 : s + 45]))
        reads.append((f"random{k}", "".join(rng.choice(list("ACGT"), 60))))
    ref_fn, frag_fn = os.path.join(d, "ref.fna"), os.path.join(d, "reads.fastq")
    if dash:
        ref = ref[:2500] + "--" + ref[2500:]
    with open(ref_fn, "w") as f:
        f.write(">ref\n" + "\n".join(ref[k : k + 70] for k in range(0, len(ref), 70)) + "\n")
    with open(frag_fn, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
    return ref_fn, frag_fn


RUNS = {
    "circular_k": ["-c", "-k", "12"],
    "adapter": ["-c", "-k", "12", "-T", "-a", ADAPTER],
    "distant": ["-D", "-k", "12"],
    "hp": ["-c", "-h", "-k", "12"],
    "dash_in_reference": ["-k", "12"],
}


def _run(d, argv, monkeypatch, fast: bool) -> tuple[list, dict, dict]:
    """The port's mia in this process; returns the assembly state after pass
    1 and after every realignment, the maln files' bytes and the fast
    merges' call counts."""
    made, states, calls = [], [], {"pass1": 0, "realign": 0, "hp_routed": 0}

    class Recorded(MapAlignment):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    pop_smp = assembler.pop_smp_from_FSDB

    def snap(fsdb, depth):
        states.append(state(made[0], fsdb))
        return pop_smp(fsdb, depth)

    def counted(key, fn):
        def call(*a):
            calls[key] += 1
            return fn(*a) if fast else False
        return call

    def routed(arena, off, lens):
        runs = entries.longest_runs(arena, off, lens)
        calls["hp_routed"] += int((runs >= entries.HPW_ROUTE).sum())
        return runs

    with monkeypatch.context() as mp:
        mp.setattr(assembler, "MapAlignment", Recorded)
        mp.setattr(assembler, "longest_runs", routed)
        mp.setattr(driver, "longest_runs", routed)
        mp.setattr(assembler, "pop_smp_from_FSDB", snap)
        mp.setattr(assembler, "finish_gapfree", counted("pass1", driver.finish_gapfree))
        mp.setattr(driver, "merge_realigned_gapfree",
                   counted("realign", driver.merge_realigned_gapfree))
        os.makedirs(d)
        mp.chdir(d)
        assert port_mia.main([*argv, "-m", "out.maln", "--engine", "torch"]) == 0
    files = {fn: _norm(os.path.join(d, fn)) for fn in sorted(os.listdir(d))
             if fn.startswith("out.maln.")}
    return states, files, calls


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_equals_per_read_merges(name, tmp_path, monkeypatch, one_torch_thread):
    monkeypatch.setenv("MIA_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MIA_TORCH_SERVER", "0")
    monkeypatch.setenv("MIA_SCORE_BATCH", "64")
    ref_fn, frag_fn = _write_inputs(str(tmp_path), 11, dash=name == "dash_in_reference")
    argv = ["-r", ref_fn, "-f", frag_fn, *RUNS[name]]
    got = _run(str(tmp_path / "fast"), argv, monkeypatch, fast=True)
    want = _run(str(tmp_path / "per_read"), argv, monkeypatch, fast=False)
    assert len(got[0]) >= 2 and got[1]
    assert got[0] == want[0]
    assert got[1] == want[1]
    if name == "dash_in_reference":
        # the reference holds '-': pass 1 never takes the fast merge
        assert got[2]["pass1"] == 0
    else:
        assert got[2]["pass1"] > 100 and got[2]["realign"] > 100, got[2]
    assert (got[2]["hp_routed"] > 0) == (name == "hp"), got[2]
    # rc reads, and reads split across the origin, are in the state
    fss = got[0][0]["fss"]
    assert any(fs["rc"] for fs in fss)
    assert any(fs["back"] is not None for fs in fss) == (name not in ("distant",
                                                                      "dash_in_reference"))
