"""Multi-host orchestration of the port on ``torch.distributed`` (gloo).

The port's counterpart of the JAX package's ``parallel/distributed.py``, with
the same functions.  Reference analogue: none — the reference is a single
process.  The recipe:

1. every process runs the same program and calls :func:`initialize_if_needed`
   (a gloo group over TCP from ``MIA_TORCH_COORDINATOR_ADDRESS`` (host:port of
   rank 0), ``MIA_TORCH_NUM_PROCESSES`` and ``MIA_TORCH_PROCESS_ID``);
2. each process streams only its slice of the input reads
   (:func:`host_read_shard`) and scores pass 1 and the realignments on its
   own card (``cuda:(rank mod device count)``), with the reference and PSSMs
   replicated;
3. per-iteration consensus merges the per-process ColumnCounts accumulators
   with one all-reduce (:func:`allreduce_column_counts`) before the
   find_consensus decision (src/map_align.c:229-263 / src/mia.c:551-599);
4. repeat filtering and the dynamic score cutoff replay the single-process
   history over every process's reads (:class:`GlobalReadFilter`);
5. every process leaves the iteration loop together
   (:func:`converged_everywhere`), and rank 0 alone writes the maln and
   fastq files (:func:`write_ma_global`).

Every reduction is over host numpy arrays, so the group is gloo's and no
card takes part in it.  Each reduction is an all-gather followed by a numpy
reduction in rank order: the same order, and so the same bits, as the JAX
package's ``process_allgather(...).sum(axis=0)``, which a ring all-reduce of
floats over three or more ranks would not give.  Integer sums stay int64 (the
JAX package's gather, without x64, narrows them to int32).  The group has a
fixed timeout, so a rank that dies or falls out of step fails the others
instead of hanging them.

Under ``--profile`` each collective counts in ``dist.collectives`` and its
wall time, waiting for the slowest rank included, in ``dist.collective_s``.

``torch.distributed`` is imported only when a group is joined: a
single-process run (no ``MIA_TORCH_COORDINATOR_ADDRESS``) answers
:func:`process_count` and :func:`process_index` without torch, so the host
engines and a client of the resident server (:mod:`mia_tpu_torch.serve`)
never import it.
"""
from __future__ import annotations

import datetime
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

from ..utils import profiling

COORDINATOR = "MIA_TORCH_COORDINATOR_ADDRESS"
NUM_PROCESSES = "MIA_TORCH_NUM_PROCESSES"
PROCESS_ID = "MIA_TORCH_PROCESS_ID"
# how long a rank waits in one collective (and for the group to form) before
# it fails: longer than the widest gap between two collectives that a rank
# can open on the others (a pass 1, a maln write on rank 0)
TIMEOUT_S = 600


def initialize_if_needed() -> bool:
    """Join the gloo group that the ``MIA_TORCH_*`` variables describe;
    no-op for single-process runs.  Returns True when a multi-process group
    is up (a group of one included)."""
    address = os.environ.get(COORDINATOR)
    if address is None:
        return False
    import torch.distributed as dist

    if not dist.is_initialized():
        n = int(os.environ.get(NUM_PROCESSES, "1"))
        rank = int(os.environ.get(PROCESS_ID, "0"))
        if not 0 <= rank < n:
            raise ValueError(f"{PROCESS_ID}={rank} is outside 0..{n - 1} "
                             f"({NUM_PROCESSES}={n})")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{address}", world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S),
        )
    return True


def _group():
    """``torch.distributed`` when this process is in a group, else None: a
    group exists only once the module was imported, so none is imported
    here."""
    dist = sys.modules.get("torch.distributed")
    return dist if dist is not None and dist.is_initialized() else None


def shutdown() -> None:
    """Leave the group (no-op when there is none)."""
    dist = _group()
    if dist is not None:
        dist.destroy_process_group()


def process_count() -> int:
    dist = _group()
    return dist.get_world_size() if dist is not None else 1


def process_index() -> int:
    dist = _group()
    return dist.get_rank() if dist is not None else 0


def _allgather(arr: np.ndarray) -> np.ndarray:
    """Every process's ``arr`` (one shape and dtype on all), stacked in rank
    order: [process_count(), *arr.shape]."""
    import torch

    t0 = time.time()
    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(process_count())]
    _group().all_gather(out, t)
    profiling.count("dist.collectives")
    profiling.add_time("dist.collective_s", time.time() - t0)
    return np.stack([o.numpy() for o in out])


@dataclass
class HostShard:
    """This process's slice of a globally sharded read set."""

    start: int
    count: int


def host_read_shard(total_reads: int) -> HostShard:
    """Contiguous per-process partition of the input read stream: process i
    of n takes reads [i*ceil(N/n), ...) — each parses only its slice."""
    n = process_count()
    i = process_index()
    per = -(-total_reads // n)
    start = min(i * per, total_reads)
    return HostShard(start, min(per, total_reads - start))


def allreduce_terms(terms: np.ndarray) -> np.ndarray:
    """Sum a small 1-D int64/float64 term vector across all processes, in
    rank order (identity single-process)."""
    if process_count() == 1:
        return terms
    return _allgather(np.asarray(terms)).sum(axis=0)


def allreduce_column_counts(cc):
    """Merge per-process ColumnCounts (counts [n,5], cov [n], scores [n,4])
    into the global accumulators on every process, in int64 — the psum of
    the reference's BaseCounts (src/map_align.c:229-263).  Returns ``cc``
    (mutated in place); identity for single-process runs."""
    if process_count() == 1:
        return cc
    flat = np.concatenate(
        [cc.counts.ravel(), cc.cov.ravel(), cc.scores.ravel()]
    ).astype(np.int64)
    total = allreduce_terms(flat)
    n = cc.n
    cc.counts = total[: n * 5].reshape(n, 5)
    cc.cov = total[n * 5 : n * 6]
    cc.scores = total[n * 6 :].reshape(n, 4)
    return cc


def allreduce_max(arr: np.ndarray) -> np.ndarray:
    """Elementwise max across all processes, written into ``arr`` (identity
    single-process); used for the shared per-column max-insert array
    (ref->gaps[], src/map_align.c:944-950 semantics made global)."""
    if process_count() == 1:
        return arr
    arr[...] = _allgather(np.asarray(arr)).max(axis=0)
    return arr


def gather_bytes(data: bytes) -> list[bytes]:
    """All-gather one variable-length byte blob per process; returns the
    blobs in rank order on every process.  The lengths go first, then the
    blobs padded to the longest."""
    if process_count() == 1:
        return [data]
    lens = _allgather(np.array([len(data)], np.int64)).reshape(-1)
    cap = int(lens.max())
    if cap == 0:
        return [b""] * len(lens)
    buf = np.zeros(cap, np.uint8)
    if data:
        buf[: len(data)] = np.frombuffer(data, np.uint8)
    all_bufs = _allgather(buf)
    return [all_bufs[i, : lens[i]].tobytes() for i in range(len(lens))]


def gather_arrays(arr: np.ndarray) -> list[np.ndarray]:
    """All-gather one variable-length 2-D array per process (same width,
    differing row counts); rank order."""
    blobs = gather_bytes(
        np.ascontiguousarray(arr, np.int64).tobytes()
    )
    w = arr.shape[1] if arr.ndim == 2 else 1
    return [np.frombuffer(b, np.int64).reshape(-1, w) for b in blobs]


class GlobalReadFilter:
    """Replays the single-process FSDB filter history (sort -> uniq ->
    score-cut) over ALL processes' reads, using lightweight stubs and the
    exact same fsdb code paths, so repeat filtering and the dynamic score
    cutoff are globally identical — including float summation order — to a
    single-process run over the concatenated stream.

    Each local FragSeq carries a ``gid`` (global stream index).  The stub
    list persists across iterations: stable sorts leave the same
    tie-breaking history a single process would have, and membership tracks
    each process's live reads (clean_FSDB etc.) via :meth:`refresh`.  Every
    process holds the same stubs in the same order: nothing here iterates a
    set or a dict built in a rank-dependent order.

    Reference analogues: sort_fsdb/fs_comp (src/fsdb.c:13-174),
    set_uniq_in_fsdb (src/fsdb.c:440-508), find_fsdb_score_cut
    (src/fsdb.c:269-383)."""

    def __init__(self, full: bool = False):
        """``full`` additionally mirrors id/seq/qual onto the stubs — needed
        for global read collapsing (-C) and the global fastq export (-q),
        which operate on sequence content, at the cost of every process
        holding the global read strings."""
        from ..core.types import FSDB

        self._fsdb = FSDB()
        self._by_gid: dict[int, object] = {}
        self.full = full

    def refresh(self, local_fsdb) -> None:
        """Gather every process's live (gid, rc, as, ae, score, qual_sum,
        trimmed, seq_len, num_inputs) and update/insert/drop stubs,
        preserving the current stub order for ties."""
        from ..core.types import FragSeq

        rows = np.array(
            [
                [
                    fs.gid,
                    int(fs.rc),
                    fs.as_,
                    fs.ae,
                    fs.score,
                    fs.qual_sum,
                    int(fs.trimmed),
                    fs.seq_len,
                    int(fs.unique_best),
                    fs.num_inputs,
                    int(fs.strand_known),
                    int(fs.back_fresh),
                ]
                for fs in local_fsdb.fss
            ],
            np.int64,
        ).reshape(-1, 12)
        shards = gather_arrays(rows)
        strs: dict[int, tuple] = {}
        if self.full:
            blob = "\x00".join(
                f"{fs.id}\x01{fs.seq}\x01{fs.qual}" for fs in local_fsdb.fss
            )
            for shard_blob in gather_bytes(blob.encode("latin-1")):
                if not shard_blob:
                    continue
                for rec in shard_blob.decode("latin-1").split("\x00"):
                    rid, seq, qual = rec.split("\x01")
                    strs[len(strs)] = (rid, seq, qual)
            # keyed positionally in gather order == row gather order below
        live: dict[int, np.ndarray] = {}
        order: list[int] = []
        live_str: dict[int, tuple] = {}
        pos = 0
        for shard in shards:
            for r in shard:
                live[int(r[0])] = r
                order.append(int(r[0]))
                if self.full:
                    live_str[int(r[0])] = strs[pos]
                pos += 1
        # update existing stubs in place; drop dead; append new in stream
        # order (only happens on the first refresh)
        kept = [s for s in self._fsdb.fss if s.gid in live]
        have = {s.gid for s in kept}
        for gid in sorted(g for g in order if g not in have):
            s = FragSeq()
            s.gid = gid
            kept.append(s)
        kept_new = [s for s in kept if s.gid not in have]
        kept_old = [s for s in kept if s.gid in have]
        # stream order for first-time stubs; preserved order for the rest
        kept_new.sort(key=lambda s: s.gid)
        self._fsdb.fss = kept_old + kept_new
        for s in self._fsdb.fss:
            r = live[s.gid]
            s.rc = bool(r[1])
            s.as_ = int(r[2])
            s.ae = int(r[3])
            s.score = int(r[4])
            s.qual_sum = int(r[5])
            s.trimmed = bool(r[6])
            s.seq_len = int(r[7])
            s.unique_best = bool(r[8])
            s.num_inputs = int(r[9])
            s.strand_known = bool(r[10])
            s.back_fresh = bool(r[11])
            if self.full:
                s.id, s.seq, s.qual = live_str[s.gid]
        self._by_gid = {s.gid: s for s in self._fsdb.fss}

    # ---- global maln slot-pool replay -----------------------------------
    # The reference's AlnSeq slots are reused across iterations and the
    # ``dropped`` flag is only ever SET, never cleared, so a record's DR bit
    # carries the history of every read that previously occupied its slot
    # (src/map_alignment.c slot reuse + src/mia.c:418-506).  Sharded
    # processes have different local slot histories, so the single-process
    # bits are replayed here on the global stub order and written back over
    # the local flags (consensus and the maln writer then see exactly the
    # single-process state).

    def assign_slots(self) -> None:
        """Assign global maln slot indices for the CURRENT layout: stream
        (gid) order for the pass-1 maln, stub order filtered to re-merged
        (strand-known) reads afterwards; non-merged reads keep their stale
        slots, un-resplit reads keep their stale back slot."""
        self._assigns = getattr(self, "_assigns", 0) + 1
        if not hasattr(self, "_slot_dropped"):
            self._slot_dropped: list[bool] = []
        nxt = 0
        if self._assigns == 1:
            for st in sorted(self._fsdb.fss, key=lambda s: s.gid):
                st.front_slot = nxt
                nxt += 1
                st.back_slot = None
                if st.back_fresh:
                    st.back_slot = nxt
                    nxt += 1
        else:
            for st in self._fsdb.fss:
                if not st.strand_known:
                    continue  # not re-merged: stale slots persist
                st.front_slot = nxt
                nxt += 1
                if st.back_fresh:
                    st.back_slot = nxt
                    nxt += 1
        if nxt > len(self._slot_dropped):
            self._slot_dropped.extend([False] * (nxt - len(self._slot_dropped)))

    def snapshot_fresh(self, local_fsdb) -> dict:
        """Gather the records freshly merged under the CURRENT slot layout
        into the cumulative global slot->(start, end, body) map (stale
        slots then fall back to the last layout that wrote them, exactly
        like the reference's untouched pool objects).  Idempotent per
        layout."""
        from ..io.maln import alnseq_lines

        content = getattr(self, "_slot_content", None)
        if content is None:
            content = self._slot_content = {}
        if getattr(self, "_snap_layout", None) == getattr(self, "_assigns", 0):
            return content
        self._snap_layout = getattr(self, "_assigns", 0)
        first_layout = getattr(self, "_assigns", 0) <= 1
        parts = []
        for fs in local_fsdb.fss:
            st = self._by_gid.get(fs.gid)
            if st is None:
                continue
            merged = True if first_layout else st.strand_known
            if not merged or fs.front_asp is None:
                continue
            body = "\n".join(alnseq_lines(fs.front_asp))
            parts.append(
                f"{st.front_slot}\t{fs.front_asp.start}\t{fs.front_asp.end}\n{body}"
            )
            if st.back_fresh and fs.back_asp is not None and st.back_slot is not None:
                body = "\n".join(alnseq_lines(fs.back_asp))
                parts.append(
                    f"{st.back_slot}\t{fs.back_asp.start}\t{fs.back_asp.end}\n{body}"
                )
        shards = gather_bytes("\x00".join(parts).encode("latin-1"))
        if process_index() != 0:
            return content  # only the writing process retains record bodies
        for shard in shards:
            if not shard:
                continue
            for part in shard.decode("latin-1").split("\x00"):
                keyline, body = part.split("\n", 1)
                slot, start, end = (int(x) for x in keyline.split("\t"))
                content[slot] = (start, end, body)
        return content

    def cull_drops(
        self, hard_cut: int, score_cut_set: bool, s: float, n: float,
        distant_ref: bool, ref,
    ) -> dict:
        """Replay this cull's below-line decisions on the global slot bits;
        returns {(global sort position, segment): dropped} for the live
        unique records (cull_maln_from_fsdb's decision,
        src/mia.c:418-506)."""
        from ..core.fsdb import _min_scores_batch, _resolve_cut, find_alignable_len

        slope, intercept = _resolve_cut(self._fsdb, score_cut_set, s, n)
        fss = self._fsdb.fss
        if hard_cut > 0:
            cuts = np.full(len(fss), float(hard_cut))
        elif distant_ref:
            cuts = _min_scores_batch(
                slope, intercept,
                np.fromiter(
                    (find_alignable_len(st, ref) for st in fss), np.int32, len(fss)
                ),
            )
        else:
            cuts = _min_scores_batch(
                slope, intercept,
                np.fromiter((st.seq_len for st in fss), np.int32, len(fss)),
            )
        drops: dict = {}
        sd = self._slot_dropped
        for i, st in enumerate(fss):
            if not st.unique_best:
                continue
            below = st.score < cuts[i]
            fslot = getattr(st, "front_slot", None)
            if fslot is not None:
                if below:
                    sd[fslot] = True
                drops[(i, 0)] = sd[fslot]
            bslot = getattr(st, "back_slot", None)
            if bslot is not None:
                if below:
                    sd[bslot] = True
                drops[(i, 1)] = sd[bslot]
        return drops

    def sort_and_uniq(self, qscore: bool, just_outer: bool, tol: int,
                      local_fsdb) -> None:
        """Global sort + duplicate marking; writes unique_best back onto the
        local reads."""
        from ..core.fsdb import (
            set_uniq_in_fsdb,
            sort_fsdb,
            sort_fsdb_qscore,
        )

        (sort_fsdb_qscore if qscore else sort_fsdb)(self._fsdb)
        set_uniq_in_fsdb(self._fsdb, just_outer, tol)
        for fs in local_fsdb.fss:
            fs.unique_best = self._by_gid[fs.gid].unique_best

    def score_cut(self) -> tuple[float, float]:
        """Global (slope, intercept) in the global sorted order — identical
        rounding to the single-process fit."""
        from ..core.fsdb import find_fsdb_score_cut

        return find_fsdb_score_cut(self._fsdb)

    def sort_pos(self) -> dict[int, int]:
        """gid -> position in the current global sorted order (the culled
        maln's insertion-order key for the global maln write)."""
        return {s.gid: i for i, s in enumerate(self._fsdb.fss)}

    def clean(self) -> None:
        """Mirror clean_FSDB's one-time score<=0 drop (src/mia.c:400-406) on
        the stub DB so the global collapse sees the same read set a single
        process would."""
        self._fsdb.fss = [s for s in self._fsdb.fss if s.score > 0]
        self._by_gid = {s.gid: s for s in self._fsdb.fss}

    def collapse(
        self, local_fsdb, hard_cut: int, score_cut_set: bool, s: float, n: float
    ) -> None:
        """Global read collapsing (-C): replay collapse_FSDB on the full
        stub DB (identical on every process — duplicate groups may span
        processes), then mirror the outcome locally: dead reads drop,
        leaders take their synthetic seq/coords/num_inputs.  Requires
        full=True stubs (seq/qual gathered).  Reference: src/mia.c:314-396."""
        if not self.full:
            raise RuntimeError("global collapse needs GlobalReadFilter(full=True)")
        from ..core.fsdb import collapse_FSDB

        collapse_FSDB(self._fsdb, hard_cut, score_cut_set, s, n)
        self._by_gid = {st.gid: st for st in self._fsdb.fss}
        kept = []
        for fs in local_fsdb.fss:
            st = self._by_gid.get(fs.gid)
            if st is None:
                continue  # melded into a (possibly remote) leader
            fs.seq = st.seq
            fs.seq_len = st.seq_len
            fs.as_ = st.as_
            fs.ae = st.ae
            fs.num_inputs = st.num_inputs
            kept.append(fs)
        local_fsdb.fss = kept

    def write_fastq_host0(self, path: str) -> None:
        """-q export: rank 0 writes the COMPLETE read DB in the global
        (stub) order — the order a single process would have
        (src/fsdb.c:392-419).  Requires full=True stubs."""
        if not self.full:
            raise RuntimeError("the global fastq export needs GlobalReadFilter(full=True)")
        if process_index() != 0:
            return
        from ..core.fsdb import write_fastq

        write_fastq(path, self._fsdb)


def write_ma_global(
    path: str,
    culled,
    gf: "GlobalReadFilter",
    local_fsdb,
    pass1_total: int,
    *,
    timestamp: float | None = None,
) -> None:
    """Rank 0 writes the COMPLETE maln via the global slot replay.

    The reference emits fs->front_asp/back_asp POINTERS into the reused
    slot pool; a read that was not re-merged this iteration emits whatever
    record now occupies its stale slot (src/mia_main.c:273-276 +
    src/mia.c:432-470).  Processes therefore ship the records they freshly
    merged keyed by GLOBAL slot, every process replays the identical pick
    sequence over the stub DB, and rank 0 stably sorts the picked records
    by (start, end) — byte-identical to the single process, including the
    aliased emissions."""
    from ..io.maln import header_lines

    content = gf.snapshot_fresh(local_fsdb)

    # identical pick replay on every process (only rank 0 writes)
    picks: list[int] = []
    for st in gf._fsdb.fss:
        if not st.unique_best:
            continue
        picks.append(st.front_slot)
        if st.back_slot is not None:
            picks.append(st.back_slot)
    if process_index() != 0:
        return
    recs = []
    for k, slot in enumerate(picks):
        start, end, body = content[slot]
        recs.append(((start, end, k), body))
    recs.sort(key=lambda kv: kv[0])
    lines = header_lines(
        culled, timestamp=timestamp, nas=len(picks), siz=pass1_total
    )
    lines.extend(kv[1] for kv in recs)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def reduce_column_counts(cc):
    """Hook for core.columns: allreduce one ColumnCounts accumulator."""
    return allreduce_column_counts(cc)


def converged_everywhere(local_equal: bool) -> bool:
    """All-process convergence vote: every process must see its consensus
    repeat before any process stops iterating (src/mia_main.c:915-916 made
    global)."""
    if process_count() == 1:
        return local_equal
    votes = allreduce_terms(np.array([int(local_equal)], np.int64))
    return int(votes[0]) == process_count()
