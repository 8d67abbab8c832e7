"""End-to-end iterative assembly pipeline of the port (mia main,
src/mia_main.c:394-989).

Pass 1 aligns every read fw+rc against the (wrapped) reference, then the
engine iterates: consensus -> realign -> filter -> cull -> write maln, until
the consensus string repeats or MAX_ITER is hit.  It is the JAX package's
``mia_tpu/core/assembler.py`` with the device engine replaced:

* ``--engine torch``: pass 1 and every realignment score their entries with
  the port's scorer (:mod:`mia_tpu_torch.core.torch_engine`), over several
  cards under ``--dp-devices``; every consensus counts its main columns on
  the device (:mod:`mia_tpu_torch.ops.consensus_torch`, through the
  ``device_hook`` of ``columns.consensus_assembly_string``), with no size
  threshold; insertion columns stay on the host.
* ``--engine native``: the fully-native batched solver (k-mer filter, banded
  fw/rc DP and traceback in one threaded FFI call per batch).
* ``--engine numpy``: the exact per-read host path.

Multi-host (SPMD over read shards) under every engine: launched with
``MIA_TORCH_COORDINATOR_ADDRESS`` / ``MIA_TORCH_NUM_PROCESSES`` /
``MIA_TORCH_PROCESS_ID``, every process runs :func:`run_assembly` over its
contiguous slice of the input stream and, under ``--engine torch``, scores it
on its own card; repeat filtering and the dynamic score cutoff replay
globally (:class:`~mia_tpu_torch.parallel.distributed.GlobalReadFilter`),
per-iteration consensus counts and the shared max-insert array are summed
over the processes, convergence is a global vote, and rank 0 writes the
complete maln — byte-identical to a single-process run.

Under ``--engine torch`` a run scores in its own process or, when the
``MIA_TORCH_SERVER`` policy finds one, through the port's resident scoring
server (:mod:`mia_tpu_torch.serve`): pass 1, each realignment and each
consensus then go over one connection to the process that holds the card,
and a single-process run imports no torch at all (neither do the host
engines: the device modules are imported where an in-process engine is
built).  ``--dp-devices`` with two or more devices always scores in
process, as the JAX package's mesh runs do.  A multi-host rank takes the
same policy, and imports torch for its gloo group.

Left out of this port, with the reason it existed: work-stealing (it hid
the TPU's backend start and compiles; here the kernel library builds once
when the scorer or the server is made).
"""
from __future__ import annotations

import concurrent.futures as _cf
import functools
import os
import sys
import time

import numpy as np

from .. import serve
from ..config import MiaConfig
from ..constants import FIRST_ROUND_SCORE_CUTOFF, INIT_ALN_SEQ_LEN, MAX_ITER, PSSM_DEPTH
from ..io.fasta import read_fasta_ref
from ..io.ids import parse_ids
from ..io.maln import write_ma
from ..io.native import count_frag_seqs, iter_frag_seqs_range
from ..io.native import iter_frag_seqs_fast as iter_frag_seqs
from ..io.native import unavailable as native_unavailable
from ..io.pssm_io import find_read_pssm
from ..ops.kmer import KmerPosArray, new_kmer_filter
from ..ops.pssm import init_flatsubmat, revcom_submat
from ..parallel import distributed as dist
from ..utils import profiling
from .columns import consensus_assembly_string, sort_aln_frags
from .driver import (
    finish_alignment,
    finish_gapfree,
    init_alignment,
    reiterate_assembly,
    set_hp_cols,
    set_hp_rows,
    set_seq1,
    set_seq2,
    sg_align,
    trim_frag,
)
from .entries import (
    HPW_ROUTE,
    L_MAX,
    MAX_INTERVALS,
    WIN_W,
    diag_gapfree,
    longest_runs,
    pack_chars,
)
from .fsdb import (
    FSDB,
    clean_FSDB,
    collapse_FSDB,
    cull_maln_from_fsdb,
    pop_smp_from_FSDB,
    set_uniq_in_fsdb,
    sort_fsdb,
    sort_fsdb_qscore,
    write_fastq,
)
from .hostbatch import (
    FLAG_HOST_ONLY,
    FLAG_SKIP,
    FLAG_WIDE,
    STATUS_GATED,
    STATUS_HOST_FALLBACK,
    STATUS_NO_KMER,
    BatchHost,
)
from .merge import add_ref_wrap
from .types import MapAlignment


class NotPortedError(NotImplementedError):
    """A run the port does not cover yet under ``--engine torch``."""


# The JAX package's multi-host variable, which a launcher written for it may
# still set: the port's group is described by its own three variables.
JAX_MULTI_HOST_VARIABLE = "JAX_COORDINATOR_ADDRESS"


def check_ported(cfg: MiaConfig) -> None:
    """Refuse what the port does not run: a multi-host launch meant for the
    JAX package (jax.distributed), under any engine, and the JAX package's
    own engine."""
    if os.environ.get(JAX_MULTI_HOST_VARIABLE) is not None:
        raise NotPortedError(
            f"{JAX_MULTI_HOST_VARIABLE} is set, which starts the JAX package's "
            f"jax.distributed: for a multi-host run of this port set "
            f"{dist.COORDINATOR}, {dist.NUM_PROCESSES} and {dist.PROCESS_ID} instead")
    if cfg.engine not in ("torch", "native", "numpy"):
        raise NotPortedError(f"--engine {cfg.engine} is not an engine of this port")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr)


# What the pass-1 merge does with a drained read: skip it, take the gate's
# score, align it on the host, merge its native solve (band wider than the
# device window, and under -h a strand window past entries.HP_WIDE_COLS: not
# scored on the card), merge its gap-free diagonal, or merge its native
# traceback.
SKIP, GATED, HOST, WIDE, GAPFREE, TRACED = range(6)


def plan_batch(flags, fb, fa, rb, ra, distant_ref: bool, dev_wide=None):
    """(kind, rc, best, aec) of a drained pass-1 batch, each [n]: the flags
    decide first (FLAG_SKIP over FLAG_HOST_ONLY over FLAG_WIDE), then the
    device's scores: the winning strand (rc on a tie), its best and end
    column, and the gate (src/map_align.c:1614; none under -D).  Every
    winner is TRACED until its diagonal proves gap-free.  A WIDE read that
    the card scored full width (``dev_wide`` [n] bool,
    ``entries.wide_scored``; with or without ``-h``) is decided as a
    windowed one; the other WIDE reads (under ``-h`` the width rule's) keep
    the native solve."""
    flags = np.asarray(flags)
    fb = np.asarray(fb)
    rb = np.asarray(rb)
    rc = ~(fb > rb)
    best = np.where(rc, rb, fb).astype(np.int64)
    aec = np.where(rc, np.asarray(ra), np.asarray(fa)).astype(np.int64)
    kind = np.full(len(flags), TRACED, np.int8)
    if not distant_ref:
        kind[best < FIRST_ROUND_SCORE_CUTOFF] = GATED
    native_wide = (flags & FLAG_WIDE) != 0
    if dev_wide is not None:
        native_wide &= ~np.asarray(dev_wide)
    kind[native_wide] = WIDE
    kind[(flags & FLAG_HOST_ONLY) != 0] = HOST
    kind[(flags & FLAG_SKIP) != 0] = SKIP
    return kind, rc, best, aec


def make_dp_devices(n_dp: int, devices=None):
    """``torch_engine.make_dp_devices``: the device list of ``--dp-devices``,
    or None for the single-device path; torch is imported only when a list
    or two or more devices are asked for."""
    if devices is None and n_dp in (0, 1):
        return None
    from .torch_engine import make_dp_devices as devices_of

    return devices_of(n_dp, devices)


class ConsensusHook:
    """``device_hook`` for ``consensus_assembly_string`` that counts the
    main columns with ``count`` (:meth:`Placement.counts`: on this process's
    device or devices, or on the resident server).

    ``main_column_counts`` catches any exception of its hook and counts the
    columns on the host instead; this hook keeps the first failure, and
    :meth:`consensus` raises it once the consensus returns, so a failing
    device (or server) is never hidden behind the host's equal answer."""

    def __init__(self, count):
        self.count = count
        self.error: BaseException | None = None

    def __call__(self, *args):
        try:
            return self.count(*args)
        except Exception as e:
            self.error = self.error or e
            raise

    def consensus(self, maln: MapAlignment, reduce_cc=None) -> str:
        """The next iteration's reference, main columns counted here (and,
        multi-host, summed over the processes by ``reduce_cc``)."""
        cons = consensus_assembly_string(maln, reduce_cc=reduce_cc, device_hook=self)
        if self.error is not None:
            raise RuntimeError("device consensus failed") from self.error
        return cons


class Placement:
    """Where ``--engine torch`` scores and counts, decided once by
    :func:`run_assembly`: on the resident server behind ``client`` (a
    connection of :func:`mia_tpu_torch.serve.connect`), or in this process
    on ``device``, or dealt over ``devices``.  Pass 1, every realignment and
    every consensus take their scorers and column counts from it."""

    def __init__(self, device=None, devices=None, client=None):
        self.device = device
        self.devices = devices
        self.client = client

    def scorer(self, fw_s1c, rc_s1c, len1: int, submat, submat_b=None,
               hp_seqs: tuple[str, str] | None = None):
        """A scorer for one reference.  With ``hp_seqs`` (``-h``) it stays on
        one device: the ``-h`` kernel has no sharded form, as in the JAX
        package."""
        if self.client is not None:
            return serve.connect_scorer(self.client, fw_s1c, rc_s1c, len1, submat, submat_b,
                                        hp_seqs=hp_seqs)
        from .torch_engine import Pass1Scorer

        return Pass1Scorer(fw_s1c, rc_s1c, len1, submat, submat_b, device=self.device,
                           hp_seqs=hp_seqs, devices=None if hp_seqs else self.devices)

    def counts(self):
        """The consensus's column counts (``device_hook``'s signature)."""
        if self.client is not None:
            return serve.connect_consensus(self.client)
        from ..ops.consensus_torch import device_column_counts

        return functools.partial(device_column_counts, device=self.device,
                                 devices=self.devices)


def run_assembly(cfg: MiaConfig) -> MapAlignment:
    """Run the full mia pipeline; returns the final culled MapAlignment.
    Under ``--engine torch`` entries are dealt over
    make_dp_devices(cfg.dp_devices) when that gives two or more (never under
    ``-h``); otherwise they are scored by the resident server that
    ``serve.connect()`` finds (the ``MIA_TORCH_SERVER`` policy, probed
    before anything imports torch) or, without one, on
    torchcfg.select_device(rank).  A multi-host run joins its process group
    here and leaves it when the run returns or raises; the server's
    connection is closed the same way."""
    check_ported(cfg)
    with profiling.phase("dist.init"):
        multi = dist.initialize_if_needed()
    placement = None
    try:
        if cfg.engine == "torch":
            devices = None if cfg.hp_special else make_dp_devices(cfg.dp_devices)
            client = None if devices else serve.connect()
            if client is not None:
                placement = Placement(client=client)
            elif devices:
                placement = Placement(devices[0], devices)
            else:
                from ..utils.torchcfg import select_device

                placement = Placement(select_device(dist.process_index()))
        return _assemble(cfg, multi, placement)
    finally:
        if placement is not None and placement.client is not None:
            placement.client.close()
        if multi:
            dist.shutdown()


def _assemble(cfg: MiaConfig, multi: bool, placement: Placement | None) -> MapAlignment:
    t_setup = time.time()
    # -C / -q need sequence content globally (duplicate groups span
    # processes; the fastq export is one global file): full stubs mirror
    # id/seq/qual
    gf = dist.GlobalReadFilter(full=cfg.collapse or cfg.make_fastq) if multi else None
    reduce_cc = dist.reduce_column_counts if multi else None
    if cfg.submat_fn:
        ancsubmat = find_read_pssm(cfg.submat_fn)
    else:
        ancsubmat = init_flatsubmat()
    rcancsubmat = revcom_submat(ancsubmat)
    flatsubmat = init_flatsubmat()

    maln = MapAlignment()
    maln.cons_code = cfg.cons_code
    maln.distant_ref = cfg.distant_ref

    fsdb = FSDB()

    maln.ref = read_fasta_ref(cfg.ref_fn)
    if cfg.circular:
        add_ref_wrap(maln.ref)
    else:
        maln.ref.wrap_seq_len = maln.ref.seq_len
    maln.ref.gaps = np.zeros(maln.ref.wrap_seq_len + 1, dtype=np.int64)

    fkpa = rkpa = None
    if cfg.kmer_filt_len > 0:
        _log("Making kmer list for k-mer filtering...")
        fkpa = KmerPosArray(
            maln.ref.seq[: maln.ref.wrap_seq_len], cfg.kmer_filt_len, cfg.soft_mask
        )
        rkpa = KmerPosArray(
            maln.ref.rcseq[: maln.ref.wrap_seq_len], cfg.kmer_filt_len, cfg.soft_mask
        )

    # raw (possibly soft-masked) strands for the native batch engine's own
    # k-mer index build; captured before the uppercase below
    raw_fw_strand = maln.ref.seq
    raw_rc_strand = maln.ref.rcseq

    # k-mer tables built; uppercase the reference from here on
    maln.ref.seq = (
        maln.ref.seq[: maln.ref.wrap_seq_len].upper()
        + maln.ref.seq[maln.ref.wrap_seq_len :]
    )
    maln.ref.rcseq = (
        maln.ref.rcseq[: maln.ref.wrap_seq_len].upper()
        + maln.ref.rcseq[maln.ref.wrap_seq_len :]
    )

    size2 = maln.ref.wrap_seq_len + 2 * INIT_ALN_SEQ_LEN
    fw_align = init_alignment(INIT_ALN_SEQ_LEN, size2, rc=False, hp_special=cfg.hp_special)
    rc_align = init_alignment(INIT_ALN_SEQ_LEN, size2, rc=True, hp_special=cfg.hp_special)

    adapt_align = None
    if cfg.do_adapter_trimming:
        adapt_align = init_alignment(
            INIT_ALN_SEQ_LEN, INIT_ALN_SEQ_LEN, rc=False, hp_special=cfg.hp_special
        )
        adapt_align.submat = flatsubmat
        set_seq2(adapt_align, cfg.adapter)
        if cfg.hp_special:
            set_hp_rows(adapt_align)
        adapt_align.sg5 = True
        adapt_align.sg3 = False

    ref_len1 = maln.ref.wrap_seq_len if cfg.circular else maln.ref.seq_len
    set_seq1(fw_align, maln.ref.seq, ref_len1)
    set_seq1(rc_align, maln.ref.rcseq, ref_len1)
    if cfg.hp_special:
        set_hp_cols(fw_align)
        set_hp_cols(rc_align)

    good_ids = parse_ids(cfg.ids_file) if cfg.ids_file else None

    _log("Starting to align sequences to the reference...")
    seen = 0
    fw_align.submat = ancsubmat
    rc_align.submat = ancsubmat

    def _batch_host():
        return BatchHost.create(
            raw_fw_strand,
            raw_rc_strand,
            ref_len1,
            ancsubmat,
            None,
            cfg.kmer_filt_len if cfg.kmer_filt_len > 0 else -1,
            cfg.soft_mask,
            WIN_W,
            MAX_INTERVALS,
            hp=cfg.hp_special,
        )

    # engine selection for pass 1:
    #   "torch"  — the native engine applies the k-mer filter, the device
    #       scores batches, the native engine tracebacks; -h scores with the
    #       homopolymer kernel
    #   "native" — fully-native batched solver (k-mer filter + banded fw/rc
    #       DP + traceback in one threaded FFI call per batch)
    #   "numpy"  — exact per-read host path
    use_torch = cfg.engine == "torch"
    use_native = cfg.engine == "native"
    scorer = None
    bhost = None
    pending: list = []
    if use_torch or use_native:
        # the raw (pre-uppercase) strands drive the k-mer index exactly like
        # populate_kpa runs before make_ref_upper (src/mia_main.c:659-676)
        bhost = _batch_host()
        if bhost is None:
            if use_torch:
                raise native_unavailable()
            # no native lib (and the auto-build failed): the exact per-read
            # numpy path serves instead
            use_native = False
    if use_torch:
        # -h: the scorer needs the strands' chars for the homopolymer runs
        # (src/mia.c:883-905)
        hp_seqs = None
        if cfg.hp_special:
            hp_seqs = (fw_align.seq1[: fw_align.len1], rc_align.seq1[: rc_align.len1])
        scorer = placement.scorer(fw_align.s1c, rc_align.s1c, fw_align.len1, ancsubmat,
                                  hp_seqs=hp_seqs)
        profiling.count("pass1.using_server" if placement.client else "pass1.in_process")

    # asynchronous device pipeline: batches dispatch without blocking and
    # drain in read order as their results land (or when the inflight cap is
    # hit), so the device computes while the host streams/packs/merges
    inflight: list = []
    NATIVE_BATCH = 4096
    MAX_INFLIGHT = 16
    # one worker overlaps each batch's native finish with the previous
    # batch's python merge (pass-1 device path)
    finish_pool = _cf.ThreadPoolExecutor(max_workers=1)
    finishing: list = []
    # a second worker overlaps pack/k-mer-prepare/dispatch with the read
    # streaming (the FFI calls release the GIL); inflight holds futures in
    # stream order
    prep_pool = _cf.ThreadPoolExecutor(max_workers=1)

    def _host_align_one(f) -> None:
        """Per-read host path (mask too fragmented for the device)."""
        frag_len = f.trim_point + 1 if f.trimmed else f.seq_len
        new_kmer_filter(
            f.seq,
            frag_len,
            fkpa,
            rkpa,
            cfg.kmer_filt_len,
            fw_align.align_mask,
            rc_align.align_mask,
            fw_align.len1,
            rc_align.len1,
        )
        sg_align(maln, f, fsdb, fw_align, rc_align)

    def _solve_native_subset(arena: bytes, off: np.ndarray, lens: np.ndarray):
        """Threaded native full solve of reads packed in ``arena`` (wide
        bands): (meta, ref arena, frag arena) with read j's strings at j *
        TRACE_CAP, and the reads whose traceback outgrew that arena,
        solved again with a full-width one: {j: (meta_row, ref, frag)}."""
        meta, ra, fa = bhost.solve_pass1(arena, off, lens, maln.distant_ref)
        retry = np.flatnonzero(meta[:, 0] == STATUS_HOST_FALLBACK)
        again = {}
        if len(retry):
            wcap = bhost.wide_cap
            m2, r2, f2 = bhost.solve_pass1(
                arena, off[retry], lens[retry], maln.distant_ref, cap=wcap
            )
            for t, j in enumerate(retry.tolist()):
                again[j] = (m2[t], r2[t * wcap : (t + 1) * wcap], f2[t * wcap : (t + 1) * wcap])
        return meta, memoryview(ra), memoryview(fa), again

    def _merge_native_solved(f, m, ra, fa) -> None:
        """Merge one natively-solved read (meta from mia_p1_solve)."""
        st = int(m[0])
        if st == STATUS_NO_KMER:
            return
        if st == STATUS_GATED:
            f.score = int(m[2])
            return
        if st == STATUS_HOST_FALLBACK:
            _host_align_one(f)
            return
        n = int(m[5])
        pw = (str(ra[:n], "latin-1"), str(fa[:n], "latin-1"))
        finish_alignment(
            maln, f, fsdb, bool(m[1]), int(m[2]), int(m[3]), int(m[4]), pw
        )

    # gap-free winners merge without their traceback strings when neither
    # reference strand holds a '-' (driver.finish_gapfree)
    plain_ref = ("-" not in fw_align.seq1[: fw_align.len1]
                 and "-" not in rc_align.seq1[: rc_align.len1])

    def _start_drain():
        """Collect the oldest batch, plan every read's merge from its flags
        and scores (:func:`plan_batch`), and SUBMIT the native work to the
        worker thread: the wide reads' solve, the winners' gap-free check
        and the native finish (window DP + traceback) of the rest.  The
        python merge of the previous batch overlaps it (the FFI calls
        release the GIL).  Returns a token for :func:`_merge_drained`."""
        profiling.count("pass1.batches_drained")
        # the prep thread's pack, prepare and dispatch of this batch
        with profiling.phase("pass1.prep_wait"):
            records, handle, prep = inflight.pop(0).result()
        arena, off, lens, fw_ivg, rc_ivg, flags = prep
        with profiling.phase("pass1.collect_wait"):
            fb, fa, rb, ra = scorer.collect_arrays(handle)
        # the WIDE reads the card scored full width: the rows the scorer
        # dispatched, the fourth item of its packed handle (entries.wide_rows;
        # under -h none past HP_WIDE_COLS)
        dev_wide = np.zeros(len(lens), bool)
        if handle[3] is not None:
            dev_wide[handle[3].sel] = True
        kind, rc, best, aec = plan_batch(flags, fb, fa, rb, ra, maln.distant_ref, dev_wide)
        # WIDE reads the card did not score (-h, past the width rule): threaded
        # native solve
        wide_idx = np.flatnonzero(kind == WIDE)
        win = np.flatnonzero(kind == TRACED)
        # the row of a WIDE read's native solve, or of a TRACED read's
        # native finish; abc of a GAPFREE read
        row = np.full(len(records), -1, np.int64)
        row[wide_idx] = np.arange(len(wide_idx))
        abc = np.zeros(len(records), np.int64)
        profiling.count("pass1.device_scored_reads", len(win))
        profiling.count("pass1.device_scored_wide_reads", int(dev_wide.sum()))
        profiling.count("pass1.native_solved_wide_reads", len(wide_idx))

        def work():
            """Native work of the batch; marks the GAPFREE winners in
            ``kind`` and the finish rows in ``row``, which the merge reads
            once this returns."""
            wide_res = (
                _solve_native_subset(arena, off[wide_idx], lens[wide_idx])
                if len(wide_idx) else None
            )
            if not len(win):
                return wide_res, None, None, None, 0
            strand = rc[win].astype(np.uint8)
            ivg = np.where(strand[:, None, None] == 1, rc_ivg[win], fw_ivg[win])
            # provably gap-free winners skip the native window refill
            # entirely (entries.diag_gapfree; the dominant aDNA case)
            t0 = time.time()
            gf_ok, gf_abc = diag_gapfree(
                arena, off[win], lens[win], best[win], aec[win], ivg,
                fw_align.s1c[: fw_align.len1], rc_align.s1c[: rc_align.len1],
                strand, ancsubmat,
            )
            kind[win[gf_ok]] = GAPFREE
            abc[win] = gf_abc
            fin = np.flatnonzero(~gf_ok)
            profiling.count("pass1.gapfree_shortcut", len(win) - len(fin))
            if len(fin) == 0:
                profiling.add_time("pass1.native_finish", time.time() - t0)
                return wide_res, None, None, None, 0
            fsel = win[fin]
            row[fsel] = np.arange(len(fin))
            # tight output cap: a finish traceback spans at most the margin
            # window + the read length; overflow falls back per read
            fcap = min(
                bhost.TRACE_CAP, 2 * int(lens[fsel].max(initial=1)) + 768
            )
            meta, ref_arena, frag_arena = bhost.finish(
                arena,
                off[fsel],
                lens[fsel],
                strand[fin],
                np.zeros(len(fin), np.uint8),
                best[fsel].astype(np.int32),
                aec[fsel].astype(np.int32),
                ivg[fin],
                cap=fcap,
            )
            profiling.add_time("pass1.native_finish", time.time() - t0)
            return wide_res, meta, ref_arena, frag_arena, fcap

        return records, kind, rc, best, abc, aec, row, finish_pool.submit(work)

    def _merge_drained(token) -> None:
        records, kind, rc, best, abc, aec, row, fut = token
        wide_res, meta, ref_arena, frag_arena, cap = fut.result()
        t_merge = time.time()
        wide_meta, wide_ref, wide_frag, wide_again = wide_res or (None, None, None, {})
        wcap = bhost.TRACE_CAP
        kinds, rows = kind.tolist(), row.tolist()
        rcs, bests, abcs, aecs = rc.tolist(), best.tolist(), abc.tolist(), aec.tolist()
        for i, f in enumerate(records):
            k = kinds[i]
            if k == GAPFREE:
                # provably gap-free: the traceback IS the diagonal
                rc_i, best_i, abc_i, aec_i = rcs[i], bests[i], abcs[i], aecs[i]
                if not (plain_ref
                        and finish_gapfree(maln, f, fsdb, rc_i, best_i, abc_i, aec_i)):
                    sref = rc_align.seq1 if rc_i else fw_align.seq1
                    length = f.trim_point + 1 if f.trimmed else f.seq_len
                    pw = (sref[abc_i : aec_i + 1], f.seq[:length])
                    finish_alignment(maln, f, fsdb, rc_i, best_i, abc_i, aec_i, pw)
                continue
            if k == SKIP:
                continue
            if k == GATED:
                # gate rejects: no traceback needed (src/map_align.c:1614)
                f.score = bests[i]
                continue
            if k == HOST:
                _host_align_one(f)
                continue
            if k == WIDE:
                j = rows[i]
                solved = wide_again.get(j)
                if solved is None:
                    solved = (wide_meta[j], wide_ref[j * wcap : (j + 1) * wcap],
                              wide_frag[j * wcap : (j + 1) * wcap])
                _merge_native_solved(f, *solved)
                continue
            j = rows[i]
            n = int(meta[j, 3])
            if n < 0:  # native finish failed or outgrew its arena: per-read host path
                profiling.count("pass1.finish_host_reads")
                _host_align_one(f)
                continue
            pw = (
                ref_arena[j * cap : j * cap + n].decode("latin-1"),
                frag_arena[j * cap : j * cap + n].decode("latin-1"),
            )
            finish_alignment(
                maln,
                f,
                fsdb,
                rcs[i],
                int(meta[j, 0]),
                int(meta[j, 1]),
                int(meta[j, 2]),
                pw,
            )
        profiling.add_time("pass1.py_merge", time.time() - t_merge)

    def _flush_native() -> None:
        """Fully-native batched pass 1: one threaded FFI call does k-mer
        filter + banded fw/rc DP + strand pick + gate + traceback for the
        whole batch; Python only merges the results (in read order)."""
        records = pending[:]
        pending.clear()
        if not records:
            return
        reads = [
            (f.seq[: f.trim_point + 1] if f.trimmed else f.seq[: f.seq_len])
            for f in records
        ]
        arena, off, lens = bhost.pack_reads(reads)
        meta, ref_arena, frag_arena = bhost.solve_pass1(
            arena, off[:-1], lens, maln.distant_ref
        )
        cap = bhost.TRACE_CAP
        # wide second pass: reads whose winning window outgrows the default
        # traceback arena (saturated k-mer bands) re-solve with a full-width
        # arena — still batched, still native
        wide: dict[int, tuple] = {}
        fb_idx = [i for i in range(len(records)) if meta[i, 0] == STATUS_HOST_FALLBACK]
        if fb_idx:
            sub = [reads[i] for i in fb_idx]
            a2, o2, l2 = bhost.pack_reads(sub)
            wcap = bhost.wide_cap
            m2, r2, f2 = bhost.solve_pass1(
                a2, o2[:-1], l2, maln.distant_ref, cap=wcap
            )
            for j, i in enumerate(fb_idx):
                wide[i] = (m2[j], r2[j * wcap : (j + 1) * wcap], f2[j * wcap : (j + 1) * wcap])
        for i, f in enumerate(records):
            m = meta[i]
            ra = ref_arena[i * cap : (i + 1) * cap]
            fa = frag_arena[i * cap : (i + 1) * cap]
            if m[0] == STATUS_HOST_FALLBACK and i in wide:
                m, ra, fa = wide[i]
            st = int(m[0])
            if st == STATUS_NO_KMER:
                continue
            if st == STATUS_GATED:
                f.score = int(m[2])
                continue
            if st == STATUS_HOST_FALLBACK:
                _host_align_one(f)
                continue
            n = int(m[5])
            pw = (ra[:n].decode("latin-1"), fa[:n].decode("latin-1"))
            finish_alignment(
                maln, f, fsdb, bool(m[1]), int(m[2]), int(m[3]), int(m[4]), pw
            )

    def _prepare_dispatch(records: list):
        """Worker-thread half of a batch submit: pack + k-mer prepare +
        device dispatch (all FFI work off the streaming thread)."""
        reads = [
            (f.seq[: f.trim_point + 1] if f.trimmed else f.seq[: f.seq_len])
            for f in records
        ]
        with profiling.phase("pass1.pack_prepare"):
            arena, off, lens = bhost.pack_reads(reads)
            # one thread: beside the finish's pool, more prepare threads
            # made pass 1 longer on an H100's 8-CPU host (the sweep of
            # chip_smoke.py --prep-ab); a batch of 8,192 reads is some 25 ms
            s2c, fw_ws, rc_ws, fw_ivg, rc_ivg, flags, errors = bhost.prepare(
                arena, off, lens, L_MAX, MAX_INTERVALS, n_threads=1
            )
        profiling.count("pass1.prepare_host_only_errors", errors)
        if scorer.hp:
            # reads with a homopolymer run of HPW or more stay on the exact
            # host path, as in mia_tpu (entries.hp_routes_to_host); the
            # kernel scores raw chars
            flags[longest_runs(arena, off, lens) >= HPW_ROUTE] |= FLAG_HOST_ONLY
            s2c = pack_chars(arena, off[:-1], lens)
        with profiling.phase("pass1.dispatch"):
            handle = scorer.dispatch_packed(
                s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags
            )
        return records, handle, (arena, off[:-1], lens, fw_ivg, rc_ivg, flags)

    def _inflight_ready(fut) -> bool:
        return fut.done() and scorer.ready(fut.result()[1])

    def flush_pending(final: bool = False) -> None:
        if pending:
            records = pending[:]
            pending.clear()
            inflight.append(prep_pool.submit(_prepare_dispatch, records))
        # drain in read order: everything whose result already landed, plus
        # enough to respect the inflight cap (bounds host-side batch buffers)
        while inflight and (
            final
            or len(inflight) > MAX_INFLIGHT
            or _inflight_ready(inflight[0])
        ):
            finishing.append(_start_drain())
            while len(finishing) > 1:
                _merge_drained(finishing.pop(0))
        if final:
            while finishing:
                _merge_drained(finishing.pop(0))

    t_pass1 = time.time()
    # matrices, reference, k-mer tables, the host engine and the scorer (its
    # device, kernel library and state)
    profiling.add_time("setup", t_pass1 - t_setup)
    if multi:
        # contiguous per-process slice of the stream; gids keep the global
        # stream order observable for the global filter replay.  The count
        # pass is native (no python objects) and each process materialises
        # ONLY its slice
        shard = dist.host_read_shard(count_frag_seqs(cfg.frag_fn))
        stream = iter_frag_seqs_range(cfg.frag_fn, shard.start, shard.count)
        gid0 = shard.start
    else:
        stream = iter_frag_seqs(cfg.frag_fn)
        gid0 = 0
    for frag_seq in stream:
        frag_seq.gid = gid0 + seen
        seen += 1
        if good_ids is None or frag_seq.id in good_ids:
            if cfg.do_adapter_trimming:
                trim_frag(frag_seq, cfg.adapter, adapt_align)
            else:
                frag_seq.trimmed = False
            if use_native:
                pending.append(frag_seq)
                if len(pending) >= NATIVE_BATCH:
                    _flush_native()
            elif use_torch:
                pending.append(frag_seq)
                if len(pending) >= scorer.batch:
                    flush_pending()
            else:
                frag_len = (
                    frag_seq.trim_point + 1 if frag_seq.trimmed else frag_seq.seq_len
                )
                if new_kmer_filter(
                    frag_seq.seq,
                    frag_len,
                    fkpa,
                    rkpa,
                    cfg.kmer_filt_len,
                    fw_align.align_mask,
                    rc_align.align_mask,
                    fw_align.len1,
                    rc_align.len1,
                ):
                    sg_align(maln, frag_seq, fsdb, fw_align, rc_align)
        if seen % 1000 == 0:
            sys.stderr.write(".")
        if seen % 80000 == 0:
            sys.stderr.write("\n")
    if use_native:
        _flush_native()
    elif use_torch:
        flush_pending(final=True)
    finish_pool.shutdown(wait=True)
    prep_pool.shutdown(wait=True)
    if bhost is not None:
        bhost.close()
    profiling.count("pass1.reads_seen", seen)
    profiling.add_time("pass1", time.time() - t_pass1)

    with profiling.phase("filters.pop_smp"):
        pop_smp_from_FSDB(fsdb, PSSM_DEPTH)
    sys.stderr.write("\n")
    iter_num = 1

    # culled maln: shares the ref, sized to the current alignment count
    # (init_culled_map_alignment, src/mia.c:41-58)
    culled = MapAlignment()
    culled.ref = maln.ref
    culled.cons_code = maln.cons_code
    culled.distant_ref = maln.distant_ref
    if multi:
        culled.size = int(
            dist.allreduce_terms(np.array([maln.num_aln_seqs], np.int64))[0]
        )
    else:
        culled.size = maln.num_aln_seqs

    def _filter_and_cull() -> None:
        """Repeat filters + score cull — globally replayed when multi-host
        (the stub FSDB reproduces the single-process sort/uniq/fit history,
        including float summation order)."""
        _log("Repeat and score filtering")
        if multi:
            with profiling.phase("dist.replay"):
                gf.refresh(fsdb)
                gf.assign_slots()  # global maln slot layout BEFORE the sorts
        with profiling.phase("filters.repeat"):
            if cfg.repeat_filt:
                sort_fsdb(fsdb)
                if multi:
                    with profiling.phase("dist.replay"):
                        gf.sort_and_uniq(False, cfg.just_outer_coords, cfg.tolerance, fsdb)
                else:
                    set_uniq_in_fsdb(fsdb, cfg.just_outer_coords, cfg.tolerance)
            if cfg.repeat_qual_filt:
                sort_fsdb_qscore(fsdb)
                if multi:
                    with profiling.phase("dist.replay"):
                        gf.sort_and_uniq(True, cfg.just_outer_coords, cfg.tolerance, fsdb)
                else:
                    set_uniq_in_fsdb(fsdb, cfg.just_outer_coords, cfg.tolerance)
        with profiling.phase("filters.cull"):
            if multi and cfg.hard_cut <= 0 and not cfg.score_cut_set:
                slope, intercept = gf.score_cut()
                cull_maln_from_fsdb(culled, fsdb, cfg.hard_cut, True, slope, intercept)
            else:
                cull_maln_from_fsdb(
                    culled, fsdb, cfg.hard_cut, cfg.score_cut_set, cfg.slope,
                    cfg.intercept,
                )
        if multi:
            dist.allreduce_max(maln.ref.gaps)
        culled.fpsm = ancsubmat
        culled.rpsm = rcancsubmat
        with profiling.phase("filters.sort_aln"):
            sort_aln_frags(culled)
        if multi:
            with profiling.phase("dist.replay"):
                # global slot-dropped replay: the reference's DR bit is sticky
                # per REUSED maln slot; override the local (sharded) stale
                # flags with the single-process bits so consensus and the
                # writer see exactly what one process would
                drops = gf.cull_drops(
                    cfg.hard_cut, cfg.score_cut_set, cfg.slope, cfg.intercept,
                    culled.distant_ref, maln.ref,
                )
                sp = gf.sort_pos()
                for fs in fsdb.fss:
                    if not fs.unique_best:
                        continue
                    p = sp[fs.gid]
                    if (p, 0) in drops:
                        fs.front_asp.dropped = drops[(p, 0)]
                    if fs.back_asp is not None and (p, 1) in drops:
                        fs.back_asp.dropped = drops[(p, 1)]
                # records freshly merged under this layout enter the global
                # slot->content map (collective; see write_ma_global)
                gf.snapshot_fresh(fsdb)

    def _write_maln(fn: str) -> None:
        with profiling.phase("io.write_maln"):
            if multi:
                dist.write_ma_global(fn, culled, gf, fsdb, culled.size)
            else:
                write_ma(fn, culled)

    def _write_fastq() -> None:
        with profiling.phase("io.write_fastq"):
            if multi:
                gf.write_fastq_host0(cfg.fastq_out_fn)
            else:
                write_fastq(cfg.fastq_out_fn, fsdb)

    def _collapse() -> None:
        with profiling.phase("filters.collapse"):
            if multi:
                gf.collapse(fsdb, cfg.hard_cut, cfg.score_cut_set, cfg.slope,
                            cfg.intercept)
            else:
                collapse_FSDB(fsdb, cfg.hard_cut, cfg.score_cut_set, cfg.slope,
                              cfg.intercept)

    _filter_and_cull()

    fw_align.submat = ancsubmat
    fw_align.sg5 = True
    fw_align.sg3 = True

    last_assembly_cons = maln.ref.seq[: maln.ref.seq_len]

    fw_align.align_mask[: fw_align.len1] = 1
    with profiling.phase("filters.clean"):
        clean_FSDB(fsdb)
        if multi:
            gf.clean()
    if cfg.collapse:
        _collapse()

    with profiling.phase("reiterate"):
        reiterate_assembly(
            last_assembly_cons, iter_num, maln, fsdb, fw_align, ancsubmat,
            rcancsubmat, engine=cfg.engine, placement=placement,
        )
    with profiling.phase("filters.pop_smp_first"):
        pop_smp_from_FSDB(fsdb, PSSM_DEPTH)
    _filter_and_cull()
    maln_fn = f"{cfg.maln_root}.{iter_num}"
    if not cfg.iterate or not cfg.final_only:
        _write_maln(maln_fn)
        if cfg.make_fastq:
            _write_fastq()

    consensus = functools.partial(consensus_assembly_string, reduce_cc=reduce_cc)
    if use_torch:
        consensus = functools.partial(ConsensusHook(placement.counts()).consensus,
                                      reduce_cc=reduce_cc)

    def _unconverged() -> bool:
        eq = assembly_cons == last_assembly_cons
        if multi:
            return not dist.converged_everywhere(eq)
        return not eq

    if cfg.iterate:
        _log("Generating new assembly consensus")
        with profiling.phase("consensus"):
            assembly_cons = consensus(culled)

        while _unconverged() and iter_num < MAX_ITER:
            iter_num += 1
            last_assembly_cons = assembly_cons
            _log(f"Starting assembly iteration {iter_num}")

            if cfg.collapse:
                _collapse()
            with profiling.phase("reiterate"):
                reiterate_assembly(
                    assembly_cons, iter_num, maln, fsdb, fw_align, ancsubmat,
                    rcancsubmat, engine=cfg.engine, placement=placement,
                )
            with profiling.phase("filters.pop_smp"):
                pop_smp_from_FSDB(fsdb, PSSM_DEPTH)
            _filter_and_cull()
            maln_fn = f"{cfg.maln_root}.{iter_num}"
            if not cfg.final_only:
                _log(f"Writing maln file for iteration {iter_num}")
                _write_maln(maln_fn)
            with profiling.phase("consensus"):
                assembly_cons = consensus(culled)

        if assembly_cons == last_assembly_cons:
            _log("Assembly convergence - writing final maln")
        else:
            _log(f"Assembly did not converge after {iter_num} rounds, quitting")
        maln_fn = f"{cfg.maln_root}.{iter_num}"
        if cfg.final_only:
            _write_maln(maln_fn)
        if cfg.make_fastq:
            _write_fastq()

    return culled
