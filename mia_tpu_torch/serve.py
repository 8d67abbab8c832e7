"""Resident scoring server of the port, and its client.

A new process of the port pays ``import torch`` and a CUDA context before
its first batch, seconds against the ~1.3 s of a warm 20k-read assembly
(PERF.md §5).  This module keeps one process that holds the card, its
context and the built kernel library, and scores batches and counts
consensus columns for short ``mia`` runs over a unix-domain socket.  The
client half imports numpy and :mod:`mia_tpu_torch.core.entries` only, so a
single-process run through a server never imports torch.  The port's
counterpart of ``mia_tpu/serve.py``, with the same names.

Protocol: length-prefixed pickles (4-byte magic, 8-byte little-endian
length) over a unix socket of mode 0600 (pickle runs code on load, so only
this user may connect).  A request is a dict with an ``op``; a reply is
``("ok", payload)`` or ``("err", traceback)``:

    hello                                   -> {platform, devices, device, name,
                                                pid, build, library, counters}
    scorer   {fw, rc, len1, sms, batch, hp_seqs} -> {sid, ready}
    ready    {sid}                          -> {ready}
    dispatch {sid, ref_sel, starts, ivl, s2c, lengths, smidx, wide} -> {hid}
    hready   {hid}                          -> {ready}
    collect  {hid}                          -> {best, aec, wide_best, wide_aec}
                                               (int32; wide_*: None without wide)
    consensus {seq, smp, starts, spans, seq_off, smp_off, revs, fpsm, rpsm, n}
                                            -> {counts, cov, scores}
    free     {sid}                          -> {}

``wide`` is a pass-1 batch's ``entries.WideRows`` (or None), scored after
the entries by the general-width scorer (under ``-h`` its ``-h`` form), as
in process.

``counters`` are the server's launch counts (``dp.kernel_launches``,
``dp.plain_calls``, ``dp.hp_kernel_launches``, ``dp.hp_plain_calls``,
``dp.last_row_launches``, ``dp.last_row_plain_calls``,
``dp.last_row_band_launches``, ``dp.last_row_band_plain_calls``,
``dp.last_row_rows``, ``dp.last_row_band_rows``,
``dp.last_row_strand_launches``, ``dp.last_row_strand_plain_calls``,
``dp.last_row_strand_rows``, ``dp.last_row_hp_launches``, ``dp.last_row_hp_plain_calls``,
``dp.last_row_hp_band_launches``, ``dp.last_row_hp_band_plain_calls``,
``dp.last_row_hp_strand_launches``, ``dp.last_row_hp_strand_plain_calls``,
``dp.last_row_hp_strand_rows``, ``cons.kernel_launches``,
``cons.plain_calls``): a caller reads them before
and after a run to see that the card did its work.  ``build`` is
:func:`build_id` of the server's sources when it started, and ``library``
the hash of the kernel library it loaded (None on the CPU); a client
refuses a server whose ``build`` is not its own, so a server started from
another checkout, or before an edit, never scores this one's runs.

The server keeps each reference's device state (:class:`ScorerState`) by
content hash, so a second run on the same reference uploads nothing; every
connection gets scorers of its own over it
(:meth:`Pass1Scorer.from_state`), and every dispatch stages its inputs in
pinned memory of its own.  Launches from the connections' threads are
serialised by one lock (they queue on one stream anyway).

Left out of ``mia_tpu/serve.py``, each of which existed for a TPU behind a
slow link and remote compiles (ROADMAP, North star): the warm-shape list
and its prewarm at start (``serve.py:82-162``), the two-stage idle warm of
consensus shapes in a subprocess (``:259-343``), the ``nowait`` cold
consensus that sends a pass to the host (``:425-461``), the
2M-observation device-consensus threshold (``MIA_TPU_CONS_DEVICE_MIN``)
and the 2048-read ``-h`` batch cap (``:509``).  Nor does a failure move a
run anywhere: ``mia_tpu`` runs a run on the native engine when it has just
spawned a server and swallows a server's errors; here a missing, dead or
failing server named by the policy raises, and the run exits non-zero.

Client policy, ``MIA_TORCH_SERVER`` (:func:`connect`):

* unset or ``auto``: the default socket (:func:`sock_path`, under this
  process's temporary directory) when a server there answers ``hello``;
  otherwise the run scores in its own process;
* ``spawn``: the same, but when nobody answers, start
  ``python -m mia_tpu_torch.cli.serve`` on the default socket and wait up
  to :data:`SPAWN_WAIT_S` for its ``hello``; raise if none comes;
* a path: the server on that socket; raise if nobody answers;
* ``0``: never a server.

A client removes no socket file: a server starting on a path replaces a
dead server's socket there.  A client refuses a server of another
``build``; one that did not ask for the CPU (``MIA_TORCH_DEVICE=cpu``)
refuses a server on the CPU, and one that asked refuses a server on a card.

Reference analogue: none; the reference is a single C process.
"""
from __future__ import annotations

import hashlib
import itertools
import os
import pickle
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from collections import OrderedDict

import numpy as np

_MAGIC = b"MTS1"
_HDR = 12
POLICY = "MIA_TORCH_SERVER"
SOCK = "MIA_TORCH_SERVER_SOCK"
# how long ``spawn`` waits for a new server's hello: import torch, the CUDA
# context and a cold kernel build take ~10-60 s on the card
SPAWN_WAIT_S = 300.0
# device states the server keeps (one per reference: pass 1's and each
# iteration's consensus), the oldest dropped first
MAX_STATES = 64
COUNTERS = ("dp.kernel_launches", "dp.plain_calls", "dp.hp_kernel_launches",
            "dp.hp_plain_calls", "dp.last_row_launches", "dp.last_row_plain_calls",
            "dp.last_row_band_launches", "dp.last_row_band_plain_calls",
            "dp.last_row_rows", "dp.last_row_band_rows",
            "dp.last_row_strand_launches", "dp.last_row_strand_plain_calls",
            "dp.last_row_strand_rows", "dp.last_row_hp_launches", "dp.last_row_hp_plain_calls",
            "dp.last_row_hp_band_launches", "dp.last_row_hp_band_plain_calls",
            "dp.last_row_hp_strand_launches", "dp.last_row_hp_strand_plain_calls",
            "dp.last_row_hp_strand_rows", "cons.kernel_launches", "cons.plain_calls")


class ServerUnavailable(RuntimeError):
    """The policy names a server that does not answer, or one on the wrong
    device."""


def sock_path() -> str:
    """The default socket: ``MIA_TORCH_SERVER_SOCK``, else
    ``mia-torch-serve-<uid>.sock`` in the temporary directory
    (``tempfile.gettempdir()``: ``$TMPDIR``, else ``/tmp``)."""
    return os.environ.get(SOCK) or os.path.join(
        tempfile.gettempdir(), f"mia-torch-serve-{os.getuid()}.sock")


_BUILD: str | None = None


def build_id() -> str:
    """A hash of the package's sources: every ``.py`` file and the kernels'
    ``.cu`` / ``.cuh`` (whose hash, with the compiler's flags in
    ``utils/torchcfg.py``, also names the kernel library's build)."""
    global _BUILD
    if _BUILD is None:
        root = os.path.dirname(os.path.abspath(__file__))
        h = hashlib.sha256()
        for d, dirs, files in sorted(os.walk(root)):
            dirs[:] = sorted(x for x in dirs if x != "__pycache__")
            for fn in sorted(files):
                if fn.endswith((".py", ".cu", ".cuh")):
                    path = os.path.join(d, fn)
                    with open(path, "rb") as f:
                        h.update(os.path.relpath(path, root).encode() + b"\0" + f.read())
        _BUILD = h.hexdigest()[:16]
    return _BUILD


def _send(conn: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    conn.sendall(_MAGIC + struct.pack("<Q", len(data)) + data)


def _recv_exact(conn: socket.socket, n: int, what: str) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = conn.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError(f"peer closed {what}")
        got += r
    return buf


def _recv(conn: socket.socket):
    hdr = _recv_exact(conn, _HDR, "before a message")
    if hdr[:4] != _MAGIC:
        raise ConnectionError(f"bad magic {bytes(hdr[:4])!r}")
    (n,) = struct.unpack("<Q", hdr[4:])
    return pickle.loads(_recv_exact(conn, n, "mid-message"))


# --------------------------------------------------------------------- server
class Server:
    """The resident process: one thread per connection, the device set up
    before the socket is bound (a socket that answers ``hello`` can score at
    once).  Stops after ``idle_timeout`` seconds without a request (0:
    never) or on SIGTERM / SIGINT (``cli/serve.py``), and then removes its
    socket."""

    def __init__(self, path: str | None = None, idle_timeout: float = 0.0):
        self.path = path or sock_path()
        self.idle_timeout = idle_timeout
        self.build = build_id()  # of the sources as this process loads them
        self.library = None
        self._states: OrderedDict = OrderedDict()  # key -> ScorerState
        self._lock = threading.Lock()      # the state cache
        self._launch = threading.Lock()    # dispatches and consensus calls
        self._last = time.time()

    def _setup_device(self) -> None:
        import torch

        from .ops import consensus_torch, dp_cuda
        from .utils.torchcfg import build_kernels, kernel_library, select_device

        self.device = select_device()
        if self.device.type == "cuda":
            torch.zeros(1, device=self.device)
            torch.cuda.synchronize(self.device)
            kernel_library()
            with open(build_kernels(), "rb") as f:
                self.library = hashlib.sha256(f.read()).hexdigest()[:16]
            self.name = torch.cuda.get_device_name(self.device)
            self.n_devices = torch.cuda.device_count()
        else:
            self.name, self.n_devices = "cpu", 1
        self._modules = {"dp": dp_cuda, "cons": consensus_torch}

    def serve_forever(self) -> None:
        self._setup_device()
        if _answers(self.path):
            raise RuntimeError(f"a server already answers on {self.path}")
        # bound and listening under a name of its own, then renamed onto the
        # path (replacing a dead server's socket): a client never finds a
        # socket at the path that is not yet listening
        tmp = f"{self.path}.{os.getpid()}"
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        # never group- or other-connectable, not even between bind and chmod
        old_umask = os.umask(0o177)
        try:
            srv.bind(tmp)
        finally:
            os.umask(old_umask)
        try:
            os.chmod(tmp, 0o600)
            srv.listen(16)
            os.rename(tmp, self.path)
        except BaseException:
            srv.close()
            os.unlink(tmp)
            raise
        ino = os.stat(self.path).st_ino
        srv.settimeout(1.0)
        try:
            print(f"mia-torch-serve: ready on {self.path} (device {self.device}, "
                  f"{self.name}, build {self.build})", flush=True)
            while True:
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    if self.idle_timeout and time.time() - self._last > self.idle_timeout:
                        print("mia-torch-serve: idle timeout, exiting", flush=True)
                        return
                    continue
                threading.Thread(target=self._client, args=(conn,), daemon=True).start()
        finally:
            srv.close()
            # only our own socket: a newer server may have bound the path
            try:
                if os.stat(self.path).st_ino == ino:
                    os.unlink(self.path)
            except FileNotFoundError:
                pass

    def _client(self, conn: socket.socket) -> None:
        session = _Session()
        try:
            while True:
                req = _recv(conn)
                self._last = time.time()
                try:
                    resp = ("ok", self._handle(req, session))
                except Exception as e:  # report it to the client, keep serving
                    import traceback

                    resp = ("err", f"{type(e).__name__}: {e}\n{traceback.format_exc(limit=5)}")
                _send(conn, resp)
        except OSError:  # the client left (or broke the framing)
            pass
        finally:
            conn.close()

    def counters(self) -> dict:
        return {name: getattr(self._modules[name.split(".")[0]], name.split(".")[1])
                for name in COUNTERS}

    def _state(self, req):
        """The device state of one reference, made once per content (both
        strands, both PSSMs, the length and, under ``-h``, the strands'
        chars)."""
        from .core.torch_engine import hp_state_numpy, padded_state_numpy, state_from_numpy

        hp_seqs = req.get("hp_seqs")
        key = hashlib.sha1(
            req["fw"].tobytes() + req["rc"].tobytes() + req["sms"].tobytes()
            + repr((req["len1"], hp_seqs)).encode()).hexdigest()
        with self._lock:
            state = self._states.get(key)
            if state is not None:
                self._states.move_to_end(key)
                return state
        # a miss: the state is made outside the lock (another connection's
        # hit need not wait for this upload)
        refs, sms = padded_state_numpy(req["fw"], req["rc"], req["len1"], req["sms"][0],
                                       req["sms"][1])
        hp = () if hp_seqs is None else hp_state_numpy(hp_seqs, req["len1"], refs.shape[1])
        state = state_from_numpy(refs, sms, self.device, *hp)
        with self._lock:
            self._states[key] = state
            while len(self._states) > MAX_STATES:
                self._states.popitem(last=False)
        return state

    def _handle(self, req, session: "_Session"):
        op = req["op"]
        if op == "hello":
            return {"platform": self.device.type, "devices": self.n_devices,
                    "device": str(self.device), "name": self.name, "pid": os.getpid(),
                    "build": self.build, "library": self.library, "counters": self.counters()}
        if op == "scorer":
            from .core.torch_engine import Pass1Scorer

            sid = next(session.ids)
            session.scorers[sid] = Pass1Scorer.from_state(self._state(req), req["len1"],
                                                          req["batch"])
            return {"sid": sid, "ready": True}
        if op == "ready":
            return {"ready": req["sid"] in session.scorers}
        if op == "dispatch":
            sc = session.scorers[req["sid"]]
            with self._launch:
                h = sc.dispatch_entries(req["ref_sel"], req["starts"], req["ivl"],
                                        req["s2c"], req["lengths"], req["smidx"])
                wh = sc.dispatch_wide(req.get("wide"))
            hid = next(session.ids)
            session.handles[hid] = (sc, h, wh)
            return {"hid": hid}
        if op == "hready":
            sc, h, wh = session.handles[req["hid"]]
            return {"ready": sc.ready(h) and (wh is None or sc.ready(wh))}
        if op == "collect":
            sc, h, wh = session.handles.pop(req["hid"])
            best, aec = sc.collect_entries(h)
            out = {"best": best.astype(np.int32), "aec": aec.astype(np.int32),
                   "wide_best": None, "wide_aec": None}
            if wh is not None:
                wide_best, wide_aec = sc.collect_entries(wh)
                out["wide_best"], out["wide_aec"] = (wide_best.astype(np.int32),
                                                     wide_aec.astype(np.int32))
            return out
        if op == "consensus":
            from .ops.consensus_torch import device_column_counts

            with self._launch:
                counts, cov, scores = device_column_counts(
                    req["seq"], req["smp"], req["starts"], req["spans"], req["seq_off"],
                    req["smp_off"], req["revs"], req["fpsm"], req["rpsm"], int(req["n"]),
                    device=self.device)
            return {"counts": counts, "cov": cov, "scores": scores}
        if op == "free":
            session.scorers.pop(req["sid"], None)
            return {}
        raise ValueError(f"unknown op {op!r}")


class _Session:
    """One connection's scorers and dispatched batches, by id."""

    def __init__(self):
        self.ids = itertools.count(1)
        self.scorers: dict = {}   # sid -> Pass1Scorer over a cached state
        self.handles: dict = {}   # hid -> (scorer, its batch handle)


# --------------------------------------------------------------------- client
class _Client:
    """One connection to a server; requests on it are serialised (pass 1
    dispatches from a worker thread and collects from the main one)."""

    def __init__(self, path: str, timeout: float = 5.0):
        self.path = path
        self._lock = threading.Lock()
        self._conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            self._conn.settimeout(timeout)
            self._conn.connect(path)
            self._conn.settimeout(600.0)
        except OSError:
            self._conn.close()
            raise

    def rpc(self, req: dict):
        with self._lock:
            _send(self._conn, req)
            status, payload = _recv(self._conn)
        if status != "ok":
            raise RuntimeError(f"server error on {self.path}: {payload}")
        return payload

    def hello(self) -> dict:
        return self.rpc({"op": "hello"})

    def close(self) -> None:
        self._conn.close()


class _Handle:
    """A dispatched batch: the scorer that sent it and the server's id."""

    def __init__(self, scorer: "ServerScorer", hid: int | None):
        self.scorer = scorer
        self.hid = hid


class ServerScorer:
    """Client-side scorer with the surface of
    :class:`~mia_tpu_torch.core.torch_engine.Pass1Scorer` that the
    assembler, the realigner and the pass-1 pipeline use
    (``dispatch_entries`` / ``collect_entries`` / ``dispatch_packed`` /
    ``collect_arrays`` / ``ready``, ``batch`` / ``E`` / ``hp`` / ``len1``),
    backed by the server on ``client``'s connection."""

    def __init__(self, client: _Client, fw_s1c, rc_s1c, len1: int, submat, submat_b=None,
                 batch: int | None = None, hp_seqs: tuple[str, str] | None = None):
        from .core.entries import default_batch

        self.client = client
        self.len1 = len1
        self.batch = batch or default_batch()
        self.E = 2 * self.batch
        self.hp = hp_seqs is not None
        sms = np.stack([np.asarray(submat, np.int32),
                        np.asarray(submat if submat_b is None else submat_b, np.int32)])
        self._sid = client.rpc({
            "op": "scorer", "fw": np.asarray(fw_s1c[:len1], np.int8),
            "rc": np.asarray(rc_s1c[:len1], np.int8), "len1": len1, "sms": sms,
            "batch": self.batch, "hp_seqs": hp_seqs})["sid"]

    def dispatch_entries(self, ref_sel, starts, ivl, s2c, lengths, smidx,
                         wide=None) -> _Handle:
        """Send up to E entries, and with ``wide`` (``entries.WideRows``) a
        pass-1 batch's wide rows, scored after them."""
        n = len(ref_sel)
        if n == 0:
            return _Handle(self, None)
        if n > self.E:
            raise ValueError(f"{n} entries exceed the batch of {self.E}")
        r = self.client.rpc({
            "op": "dispatch", "sid": self._sid,
            "ref_sel": np.ascontiguousarray(ref_sel, np.int8),
            "starts": np.ascontiguousarray(starts, np.int32),
            "ivl": np.ascontiguousarray(ivl, np.int32),
            "s2c": np.ascontiguousarray(s2c, np.uint8 if self.hp else np.int8),
            "lengths": np.ascontiguousarray(lengths, np.int32),
            "smidx": np.ascontiguousarray(smidx, np.int8), "wide": wide})
        return _Handle(self, r["hid"])

    def _collect(self, handle: _Handle) -> dict:
        if handle.hid is None:
            return {"best": np.zeros(0, np.int32), "aec": np.zeros(0, np.int32),
                    "wide_best": None, "wide_aec": None}
        return self.client.rpc({"op": "collect", "hid": handle.hid})

    def collect_entries(self, handle: _Handle):
        """(best, aec) int64 [n]; aec WINDOW-LOCAL, as Pass1Scorer's."""
        r = self._collect(handle)
        return r["best"].astype(np.int64), r["aec"].astype(np.int64)

    def dispatch_packed(self, s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags):
        """As ``Pass1Scorer.dispatch_packed``: the entries and the WIDE
        reads' rows (built here, scored on the server; under ``-h`` by its
        ``-h`` form), the rows the handle's fourth item."""
        from .core.entries import build_pass1_entries, wide_rows

        n = len(lens)
        if n > self.batch:
            raise ValueError(f"{n} reads exceed the batch of {self.batch}")
        if n == 0:
            return _Handle(self, None), fw_ws.copy(), rc_ws.copy(), None
        entries = build_pass1_entries(s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags)
        rows = wide_rows(flags, lens, s2c, fw_ivg, rc_ivg, hp=self.hp)
        return self.dispatch_entries(*entries, wide=rows), fw_ws.copy(), rc_ws.copy(), rows

    def collect_arrays(self, handle):
        """(fb, fa, rb, ra) int64 [n], aec GLOBAL, the wide reads' included."""
        from .core.entries import merge_wide, split_pass1_results

        batch, fw_ws, rc_ws, rows = handle
        r = self._collect(batch)
        fb, fa, rb, ra = split_pass1_results(r["best"].astype(np.int64),
                                             r["aec"].astype(np.int64), fw_ws, rc_ws)
        if rows is not None:
            merge_wide(fb, fa, rb, ra, rows, r["wide_best"].astype(np.int64),
                       r["wide_aec"])
        return fb, fa, rb, ra

    @staticmethod
    def ready(handle) -> bool:
        """True when the batch's results have landed on the server's host;
        takes an entries handle or a packed pass-1 handle."""
        h = handle[0] if isinstance(handle, tuple) else handle
        if h.hid is None:
            return True
        return bool(h.scorer.client.rpc({"op": "hready", "hid": h.hid})["ready"])

    def free(self) -> None:
        """Drop this scorer on the server (its reference's state stays
        cached there)."""
        self.client.rpc({"op": "free", "sid": self._sid})


class _ConsensusClient:
    """``device_hook`` of ``columns.consensus_assembly_string`` that counts
    the main columns on the server's device."""

    def __init__(self, client: _Client):
        self.client = client

    def __call__(self, seq, smp, starts, spans, seq_off, smp_off, revs, fpsm, rpsm, n):
        r = self.client.rpc({
            "op": "consensus",
            "seq": np.ascontiguousarray(seq, np.uint8),
            "smp": np.ascontiguousarray(smp, np.uint8),
            "starts": np.ascontiguousarray(starts, np.int32),
            "spans": np.ascontiguousarray(spans, np.int32),
            "seq_off": np.ascontiguousarray(seq_off, np.int32),
            "smp_off": np.ascontiguousarray(smp_off, np.int32),
            "revs": np.ascontiguousarray(revs, np.bool_),
            "fpsm": np.ascontiguousarray(fpsm, np.int32),
            "rpsm": np.ascontiguousarray(rpsm, np.int32),
            "n": int(n)})
        return r["counts"], r["cov"], r["scores"]


def connect_scorer(client: _Client, fw_s1c, rc_s1c, len1: int, submat, submat_b=None,
                   hp_seqs: tuple[str, str] | None = None) -> ServerScorer:
    """A scorer for one reference on the server behind ``client``."""
    return ServerScorer(client, fw_s1c, rc_s1c, len1, submat, submat_b, hp_seqs=hp_seqs)


def connect_consensus(client: _Client) -> _ConsensusClient:
    """The consensus counts on the server behind ``client``."""
    return _ConsensusClient(client)


# ---------------------------------------------------------------------- policy
def _answers(path: str) -> bool:
    try:
        _Client(path).close()
        return True
    except OSError:
        return False


def _hello(path: str) -> tuple[_Client, dict] | None:
    """A connection and the server's hello, or None when nobody listens on
    ``path`` (no file, or a file nobody accepts on)."""
    try:
        client = _Client(path)
    except (FileNotFoundError, ConnectionRefusedError):
        return None
    try:
        return client, client.hello()
    except BaseException:
        client.close()
        raise


def _checked(client: _Client, hello: dict) -> _Client:
    if hello.get("build") != build_id():
        client.close()
        raise ServerUnavailable(
            f"the server on {client.path} (pid {hello.get('pid')}) runs other sources "
            f"(build {hello.get('build')}, this checkout's {build_id()}): stop it, or set "
            f"{POLICY}=0 or the socket of a server of this checkout")
    want = "cpu" if os.environ.get("MIA_TORCH_DEVICE", "") == "cpu" else "cuda"
    if hello["platform"] != want:
        client.close()
        raise ServerUnavailable(
            f"the server on {client.path} scores on {hello['platform']} "
            f"({hello['name']}), and this run asks for {want}"
            + (" (MIA_TORCH_DEVICE=cpu)" if want == "cpu" else
               " (set MIA_TORCH_DEVICE=cpu to use a server on the CPU)"))
    return client


def connect() -> _Client | None:
    """The server this run uses under the ``MIA_TORCH_SERVER`` policy (see
    the module docstring), or None: score in this process."""
    policy = os.environ.get(POLICY, "auto") or "auto"
    if policy == "0":
        return None
    path = sock_path() if policy in ("auto", "spawn") else policy
    got = _hello(path)
    if got is not None:
        return _checked(*got)
    if policy == "auto":
        return None
    if policy == "spawn":
        return _checked(*spawn_server(path))
    raise ServerUnavailable(f"{POLICY}={policy}: no server answers on {path}")


def _take_lock(lock: str, stale_after: float) -> int | None:
    """An open descriptor of the newly made file ``lock``, or None when
    another spawner holds it; a lock older than ``stale_after`` seconds (its
    spawner never saw a server) is taken over."""
    for _ in range(2):
        try:
            return os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o600)
        except FileExistsError:
            try:
                if time.time() - os.path.getmtime(lock) <= stale_after:
                    return None
                os.unlink(lock)
            except FileNotFoundError:
                pass
    return None


def spawn_server(path: str | None = None, idle_timeout: float = 3600.0,
                 wait: float = SPAWN_WAIT_S) -> tuple[_Client, dict]:
    """Start ``python -m mia_tpu_torch.cli.serve`` on ``path`` (its output
    in ``path + ".log"``) and wait up to ``wait`` seconds for its hello.
    An exclusive lock file beside the socket lets one of several spawners
    start it; the others wait for the same hello.  Returns the connection
    and the hello; raises :class:`ServerUnavailable` when none comes."""
    path = path or sock_path()
    lock = path + ".spawn"
    log = path + ".log"
    proc = None
    fd = _take_lock(lock, stale_after=wait)
    if fd is not None:
        os.close(fd)
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=pkg_root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        with open(log, "ab") as lf:
            proc = subprocess.Popen(
                [sys.executable, "-m", "mia_tpu_torch.cli.serve", "--sock", path,
                 "--idle-timeout", str(idle_timeout)],
                stdout=lf, stderr=lf, stdin=subprocess.DEVNULL, env=env,
                start_new_session=True)
    try:
        deadline = time.time() + wait
        while time.time() < deadline:
            got = _hello(path)
            if got is not None:
                return got
            if proc is not None and proc.poll() is not None:
                break
            time.sleep(0.1)
    finally:
        if proc is not None:
            try:
                os.unlink(lock)
            except FileNotFoundError:
                pass
    try:
        with open(log, "rb") as f:
            tail = f.read()[-2000:].decode(errors="replace")
    except FileNotFoundError:
        tail = "(no log: another process holds the spawn lock)"
    raise ServerUnavailable(f"{POLICY}=spawn: no server answered on {path} within "
                            f"{wait:.0f} s; its log {log} ends:\n{tail}")
