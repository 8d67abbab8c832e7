"""The port's resident scoring server (``mia_tpu_torch.serve``) on the CPU.

A server process (``python -m mia_tpu_torch.cli.serve``, with
``MIA_TORCH_DEVICE=cpu``, so its scorers and consensus counts run their
plain versions) on a socket of a temporary directory; clients are the
port's ``mia`` in processes whose import system refuses torch (and jax and
``mia_tpu``).  A client run must write the committed goldens and the bytes
of the port's in-process ``--engine torch``; the server's ``hello``
counters must show that the server did the scoring and the consensus.  One
run holds the port's server path against ``mia_tpu``'s (the recipe of
tests/test_serve.py); two ranks of a multi-host run share one server.
Then the client policy (``MIA_TORCH_SERVER``) and the protocol's failures:
every one raises, none moves a run elsewhere.
"""
import os
import signal
import socket
import stat
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

from mia_tpu_torch import serve
from mia_tpu_torch import testing as T
from mia_tpu_torch.core.assembler import ConsensusHook
from mia_tpu_torch.core.columns import consensus_assembly_string, main_column_counts
from mia_tpu_torch.core.torch_engine import Pass1Scorer

from .conftest import FIXTURES, GOLDEN
from .test_torch_distributed import run_group
from .test_torch_golden import NO_JAX_MAIN, _norm, fixture_args, profile_counters, run_torch_mia
from .test_torch_imports import NO_TORCH, _run_refusing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra) -> dict:
    env = dict(os.environ, MIA_TORCH_DEVICE="cpu", MIA_SCORE_BATCH="64", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.update(extra)
    return env


def hello(path: str) -> dict:
    client = serve._Client(path)
    try:
        return client.hello()
    finally:
        client.close()


def wait_for_hello(path: str, proc: subprocess.Popen, log: str, limit: float = 120.0) -> dict:
    deadline = time.time() + limit
    while time.time() < deadline:
        if proc.poll() is not None:
            with open(log) as f:
                raise AssertionError(f"server exited {proc.returncode}:\n{f.read()[-3000:]}")
        try:
            return hello(path)
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"no hello on {path} within {limit} s")


def stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def server():
    """The port's server on the CPU for this file's tests: its socket."""
    with tempfile.TemporaryDirectory(prefix="mts") as d:
        path, log = os.path.join(d, "s.sock"), os.path.join(d, "serve.log")
        with open(log, "w") as lf:
            proc = subprocess.Popen(
                [sys.executable, "-m", "mia_tpu_torch.cli.serve", "--sock", path],
                env=_env(), stdout=lf, stderr=subprocess.STDOUT)
        try:
            wait_for_hello(path, proc, log)
            yield path
        finally:
            stop(proc)
        assert proc.returncode == 0 and not os.path.exists(path), "server left its socket"


def client(args, cwd, sock, check=True, **env):
    """The port's mia (``--engine torch --profile``) through ``sock`` with
    torch refused; returns the finished process."""
    r = _run_refusing("mia", [*args, "-m", "out.maln", "--engine", "torch", "--profile"], cwd,
                      NO_TORCH, MIA_TORCH_SERVER=sock, OMP_NUM_THREADS="1", **env)
    if check:
        assert r.returncode == 0, r.stderr.decode()[-3000:]
    return r


def malns(d) -> dict:
    return {fn: _norm(os.path.join(d, fn)) for fn in sorted(os.listdir(d))
            if fn.startswith("out.maln.")}


def delta(before: dict, after: dict) -> dict:
    return {k: after["counters"][k] - before["counters"][k] for k in serve.COUNTERS}


@pytest.mark.parametrize("name", ["kmer", "hp", "fastq_UC"])
def test_client_writes_golden_through_server(name, server, tmp_path):
    (tmp_path / "client").mkdir()
    (tmp_path / "inproc").mkdir()
    before = hello(server)
    c = profile_counters(client(fixture_args(name), tmp_path / "client", server).stderr)
    d = delta(before, hello(server))
    golden = os.path.join(GOLDEN, name)
    got = malns(tmp_path / "client")
    assert got == {fn: _norm(os.path.join(golden, fn)) for fn in sorted(os.listdir(golden))}
    run_torch_mia(fixture_args(name), tmp_path / "inproc")
    assert got == malns(tmp_path / "inproc")
    # the client scored nothing itself: its pass 1, realignments and
    # consensus went to the server, which ran the plain versions (the -h
    # scorer under -h) and no kernel
    hp = name == "hp"
    assert c["pass1.using_server"] == 1 and "pass1.in_process" not in c, c
    assert c["reiterate.device_entries"] > 0 and c["consensus.device_calls"] > 0, c
    assert "consensus.device_fallbacks" not in c, c
    assert c["dp.plain_calls"] == c["dp.hp_plain_calls"] == c["cons.plain_calls"] == 0, c
    if "-k" in fixture_args(name):
        assert c["pass1.device_scored_reads"] > 0, c
    assert d["dp.hp_plain_calls" if hp else "dp.plain_calls"] > 0, d
    assert d["dp.plain_calls" if hp else "dp.hp_plain_calls"] == 0, d
    assert d["cons.plain_calls"] == c["consensus.device_calls"], (c, d)
    assert d["dp.kernel_launches"] == d["dp.hp_kernel_launches"] == d["cons.kernel_launches"] == 0
    # pass 1's WIDE reads (every read without -k): the server scored them
    # full width, with the plain versions of the general-width scorer's
    # forms (band, strand and full), under -h its -h forms'; none by the native
    # solve
    assert c["dp.last_row_plain_calls"] == c["dp.last_row_hp_plain_calls"] == 0, c
    assert c["dp.last_row_band_plain_calls"] == c["dp.last_row_hp_band_plain_calls"] == 0, c
    assert c["dp.last_row_strand_plain_calls"] == c["dp.last_row_hp_strand_plain_calls"] == 0, c
    assert d["dp.last_row_launches"] == d["dp.last_row_hp_launches"] == 0, d
    assert d["dp.last_row_band_launches"] == d["dp.last_row_hp_band_launches"] == 0, d
    assert d["dp.last_row_strand_launches"] == d["dp.last_row_hp_strand_launches"] == 0, d
    assert c.get("pass1.native_solved_wide_reads", 0) == 0, c
    wide = c["pass1.device_scored_wide_reads"]
    assert wide > 0 or "-k" in fixture_args(name), c
    hp_plain = (d["dp.last_row_hp_plain_calls"] + d["dp.last_row_hp_band_plain_calls"]
                + d["dp.last_row_hp_strand_plain_calls"])
    no_hp_plain = (d["dp.last_row_plain_calls"] + d["dp.last_row_band_plain_calls"]
                   + d["dp.last_row_strand_plain_calls"])
    plain, other = (hp_plain, no_hp_plain)[:: 1 if hp else -1]
    assert (plain > 0) == (wide > 0), (c, d)
    assert other == 0, d


def test_server_path_equals_mia_tpu_server_path(server, tmp_path):
    """tr1/tf (-c -k 12) through the port's server and through mia_tpu's
    (tests/test_serve.py's recipe): the same maln bytes."""
    args = ["-r", os.path.join(FIXTURES, "tr1.fna"), "-f", os.path.join(FIXTURES, "tf.fna"),
            "-c", "-k", "12"]
    with tempfile.TemporaryDirectory(prefix="mts") as d:
        sock, log = os.path.join(d, "tpu.sock"), os.path.join(d, "tpu.log")
        env = _env(MIA_JAX_PLATFORM="cpu", JAX_PLATFORMS="cpu")
        with open(log, "w") as lf:
            proc = subprocess.Popen([sys.executable, "-m", "mia_tpu.cli.serve", "--sock", sock],
                                    env=env, stdout=lf, stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 120
            while not os.path.exists(sock):
                assert proc.poll() is None and time.time() < deadline, open(log).read()
                time.sleep(0.2)
            (tmp_path / "tpu").mkdir()
            r = subprocess.run(
                [sys.executable, "-m", "mia_tpu.cli.mia", *args, "-m", "out.maln",
                 "--engine", "jax", "--profile"],
                cwd=tmp_path / "tpu", env=dict(env, MIA_TPU_SERVER=sock, MIA_TPU_STEAL="0"),
                capture_output=True, timeout=600)
            assert r.returncode == 0, r.stderr.decode()[-3000:]
        finally:
            proc.terminate()
            proc.wait(timeout=30)
    assert profile_counters(r.stderr).get("pass1.using_server") == 1
    (tmp_path / "port").mkdir()
    c = profile_counters(client(args, tmp_path / "port", server).stderr)
    assert c["pass1.using_server"] == 1 and c["pass1.device_scored_reads"] > 0, c
    want = malns(tmp_path / "tpu")
    assert want and malns(tmp_path / "port") == want


def test_two_ranks_through_one_server(server, tmp_path):
    """A two-process run whose ranks are both clients of one server writes
    the golden from rank 0 and nothing from rank 1."""
    dirs = [tmp_path / f"rank{i}" for i in range(2)]
    for d in dirs:
        d.mkdir()
    before = hello(server)
    argv = [sys.executable, "-c", NO_JAX_MAIN, *fixture_args("kmer"), "-m", "out.maln",
            "--engine", "torch", "--profile"]
    counters = [profile_counters(e) for e in run_group([argv] * 2, dirs, 2,
                                                               MIA_TORCH_SERVER=server)]
    d = delta(before, hello(server))
    golden = os.path.join(GOLDEN, "kmer")
    assert malns(dirs[0]) == {fn: _norm(os.path.join(golden, fn))
                              for fn in sorted(os.listdir(golden))}
    assert os.listdir(dirs[1]) == []
    for c in counters:
        assert c["pass1.using_server"] == 1 and c["pass1.device_scored_reads"] > 0, c
        assert c["dp.plain_calls"] == c["cons.plain_calls"] == 0, c
        assert c["dist.collectives"] > 0, c
    assert d["dp.plain_calls"] > 0 and d["cons.plain_calls"] > 0, d


def test_server_packed_batch_equals_in_process_scorer(server):
    """A pass-1 batch with WIDE reads through ServerScorer and through
    Pass1Scorer: the same (fb, fa, rb, ra), the wide reads' scored full width
    on the server."""
    rng = np.random.default_rng(5)
    len1, n = 1500, 40
    fw = rng.integers(0, 5, len1).astype(np.int8)
    rc = rng.integers(0, 5, len1).astype(np.int8)
    sm = T.random_entries(4, 8, seed=5, len1=len1)["sms"][0]
    s2c = rng.integers(0, 5, (n, 256)).astype(np.int32)
    lens = rng.integers(20, 100, n).astype(np.int32)
    ws = rng.integers(0, len1 - 400, (2, n)).astype(np.int32)
    ivg = np.zeros((2, n, 16, 2), np.int32)
    ivg[:, :, 0, 0], ivg[:, :, 0, 1] = ws + 3, ws + 300
    ivg[:, ::4, 1, 0], ivg[:, ::4, 1, 1] = ws[:, ::4] + 900, ws[:, ::4] + 1000
    ivg[1, ::8] = 0  # WIDE reads with no rc band
    flags = np.where(np.arange(n) % 4 == 0, 4, 0).astype(np.int32)
    args = (s2c, lens, ws[0], ws[1], ivg[0], ivg[1], flags)
    local = Pass1Scorer(fw, rc, len1, sm, batch=n, device="cpu")
    want = local.collect_arrays(local.dispatch_packed(*args))
    conn = serve._Client(server)
    try:
        before = conn.hello()["counters"]
        remote = serve.ServerScorer(conn, fw, rc, len1, sm, batch=n)
        h = remote.dispatch_packed(*args)
        while not remote.ready(h):
            time.sleep(0.01)
        got = remote.collect_arrays(h)
        after = conn.hello()["counters"]
        remote.free()
    finally:
        conn.close()
    # every wide row's band takes 401 columns: two warps of the band form
    assert after["dp.last_row_band_plain_calls"] == before["dp.last_row_band_plain_calls"] + 1
    assert after["dp.last_row_plain_calls"] == before["dp.last_row_plain_calls"]
    assert after["dp.last_row_strand_plain_calls"] == before["dp.last_row_strand_plain_calls"]
    assert after["dp.last_row_band_rows"] > before["dp.last_row_band_rows"]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert (got[2][::8] == -(2**30)).all() and (got[0][1::4] != got[0][::4].min()).any()


def test_server_packed_hp_batch_equals_in_process_scorer(server):
    """The -h case of the test above: a pass-1 batch of read chars with
    WIDE reads through ServerScorer and through Pass1Scorer, both with the
    strands' chars: the same (fb, fa, rb, ra), the wide reads scored full
    width by the -h form's plain version on the server."""
    rng = np.random.default_rng(6)
    len1, n = 1500, 40
    fw = T._runs_string(rng, len1)
    rc = fw[::-1]
    fw_c, rc_c = (np.frombuffer(x.encode(), np.uint8) for x in (fw, rc))
    sm = T.random_entries(4, 8, seed=6, len1=len1)["sms"][0]
    lens = rng.integers(20, 100, n).astype(np.int32)
    s2chr = np.zeros((n, 256), np.uint8)
    for i in range(n):
        p = int(rng.integers(0, len1 - 200))
        s2chr[i, : lens[i]] = (fw_c if i % 2 else rc_c)[p : p + lens[i]]
    ws = rng.integers(0, len1 - 400, (2, n)).astype(np.int32)
    ivg = np.zeros((2, n, 16, 2), np.int32)
    ivg[:, :, 0, 0], ivg[:, :, 0, 1] = ws + 3, ws + 300
    ivg[:, ::4, 1, 0], ivg[:, ::4, 1, 1] = ws[:, ::4] + 900, ws[:, ::4] + 1000
    ivg[1, ::8] = 0  # WIDE reads with no rc band
    flags = np.where(np.arange(n) % 4 == 0, 4, 0).astype(np.int32)
    args = (s2chr, lens, ws[0], ws[1], ivg[0], ivg[1], flags)
    codes = [T.encode_seq(x) for x in (fw, rc)]
    local = Pass1Scorer(*codes, len1, sm, batch=n, device="cpu", hp_seqs=(fw, rc))
    want = local.collect_arrays(local.dispatch_packed(*args))
    conn = serve._Client(server)
    try:
        before = conn.hello()["counters"]
        remote = serve.ServerScorer(conn, *codes, len1, sm, batch=n, hp_seqs=(fw, rc))
        h = remote.dispatch_packed(*args)
        while not remote.ready(h):
            time.sleep(0.01)
        got = remote.collect_arrays(h)
        after = conn.hello()["counters"]
        remote.free()
    finally:
        conn.close()
    # every wide row's band takes 401 columns: two warps of the band form
    assert (after["dp.last_row_hp_band_plain_calls"]
            == before["dp.last_row_hp_band_plain_calls"] + 1)
    assert after["dp.last_row_hp_plain_calls"] == before["dp.last_row_hp_plain_calls"]
    assert after["dp.last_row_plain_calls"] == before["dp.last_row_plain_calls"]
    assert after["dp.last_row_band_plain_calls"] == before["dp.last_row_band_plain_calls"]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert (got[2][::8] == -(2**30)).all() and (got[0][::4] > -(2**30)).all()


@pytest.mark.parametrize("hp", [False, True], ids=["scorer", "hp_scorer"])
def test_server_scorer_equals_in_process_scorer(hp, server):
    """ServerScorer against Pass1Scorer on the same entries (both strands,
    both PSSMs, every kind of band): the same (best, aec)."""
    d = (T.random_hp_entries if hp else T.random_entries)(48, 64, seed=3, len1=700)
    len1 = d["len1"]
    fw, rc = d["refs"][0, :len1], d["refs"][1, :len1]
    hp_seqs = (tuple(d["refchr"][i, :len1].tobytes().decode() for i in range(2))
               if hp else None)
    s2c = d["s2chr"] if hp else d["s2c"]
    entries = (d["ref_sel"], d["starts"], d["ivl"], s2c, d["lengths"], d["smidx"])
    local = Pass1Scorer(fw, rc, len1, d["sms"][0], d["sms"][1], batch=24, device="cpu",
                        hp_seqs=hp_seqs)
    want = local.collect_entries(local.dispatch_entries(*entries))
    conn = serve._Client(server)
    try:
        remote = serve.ServerScorer(conn, fw, rc, len1, d["sms"][0], d["sms"][1], batch=24,
                                    hp_seqs=hp_seqs)
        assert (remote.batch, remote.E, remote.hp, remote.len1) == (24, 48, hp, len1)
        h = remote.dispatch_entries(*entries)
        while not remote.ready(h):
            time.sleep(0.01)
        got = remote.collect_entries(h)
        empty = remote.collect_entries(remote.dispatch_entries(*(a[:0] for a in entries)))
        assert conn.rpc({"op": "ready", "sid": remote._sid})["ready"]
        remote.free()
        assert not conn.rpc({"op": "ready", "sid": remote._sid})["ready"]
    finally:
        conn.close()
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and np.array_equal(g, w)
    assert [len(a) for a in empty] == [0, 0]


def test_server_consensus_equals_host_counts(server):
    maln = T.random_records(400, 500, seed=5)
    maln.ref.gaps = np.zeros(401, np.int64)
    host = main_column_counts(maln, exclude_dropped=True)
    conn = serve._Client(server)
    try:
        count = serve.connect_consensus(conn)
        got = main_column_counts(maln, exclude_dropped=True, device_hook=count)
        assert ConsensusHook(count).consensus(maln) == consensus_assembly_string(maln)
    finally:
        conn.close()
    for name in ("counts", "cov", "scores"):
        assert np.array_equal(getattr(got, name), getattr(host, name)), name


# ---------------------------------------------------------------- the policy
def _dead_socket(path: str) -> None:
    """A socket file nobody accepts on: a server that died without cleanup."""
    s = socket.socket(socket.AF_UNIX)
    s.bind(path)
    s.close()


@pytest.mark.parametrize("kind", ["missing", "dead"])
def test_named_server_that_does_not_answer_fails_the_run(kind, tmp_path):
    with tempfile.TemporaryDirectory(prefix="mts") as d:
        sock = os.path.join(d, "s.sock")
        if kind == "dead":
            _dead_socket(sock)
        r = client(fixture_args("kmer"), tmp_path, sock, check=False)
        assert os.path.exists(sock) == (kind == "dead"), "a named socket is never removed"
    assert r.returncode != 0
    assert b"no server answers on" in r.stderr, r.stderr.decode()[-2000:]
    assert not any(p.startswith("out.maln") for p in os.listdir(tmp_path))


class _FakeServer:
    """A socket that answers ``hello`` with ``hello`` and every other op
    with an error, in a thread, for one connection."""

    def __init__(self, path: str, hello: dict):
        self.srv = socket.socket(socket.AF_UNIX)
        self.srv.bind(path)
        self.srv.listen(1)
        self.srv.settimeout(120)
        self.hello = hello
        self.thread = threading.Thread(target=self._answer, daemon=True)

    def _answer(self):
        conn, _ = self.srv.accept()
        with conn:
            try:
                while True:
                    op = serve._recv(conn)["op"]
                    serve._send(conn, ("ok", self.hello) if op == "hello"
                                else ("err", f"boom in {op}"))
            except ConnectionError:
                pass

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.thread.join(timeout=60)
        self.srv.close()
        assert not self.thread.is_alive()


def test_server_error_fails_the_run(tmp_path):
    """A server whose every reply after hello is an error: the run raises
    it and writes nothing."""
    with tempfile.TemporaryDirectory(prefix="mts") as d:
        sock = os.path.join(d, "s.sock")
        with _FakeServer(sock, {"platform": "cpu", "name": "cpu", "build": serve.build_id()}):
            r = client(fixture_args("kmer"), tmp_path, sock, check=False)
    assert r.returncode != 0
    assert b"server error" in r.stderr and b"boom in scorer" in r.stderr, r.stderr[-2000:]
    assert not any(p.startswith("out.maln") for p in os.listdir(tmp_path))


@pytest.mark.parametrize("policy", ["named", "auto"])
def test_client_refuses_server_of_other_sources(policy, tmp_path):
    """A server whose ``build`` is not this checkout's (another checkout's,
    or one started before an edit) is refused, named or found on the
    default socket, and the run writes nothing."""
    with tempfile.TemporaryDirectory(prefix="mts") as d:
        sock = os.path.join(d, f"mia-torch-serve-{os.getuid()}.sock")
        with _FakeServer(sock, {"platform": "cpu", "name": "cpu", "pid": 1,
                                "build": "0" * 16}):
            r = client(fixture_args("kmer"), tmp_path, sock if policy == "named" else "auto",
                       check=False, TMPDIR=d)
    assert r.returncode != 0
    assert b"runs other sources" in r.stderr and serve.build_id().encode() in r.stderr, \
        r.stderr[-2000:]
    assert not any(p.startswith("out.maln") for p in os.listdir(tmp_path))


@pytest.mark.parametrize("stale", [False, True], ids=["no_socket", "stale_socket"])
def test_auto_without_server_scores_in_process(stale, tmp_path):
    """No server answers on the default socket (in the temporary
    directory): the run scores in its own process, and leaves a dead
    server's socket file where it is (a client removes no socket)."""
    with tempfile.TemporaryDirectory(prefix="mts") as d:
        default = os.path.join(d, f"mia-torch-serve-{os.getuid()}.sock")
        if stale:
            _dead_socket(default)
        r = run_torch_mia(fixture_args("kmer"), tmp_path,
                          extra_env={"MIA_TORCH_SERVER": "auto", "TMPDIR": d})
        assert os.path.exists(default) == stale
    c = profile_counters(r.stderr)
    assert c["pass1.in_process"] == 1 and "pass1.using_server" not in c, c
    assert c["dp.plain_calls"] > 0 and c["cons.plain_calls"] > 0, c
    golden = os.path.join(GOLDEN, "kmer")
    assert malns(tmp_path) == {fn: _norm(os.path.join(golden, fn))
                               for fn in sorted(os.listdir(golden))}


def test_gpu_client_refuses_cpu_server(server, tmp_path):
    r = client(fixture_args("kmer"), tmp_path, server, check=False, MIA_TORCH_DEVICE="")
    assert r.returncode != 0
    assert b"scores on cpu" in r.stderr and b"MIA_TORCH_DEVICE=cpu" in r.stderr, r.stderr
    assert not any(p.startswith("out.maln") for p in os.listdir(tmp_path))


@pytest.mark.parametrize("stale", [False, True], ids=["no_socket", "stale_socket"])
def test_spawn_starts_a_server_and_uses_it(stale, tmp_path):
    """``spawn`` with no server: the client starts one on the default
    socket (replacing a dead server's socket file there), waits for it and
    scores through it; SIGTERM stops it and its socket goes."""
    with tempfile.TemporaryDirectory(prefix="mts") as d:
        default = os.path.join(d, f"mia-torch-serve-{os.getuid()}.sock")
        if stale:
            _dead_socket(default)
        pid = None
        try:
            r = client(fixture_args("kmer"), tmp_path, "spawn", TMPDIR=d)
            c = profile_counters(r.stderr)
            assert c["pass1.using_server"] == 1 and c["pass1.device_scored_reads"] > 0, c
            h = hello(default)
            pid = h["pid"]
            assert h["platform"] == "cpu" and h["counters"]["dp.plain_calls"] > 0, h
            assert not os.path.exists(default + ".spawn")
        finally:
            if pid is not None:
                os.kill(pid, signal.SIGTERM)
                deadline = time.time() + 30
                while os.path.exists(default) and time.time() < deadline:
                    time.sleep(0.1)
        assert pid is not None and not os.path.exists(default)
    golden = os.path.join(GOLDEN, "kmer")
    assert malns(tmp_path) == {fn: _norm(os.path.join(golden, fn))
                               for fn in sorted(os.listdir(golden))}


# -------------------------------------------------------------- the protocol
def test_recv_refuses_bad_magic(server):
    a, b = socket.socketpair()
    with a, b:
        a.sendall(b"MIA1" + struct.pack("<Q", 3) + b"abc")
        with pytest.raises(ConnectionError, match="bad magic"):
            serve._recv(b)
    # the server drops such a peer and goes on answering others
    with socket.socket(socket.AF_UNIX) as s:
        s.connect(server)
        s.sendall(b"MIA1" + struct.pack("<Q", 3) + b"abc")
        s.settimeout(30)
        try:
            assert s.recv(1) == b""
        except ConnectionResetError:  # closed with our bytes unread
            pass
    assert hello(server)["platform"] == "cpu"


def test_recv_peer_closed_mid_message():
    a, b = socket.socketpair()
    with b:
        a.sendall(serve._MAGIC + struct.pack("<Q", 100) + b"x" * 10)
        a.close()
        with pytest.raises(ConnectionError, match="mid-message"):
            serve._recv(b)


def test_err_reply_raises_runtime_error(server):
    conn = serve._Client(server)
    try:
        with pytest.raises(RuntimeError, match="unknown op 'nope'"):
            conn.rpc({"op": "nope"})
        with pytest.raises(RuntimeError, match="KeyError"):
            conn.rpc({"op": "collect", "hid": 12345})
        # the connection goes on after an error
        assert conn.hello()["counters"].keys() == set(serve.COUNTERS)
    finally:
        conn.close()


def test_socket_is_private(server):
    mode = os.stat(server).st_mode
    assert stat.S_ISSOCK(mode) and stat.S_IMODE(mode) == 0o600
    h = hello(server)
    assert (h["platform"], h["devices"], h["device"], h["name"]) == ("cpu", 1, "cpu", "cpu")
    assert (h["build"], h["library"]) == (serve.build_id(), None)
