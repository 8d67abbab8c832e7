"""Golden-output tests of the PyTorch port: ``mia_tpu_torch``'s mia under
``--engine torch`` must write the committed golden maln files byte for byte
(modulo the timestamp header line), with jax unimportable in the process.

On the CPU the scorer and the consensus counts run their plain PyTorch
versions (MIA_TORCH_DEVICE=cpu); the profile counters prove the device
scorer (the ``-h`` one under ``-h``) and the device consensus, not a host
engine, did the work.
"""
import json
import os
import subprocess
import sys

import pytest

from .conftest import FIXTURES, GOLDEN
from .test_golden_mia import CONFIGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_CONFIGS = sorted(CONFIGS)

# run the port's CLI with jax blocked: the port must not need it
NO_JAX_MAIN = (
    "import sys; sys.modules['jax'] = None; "
    "from mia_tpu_torch.cli.mia import main; sys.exit(main(sys.argv[1:]))"
)


def run_torch_mia(args, workdir, extra_env=None, check=True, engine="torch"):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["MIA_TORCH_DEVICE"] = "cpu"
    env["MIA_SCORE_BATCH"] = "64"
    env["OMP_NUM_THREADS"] = "1"
    # never a developer's resident server (tests/test_torch_serve.py names its own)
    env["MIA_TORCH_SERVER"] = "0"
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "-c", NO_JAX_MAIN, *args, "-m", "out.maln",
         "--engine", engine, "--profile"],
        cwd=workdir, env=env, check=check, capture_output=True, timeout=600,
    )


def profile_counters(stderr: bytes) -> dict:
    line = [
        ln for ln in stderr.decode().splitlines() if ln.startswith("MIA_PROFILE")
    ][-1]
    return json.loads(line.split("MIA_PROFILE ", 1)[1])["counters"]


def fixture_args(name):
    return [
        os.path.join(FIXTURES, a)
        if (a.endswith((".fna", ".fastq")) or a == "ids.txt")
        else a
        for a in CONFIGS[name]
    ]


def _norm(path):
    with open(path, "rb") as fh:
        return b"\n".join(fh.read().split(b"\n")[1:])


def test_torch_configs_cover_all():
    assert len(TORCH_CONFIGS) == 15
    assert sorted(os.listdir(GOLDEN)) == sorted(TORCH_CONFIGS + ["ccheck"])


@pytest.mark.parametrize("name", TORCH_CONFIGS)
def test_torch_maln_byte_identical(name, tmp_path):
    golden = os.path.join(GOLDEN, name)
    r = run_torch_mia(fixture_args(name), tmp_path)
    produced = sorted(p for p in os.listdir(tmp_path) if p.startswith("out.maln."))
    expected = sorted(os.listdir(golden))
    assert produced == expected, f"iteration files differ: {produced} vs {expected}"
    for fn in expected:
        assert _norm(tmp_path / fn) == _norm(os.path.join(golden, fn)), (
            f"{name}/{fn} differs from reference output"
        )
    c = profile_counters(r.stderr)
    # the device scorer scored realignment entries on every config, the -h
    # scorer under -h and the plain one otherwise, and each ran as its plain
    # version (CPU tensors), never as a kernel here; so did every consensus
    hp = "-h" in CONFIGS[name]
    assert c["reiterate.device_entries"] > 0, c
    assert c["dp.hp_plain_calls" if hp else "dp.plain_calls"] > 0, c
    assert c["dp.plain_calls" if hp else "dp.hp_plain_calls"] == 0, c
    assert c["dp.kernel_launches"] == c["dp.hp_kernel_launches"] == 0, c
    if "-k" in CONFIGS[name]:
        assert c["pass1.device_scored_reads"] > 0, c
    # pass 1's WIDE reads (every read without -k): scored full width by the
    # general-width scorer's band, strand and full forms, under -h by its -h forms
    # (each its plain version here), none by the native solve
    assert c.get("pass1.native_solved_wide_reads", 0) == 0, c
    wide = c["pass1.device_scored_wide_reads"]
    assert wide > 0 or "-k" in CONFIGS[name], c
    hp_plain = (c["dp.last_row_hp_plain_calls"] + c["dp.last_row_hp_band_plain_calls"]
                + c["dp.last_row_hp_strand_plain_calls"])
    no_hp_plain = (c["dp.last_row_plain_calls"] + c["dp.last_row_band_plain_calls"]
                   + c["dp.last_row_strand_plain_calls"])
    plain, other = (hp_plain, no_hp_plain)[:: 1 if hp else -1]
    assert (plain > 0) == (wide > 0), c
    assert other == 0, c
    assert c["dp.last_row_launches"] == c["dp.last_row_hp_launches"] == 0, c
    assert c["dp.last_row_band_launches"] == c["dp.last_row_hp_band_launches"] == 0, c
    assert c["dp.last_row_strand_launches"] == c["dp.last_row_hp_strand_launches"] == 0, c
    assert c["cons.plain_calls"] > 0 and c["cons.kernel_launches"] == 0, c
    assert c["consensus.device_calls"] == c["cons.plain_calls"], c
    assert "consensus.device_fallbacks" not in c, c


def test_torch_engine_runs_dp_devices(tmp_path):
    """``--dp-devices`` is no longer refused.  With fewer than two cards the
    command line gives the single-device path, as in the JAX package (the
    sharded path with an explicit device list: tests/test_torch_parallel.py)."""
    r = run_torch_mia([*fixture_args("kmer"), "--dp-devices", "4"], tmp_path)
    golden = os.path.join(GOLDEN, "kmer")
    for fn in sorted(os.listdir(golden)):
        assert _norm(tmp_path / fn) == _norm(os.path.join(golden, fn)), fn
    c = profile_counters(r.stderr)
    assert c["dp.shards"] == 1 and c["dp.plain_calls"] > 0, c


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_port_cli_hands_host_engines_to_mia_tpu(engine, tmp_path):
    """The host engines run from the port's own copy of the host pipeline,
    with jax blocked: same golden bytes, and the port's scorer is never
    called."""
    r = run_torch_mia(fixture_args("kmer"), tmp_path, engine=engine)
    golden = os.path.join(GOLDEN, "kmer")
    for fn in sorted(os.listdir(golden)):
        assert _norm(tmp_path / fn) == _norm(os.path.join(golden, fn)), fn
    c = profile_counters(r.stderr)
    assert c["dp.kernel_launches"] == 0 and c["dp.plain_calls"] == 0, c
    assert c["cons.kernel_launches"] == 0 and c["cons.plain_calls"] == 0, c
    assert "reiterate.device_entries" not in c, c


@pytest.mark.parametrize("engine,variable", [
    ("torch", "JAX_COORDINATOR_ADDRESS"), ("native", "JAX_COORDINATOR_ADDRESS"),
    ("torch", "MIA_TORCH_COORDINATOR_ADDRESS"),
], ids=["torch", "native", "torch-port_variable"])
def test_port_refuses_multi_host(engine, variable, tmp_path):
    """The JAX package's multi-host variable is refused under every engine,
    with the port's three variables named in its place; the port's own
    variable starts a group, here of one rank, which writes the golden."""
    if variable == "MIA_TORCH_COORDINATOR_ADDRESS":
        from .test_torch_distributed import free_port

        r = run_torch_mia(fixture_args("kmer"), tmp_path, engine=engine, extra_env={
            variable: f"127.0.0.1:{free_port()}", "MIA_TORCH_NUM_PROCESSES": "1",
            "MIA_TORCH_PROCESS_ID": "0"})
        golden = os.path.join(GOLDEN, "kmer")
        for fn in sorted(os.listdir(golden)):
            assert _norm(tmp_path / fn) == _norm(os.path.join(golden, fn)), fn
        c = profile_counters(r.stderr)
        assert c["dp.plain_calls"] > 0 and c["pass1.device_scored_reads"] > 0, c
        return
    r = run_torch_mia(fixture_args("kmer"), tmp_path, check=False, engine=engine,
                      extra_env={variable: "localhost:1"})
    assert r.returncode != 0
    assert variable.encode() in r.stderr
    for port_variable in (b"MIA_TORCH_COORDINATOR_ADDRESS", b"MIA_TORCH_NUM_PROCESSES",
                          b"MIA_TORCH_PROCESS_ID"):
        assert port_variable in r.stderr
    assert not any(p.startswith("out.maln.") for p in os.listdir(tmp_path))
