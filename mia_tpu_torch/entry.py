"""Entry points of the port: a single-device forward step and a
multi-device dry run (the counterparts of the JAX package's
``__graft_entry__.py``).

    python -c "from mia_tpu_torch.entry import dryrun_multichip; dryrun_multichip(4)"

Both run on ``torchcfg.select_device()``: the card, or the CPU when
``MIA_TORCH_DEVICE=cpu`` asks for it.  With fewer cards than shards the dry
run names its device several times, so the splitting, the order of the
results and the sums are exercised on one card (or on the CPU) as they
would be on several.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def entry():
    """(fn, example_args): the forward step of the flagship kernel, the
    batched semi-global DP scorer over a read batch against a reference
    row shared by the batch, returning per-read (best score, end column)."""
    from .ops.dp_cuda import dp_last_row
    from .ops.dp_torch import batch_best_and_aec, depths_for
    from .ops.pssm import init_flatsubmat
    from .utils.encoding import encode_seq
    from .utils.torchcfg import select_device

    dev = select_device()
    rng = np.random.default_rng(0)
    B, W, L = 8, 1024, 64
    ref = "".join(rng.choice(list("ACGT")) for _ in range(W))
    lengths = torch.from_numpy(rng.integers(16, L, B).astype(np.int32))
    s2c = rng.integers(0, 4, (B, L)).astype(np.int32)
    s1c = encode_seq(ref).astype(np.int32)
    depths = depths_for(lengths, L).to(torch.int32)
    sm = init_flatsubmat().astype(np.int32)
    mask = np.ones((B, W), dtype=bool)

    def fn(s1c, mask, s2c, lengths, depths, sm):
        last = dp_last_row(s1c, mask, s2c, lengths, depths, sm, sg5=True)
        return batch_best_and_aec(last)

    args = tuple(
        (a if isinstance(a, torch.Tensor) else torch.from_numpy(a)).to(dev)
        for a in (s1c, mask, s2c, lengths, depths, sm)
    )
    return fn, args


def _dryrun_devices(n_devices: int) -> list[torch.device]:
    """``n_devices`` devices for a dry run: the cards there are, the first
    again where there are fewer (the CPU under MIA_TORCH_DEVICE=cpu)."""
    from .utils.torchcfg import select_device

    first = select_device()
    if first.type != "cuda":
        return [first] * n_devices
    have = torch.cuda.device_count()
    return [torch.device("cuda", i if i < have else 0) for i in range(n_devices)]


def dryrun_multichip(n_devices: int) -> None:
    """Run the multi-device path end to end: a full iterative assembly
    (``--engine torch``) of the repository's test fixtures with its scoring
    entries and consensus records dealt over ``n_devices`` shards,
    byte-compared against the single-device assembly; then one sharded
    assembly step (scoring, pileup, sum over dp, consensus on sp blocks)
    against a single-device step.  Raises on any difference."""
    from .config import MiaConfig
    from .core import assembler
    from .ops import dp_cuda
    from .ops.dp_torch import depths_for
    from .ops.pssm import init_flatsubmat, revcom_submat
    from .parallel.sharded import make_assembly_step, make_mesh
    from .utils.encoding import encode_seq

    devices = _dryrun_devices(n_devices)
    # small batches: several dispatches per pass, each dealt over the shards
    # (the caller's own setting wins, and is left as it was)
    batch_was = os.environ.get("MIA_SCORE_BATCH")
    os.environ.setdefault("MIA_SCORE_BATCH", "64")

    # --- the assembly, entries and consensus records sharded ---------------
    fixtures = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "fixtures")
    outputs = {}
    orig = assembler.make_dp_devices
    try:
        for tag, dp in (("single", 0), ("sharded", n_devices)):
            with tempfile.TemporaryDirectory() as td:
                cfg = MiaConfig(
                    ref_fn=os.path.join(fixtures, "tr1.fna"),
                    frag_fn=os.path.join(fixtures, "tf.fna"),
                    maln_root=os.path.join(td, "out.maln"),
                    circular=True,
                    kmer_filt_len=12,
                    engine="torch",
                    dp_devices=dp,
                )
                # the command line would give at most the cards there are
                assembler.make_dp_devices = lambda n: orig(n, devices=devices) if n else None
                dp_cuda.shards = 0
                try:
                    assembler.run_assembly(cfg)
                finally:
                    assembler.make_dp_devices = orig
                if dp_cuda.shards != (n_devices if dp and n_devices > 1 else 1):
                    raise AssertionError(f"{tag}: scorer dealt over {dp_cuda.shards} shards")
                files = {}
                for fn in sorted(os.listdir(td)):
                    with open(os.path.join(td, fn), "rb") as fh:
                        files[fn] = b"\n".join(fh.read().split(b"\n")[1:])
                outputs[tag] = files
    finally:
        if batch_was is None:
            del os.environ["MIA_SCORE_BATCH"]
    if not outputs["single"] or outputs["single"] != outputs["sharded"]:
        raise AssertionError("sharded assembly output differs from single-device output")

    # --- the assembly step over (dp, sp) ------------------------------------
    n_sp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(n_dp=n_devices // n_sp, n_sp=n_sp, devices=devices)

    rng = np.random.default_rng(1)
    B = 4 * (n_devices // n_sp)
    W, L = 256, 16
    ref = "".join(rng.choice(list("ACGT")) for _ in range(W))
    lengths = rng.integers(6, L, B).astype(np.int32)
    s2c = np.full((B, L), 4, np.int32)
    for b in range(B):
        n = int(lengths[b])
        s = int(rng.integers(0, W - n))
        s2c[b, :n] = encode_seq(ref[s : s + n])
    s1c = encode_seq(ref).astype(np.int32)
    depths = depths_for(torch.from_numpy(lengths), L).numpy().astype(np.int32)
    fpsm = init_flatsubmat().astype(np.int32)
    rpsm = revcom_submat(fpsm).astype(np.int32)
    mask = np.ones((B, W), dtype=bool)

    args = (s1c, mask, s2c, lengths, depths, fpsm, rpsm)
    got = make_assembly_step(mesh)(*args)
    want = make_assembly_step(make_mesh(1, 1, devices=devices[:1]))(*args)
    for name, g, w in zip(("best", "aec", "cons"), got, want):
        if not torch.equal(g.cpu(), w.cpu()):
            raise AssertionError(f"sharded assembly step differs from one device: {name}")
