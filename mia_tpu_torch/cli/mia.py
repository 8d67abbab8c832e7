"""mia CLI of the port: iterative assembler entry point
(src/mia_main.c:394-989).

Same flag surface as ``mia_tpu``'s ``mia`` (its ``parse_args`` and
``help_text`` are reused), with ``--engine torch`` as the default: read
batches and realignment windows are scored on the card by the port's
kernel.  ``--engine native`` and ``--engine numpy`` hand the run to
``mia_tpu``'s own ``run_assembly``, whose host engines import no jax;
``--engine jax`` belongs to ``mia_tpu`` and is refused here.

    python -m mia_tpu_torch.cli.mia -r ref.fna -f reads.fastq [flags] [--profile]

Under ``--profile`` the JSON profile on stderr carries the kernels' counters
beside the pipeline's own: ``dp.kernel_launches`` / ``dp.plain_calls`` (the
scorer), ``dp.hp_kernel_launches`` / ``dp.hp_plain_calls`` (the ``-h``
scorer) and ``cons.kernel_launches`` / ``cons.plain_calls`` (consensus
column counts).
"""
from __future__ import annotations

import sys
import time

from mia_tpu.cli.mia import parse_args
from mia_tpu.core.assembler import run_assembly as run_host_assembly
from mia_tpu.utils import profiling

from ..core.assembler import NotPortedError, check_ported, run_assembly
from ..ops import consensus_torch, dp_cuda

ENGINES = ("torch", "native", "numpy")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cfg = parse_args(argv)
    if "--engine" not in argv:
        cfg.engine = "torch"
    if cfg.engine not in ENGINES:
        print(
            f"mia: --engine {cfg.engine} is not an engine of this port "
            f"(choose from {', '.join(ENGINES)})",
            file=sys.stderr,
        )
        return 2
    if cfg.profile:
        profiling.enable()
    dp_cuda.reset_counts()
    consensus_torch.reset_counts()
    print(
        f"Starting assembly of {cfg.frag_fn}\nusing {cfg.ref_fn}\n"
        f"as reference at {time.asctime()}\n",
        file=sys.stderr,
    )
    try:
        check_ported(cfg)
        (run_assembly if cfg.engine == "torch" else run_host_assembly)(cfg)
    except NotPortedError as e:
        print(f"mia: {e}", file=sys.stderr)
        return 2
    if cfg.profile:
        for name, value in (
            ("dp.kernel_launches", dp_cuda.kernel_launches),
            ("dp.plain_calls", dp_cuda.plain_calls),
            ("dp.hp_kernel_launches", dp_cuda.hp_kernel_launches),
            ("dp.hp_plain_calls", dp_cuda.hp_plain_calls),
            ("cons.kernel_launches", consensus_torch.kernel_launches),
            ("cons.plain_calls", consensus_torch.plain_calls),
        ):
            profiling.count(name, value)
        profiling.report()
    print(f"Assembly finished at {time.asctime()}\n", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
