"""mia CLI of the port: iterative assembler entry point
(src/mia_main.c:394-989).

Same flag surface as the reference binary, including the no-space -C<tol>
optional-argument quirk, plus ``--engine``, ``--dp-devices`` (``--dp``) and
``--profile``.  ``--engine torch`` is the default: read batches and
realignment windows are scored on the card by the port's kernels, over
``--dp-devices N`` cards when N > 1 (``-1`` = all).  ``--engine native`` (the
threaded native batch engine) and ``--engine numpy`` (the exact per-read
path) run on the host; ``--engine jax`` belongs to the JAX package and is
refused here.

    python -m mia_tpu_torch.cli.mia -r ref.fna -f reads.fastq [flags] [--profile]

``MIA_TORCH_SERVER`` says whether ``--engine torch`` scores through the
resident scoring server (``python -m mia_tpu_torch.cli.serve``; see
:mod:`mia_tpu_torch.serve`): unset or ``auto``, the server on the default
socket when one answers, else this process's card; ``spawn``, start one
there when none answers and wait for it; a path, the server on that socket;
``0``, never.  A named server that does not answer, or that fails, ends
the run with a non-zero exit.  Through a server, and under ``--engine
native`` or ``numpy``, a single-process run imports no torch.

Under ``--profile`` the JSON profile on stderr carries the kernels' counters
beside the pipeline's own: ``dp.kernel_launches`` / ``dp.plain_calls`` (the
scorer), ``dp.hp_kernel_launches`` / ``dp.hp_plain_calls`` (the ``-h``
scorer), ``dp.last_row_launches`` / ``dp.last_row_plain_calls`` and
``dp.last_row_band_launches`` / ``dp.last_row_band_plain_calls`` and
``dp.last_row_strand_launches`` / ``dp.last_row_strand_plain_calls`` (the
general-width scorer's full, band and strand forms, which take pass 1's
WIDE reads; ``dp.last_row_rows`` / ``dp.last_row_band_rows`` /
``dp.last_row_strand_rows`` the rows of each,
``dp.last_row_band_multi_rows`` the band rows on more than one warp) and
``dp.last_row_hp_launches`` / ``dp.last_row_hp_plain_calls``,
``dp.last_row_hp_band_launches`` / ``dp.last_row_hp_band_plain_calls`` and
``dp.last_row_hp_strand_launches`` / ``dp.last_row_hp_strand_plain_calls``
(its ``-h`` full, band and strand forms, which take them under ``-h``;
``dp.last_row_hp_rows`` / ``dp.last_row_hp_band_rows`` /
``dp.last_row_hp_strand_rows`` the rows of each,
``dp.last_row_hp_band_multi_rows`` as above),
``dp.shards`` (device shards a dispatch was dealt over) and
``cons.kernel_launches`` / ``cons.plain_calls`` (consensus column counts),
each 0 where this process never loaded the kernel's module (a run through
the server: the server's ``hello`` has its counts), and
``pass1.using_server`` or ``pass1.in_process``.
With MIA_TORCH_TRACE_DIR set the run is traced by ``torch.profiler``.
"""
from __future__ import annotations

import sys
import time

from ..config import MiaConfig
from ..constants import NEANDERTAL_ADAPTER, STANDARD_ADAPTER
from ..core.assembler import NotPortedError, run_assembly
from ..serve import ServerUnavailable
from ..utils import profiling

ENGINES = ("torch", "native", "numpy")
# the kernels' counters, by the module that keeps them
KERNEL_COUNTERS = (
    ("dp", "mia_tpu_torch.ops.dp_cuda",
     ("kernel_launches", "plain_calls", "hp_kernel_launches", "hp_plain_calls",
      "last_row_launches", "last_row_plain_calls", "last_row_band_launches",
      "last_row_band_plain_calls", "last_row_rows", "last_row_band_rows",
      "last_row_band_multi_rows", "last_row_strand_launches", "last_row_strand_plain_calls",
      "last_row_strand_rows", "last_row_hp_launches", "last_row_hp_plain_calls", "last_row_hp_band_launches",
      "last_row_hp_band_plain_calls", "last_row_hp_rows", "last_row_hp_band_rows",
      "last_row_hp_band_multi_rows", "last_row_hp_strand_launches",
      "last_row_hp_strand_plain_calls", "last_row_hp_strand_rows", "shards")),
    ("cons", "mia_tpu_torch.ops.consensus_torch", ("kernel_launches", "plain_calls")),
)


def _kernel_modules():
    """The counters' modules that this process has loaded (the others
    counted nothing)."""
    for prefix, name, counters in KERNEL_COUNTERS:
        yield prefix, sys.modules.get(name), counters


def help_text() -> str:
    return (
        "\n"
        "\n"
        "MIA -- Mapping Iterativ Assembler V 1.0\n"
        "       A tool for creating short read assemblies.\n"
        "\n"
        "Copyright Richard E. Green, Michael Siebauer 2008-2009\n"
        "Report bugs to <green@eva.mpg.de>.\n"
        "===============================+++++++++++++==\n"
        "\n"
        "Usage:\n"
        "mia -r <reference sequence>\n"
        "    -f <fasta or fastq file of fragments to align>\n"
        "    -s <substitution matrix file> (if not supplied an default matrix is used)\n"
        "    -m <root file name for maln output file(s)> (assembly.maln.iter)\n"
        "    \n"
        "FILTER parameters:\n"
        "    -u fasta database has repeat sequences, keep one based on alignment score\n"
        "    -U fasta database has repeat sequences, keep one based on sum of q-scores\n"
        "    -C<tolerance> collapse sequences with same start, end, strand info into a single sequence\n"
        "       Allow <tolerance> bases difference for start and end coordinates\n"
        "       Important: keep NO SPACE between parameter and value: e.g. -C3\n"
        "    -A use adapter presence and coordinate information to more aggressively\n"
        "       remove repeat sequences - suitable only for 454 sequences that have not\n"
        "       already been adapter trimmed\n"
        "    -T fasta database has adapters, trim these\n"
        "    -a <adapter sequence or code>\n"
        "    -k <use kmer filter with kmers of this length>\n"
        "    -I <filename of list of sequence IDs to use, ignoring all others>\n"
        "    \n"
        "ALIGNMENT parameters:\n"
        "    -p <consensus calling code; default = 1>\n"
        "    -c means reference/assembly is circular\n"
        "    -i iterate assembly until convergence (default)\n"
        "    -n do not iterate assembly until convergence\n"
        "    -F <only output the FINAL assembly, not each iteration>\n"
        "    -D <distantly related reference sequence>\n"
        "    -h give special discount for homopolymer gaps\n"
        "    -M <use lower-case soft-masking of kmers>\n"
        "    -H <do not do dynamic score cutoff, instead use this Hard score cutoff>\n"
        "    -S <slope of length/score cutoff line>\n"
        "    -N <intercept of length/score cutoff line>\n"
        "The default substitution matrix used the following parameters:\n"
        "  MATCH=200, MISMATCH=-600, N=-100 for all positions\n"
        "The procedure for removing bad-scoring alignments from the assembly is:\n"
        "Default: fit a line to length versus score and remove reads that are\n"
        "less that SCORE_CUTOFF_BUFFER than the average score for its length.\n"
        "If -H is specified then this hard score cutoff is applied to all reads.\n"
        "This is preferable if all reads are the same length.\n"
        "If -S or -N are specified, then these are used as the slope and intercept\n"
        "of a length/score line. Reads must score above this line to be included.\n"
        "If only one of -S or -N is specified then the default values are used for\n"
        "the other (default S = 200.0; default N = 0.0)\n"
        "The kmer filter requires that a sequence fragment have at least one\n"
        "kmer of the specified length in common with the reference sequence in\n"
        "order to align it. For 36nt Solexa data, a value of 12 works well.\n"
        "The -p option specifies how the new consensus assembly sequence is called\n"
        "at each iteration:\n"
        "1 => Any base whose aggregate score is MIN_SC_DIFF_CONS better than all\n"
        "      others is the assembly base. If none is, then N is the assembly base.\n"
        "2 => The best scoring base whose aggregate score is better than MIN_SCORE_CONS\n"
        "     is the assembly base. If none is, then N is the assembly base.\n"
        "If -T is specified, mia will attempt to find and trim adapters on\n"
        "each sequence. The adapter sequence itself can be specified by a\n"
        "one letter code as argument to -a. N or n => Neandertal adapter\n"
        "                  any other single letter => Standard GS FLX adapter\n"
        "              sequence (less than 127 nt) => user-specified adapter\n"
    )

def _atoi(s: str) -> int:
    """C atoi: optional sign + leading digits, else 0."""
    s = s.lstrip()
    m = __import__("re").match(r"[+-]?\d+", s)
    return int(m.group(0)) if m else 0


def parse_args(argv: list[str]) -> MiaConfig | None:
    cfg = MiaConfig()
    any_arg = False
    i = 0

    def need_val() -> str:
        nonlocal i
        i += 1
        if i >= len(argv):
            sys.stdout.write(help_text()); raise SystemExit(0)
        return argv[i]

    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("-") or arg == "-":
            print(
                "There seems to be some extra cruff on the command line that mia does not understand.",
                file=sys.stderr,
            )
            raise SystemExit(0)
        flag = arg[1]
        inline = arg[2:]
        if flag == "c":
            cfg.circular = True
        elif flag == "q":
            cfg.make_fastq = True
            cfg.fastq_out_fn = inline or need_val()
            # reference falls through 'q' into 'C' (missing break,
            # src/mia_main.c:482-490): -q also enables collapsing, with
            # tolerance = atoi(filename) (usually 0)
            cfg.collapse = True
            cfg.tolerance = _atoi(cfg.fastq_out_fn)
            print(f"setting collapsing tolerance to {cfg.tolerance}", file=sys.stderr)
        elif flag == "C":
            cfg.collapse = True
            if inline:
                cfg.tolerance = int(inline)
            print(f"setting collapsing tolerance to {cfg.tolerance}", file=sys.stderr)
        elif flag == "n":
            cfg.iterate = False
        elif flag == "i":
            cfg.iterate = True
        elif flag == "h":
            cfg.hp_special = True
        elif flag == "u":
            cfg.repeat_filt = True
        elif flag == "A":
            cfg.just_outer_coords = False
        elif flag == "U":
            cfg.repeat_qual_filt = True
        elif flag == "D":
            cfg.distant_ref = True
        elif flag == "p":
            cfg.cons_code = int(inline or need_val())
            any_arg = True
        elif flag == "I":
            cfg.ids_file = inline or need_val()
        elif flag == "H":
            cfg.hard_cut = int(inline or need_val())
            if cfg.hard_cut <= 0:
                print("Hard cutoff (-H) must be positive", file=sys.stderr)
                sys.stdout.write(help_text())
                raise SystemExit(0)
            any_arg = True
        elif flag == "M":
            cfg.soft_mask = True
        elif flag == "s":
            cfg.submat_fn = inline or need_val()
            any_arg = True
        elif flag == "r":
            cfg.ref_fn = inline or need_val()
            any_arg = True
        elif flag == "k":
            cfg.kmer_filt_len = int(inline or need_val())
            any_arg = True
        elif flag == "f":
            cfg.frag_fn = inline or need_val()
            any_arg = True
        elif flag == "m":
            cfg.maln_root = inline or need_val()
            any_arg = True
        elif flag == "T":
            cfg.do_adapter_trimming = True
        elif flag == "a":
            val = inline or need_val()
            if len(val) > 127:
                print(
                    "That adapter is too big!\nMIA will use the standard adapter.",
                    file=sys.stderr,
                )
                cfg.adapter = STANDARD_ADAPTER
            elif len(val) > 1:
                cfg.adapter = val
            elif val and val[0] in "nN":
                cfg.adapter = NEANDERTAL_ADAPTER
            else:
                cfg.adapter = STANDARD_ADAPTER
        elif flag == "S":
            cfg.slope = float(inline or need_val())
            cfg.score_cut_set = True
        elif flag == "N":
            cfg.intercept = float(inline or need_val())
            cfg.score_cut_set = True
        elif flag == "F":
            cfg.final_only = True
        elif flag == "-" and arg == "--engine":
            cfg.engine = need_val()
        elif flag == "-" and arg in ("--dp", "--dp-devices"):
            cfg.dp_devices = int(need_val())
        elif flag == "-" and arg == "--profile":
            cfg.profile = True
        else:
            sys.stdout.write(help_text())
            raise SystemExit(0)
        i += 1

    if not any_arg:
        sys.stdout.write(help_text())
        raise SystemExit(0)
    return cfg


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
    for _, module, _ in _kernel_modules():
        if module is not None:
            module.reset_counts()
    print(
        f"Starting assembly of {cfg.frag_fn}\nusing {cfg.ref_fn}\n"
        f"as reference at {time.asctime()}\n",
        file=sys.stderr,
    )
    try:
        with profiling.device_trace():
            run_assembly(cfg)
    except NotPortedError as e:
        print(f"mia: {e}", file=sys.stderr)
        return 2
    except ServerUnavailable as e:
        print(f"mia: {e}", file=sys.stderr)
        return 1
    if cfg.profile:
        for prefix, module, counters in _kernel_modules():
            for name in counters:
                profiling.count(f"{prefix}.{name}", getattr(module, name, 0))
        profiling.report()
    print(f"Assembly finished at {time.asctime()}\n", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
