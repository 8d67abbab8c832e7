"""ma CLI of the port: maln inspector / format converter / consensus reporter
(src/map_assembler.c:84-220).

The JAX package's ``cli/ma.py`` without its one JAX line (the platform
override): ``ma`` does no device work.

    python -m mia_tpu_torch.cli.ma -M in.maln -f N [-c 1|2] [-R START:END] [-m out.maln]
"""
from __future__ import annotations

import sys

from ..core.columns import sort_aln_frags
from ..io.formats import ace_output, print_region, show_consensus
from ..io.ids import parse_ids
from ..io.maln import read_ma, write_ma


def help_text() -> str:
    return (
        "ma -M <maln input file>\n"
        "   -c <consensus code> \n"
        "   -f <output format>\n"
        "   -R <REGION_START:REGION_END>\n"
        "   -I <ID to assign to assembly sequence>\n"
        "ma reports information from a maln assembly file as generated by mia\n"
        "How the assembly calls each base can be determined by the\n"
        "consensus code. 1 = highest, positive aggregate score base (if any)\n"
        "                2 = highest aggregate score base if it is 2400 higher\n"
        "                    than second highest\n"
        "The output format can be specified through -f as one of the following.\n"
        "More complete descriptions of these output formats is below,\n"
        "under FORMATS\n"
        "1 => clustalw\n"
        "2 => line format; one line each for consensus, reference\n"
        "     and coverage\n"
        "3 => column format; one line per base, one column for consensus,\n"
        "     reference, and coverage; includes header with summary info\n"
        "4 => columns description of all assembly data for positions that differ\n"
        "     between consensus and CURRENT reference sequence (see FORMATS, below)\n"
        "41 => same as above, but for ALL positions\n"
        "5 => fasta format output of assembled sequence only\n"
        "6 => show all fragments in a region specified by -R\n"
        " -C Color format 6 output -> don't pipe this output to file!\n"
        "7 => ACE\n"
        "\n"
        "\n"
        "FORMATS (option f):\n"
        "1 => clustalw\n"
        "2 => line format; first line is \"Consensus, chrM, coverage:\"\n"
        "      second line is the entire, assembled, aligned consensus sequence\n"
        "      third line is the entire aligned reference sequence to which the\n"
        "      consensus is aligned\n"
        "      fourth line is the sequence coverage at each position in a space-\n"
        "      separated list of integers\n"
        "3 => column format; header shows summary statistics; table has one row\n"
        "      per position; columns are described in the output\n"
        "4 => alternative column format with one row per base that differes between\n"
        "      the consensus assembly and the reference of this iteration. \n"
        "      Note that in the FINAL iteration reference and consensus are equal! \n"
        "      So there won't be any output. Each row has the following\n"
        "      columns: (1)position on reference; 0-based coordinates, (2) reference\n"
        "      base, (3)consensus assembly base, (4)coverage, (5)A's, (6)C's, (7)G's,\n"
        "      (8)T's, (9)gaps; columns 5 through 9 should add up to column 4\n"
        "      (10) aggregate score for A, (11) aggregate score for C\n"
        "      (12) aggregate score for G, (13) aggregate score for T\n"
        "41=> same as above, but for every position\n"
        "5 => fasta format using ID \"Consensus\" for the assembly\n"
        "6 => region; shows the reference sequence, the consensus sequence, and then\n"
        "      all assembled fragments in a region specified by option -R\n"
        "61=> same as above, but in multi-fasta format for viewing in Bioedit, e.g.\n"
        "     (also requires a region as specified by the option -R\n"
        "7 => ACE format\n"
    )


def parse_region(s: str) -> tuple[int, int]:
    a, b = s.split(":")
    start, end = int(a), int(b)
    if start > end:
        # replicate the reference's buggy swap (src/map_assembler.c:73-82):
        # both values end up as the original end
        start = end
    return start, end


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ma_in_fn = None
    out_ma_fn = None
    out_format = 1
    cons_scheme = 1
    reg_start, reg_end = 90, 109
    in_color = False
    assign_id = None
    any_arg = False
    score_int = -1.0
    score_slo = -1.0

    i = 0
    while i < len(argv):
        arg = argv[i]
        flag = arg[1] if arg.startswith("-") and len(arg) > 1 else ""
        inline = arg[2:]

        def val():
            nonlocal i
            if inline:
                return inline
            i += 1
            return argv[i]

        if flag == "I":
            assign_id = val()
        elif flag == "i":
            # IDs-restriction list: the reference parses it (parse_ids,
            # src/map_assembler.c:127-130) but never consults the list
            # afterwards, so the only observable effects are the file read
            # and any_arg
            parse_ids(val())
            any_arg = True
        elif flag == "c":
            cons_scheme = int(val())
            any_arg = True
        elif flag == "f":
            out_format = int(val())
            any_arg = True
        elif flag == "R":
            reg_start, reg_end = parse_region(val())
            any_arg = True
        elif flag == "s":
            score_slo = float(val())
            any_arg = True
        elif flag == "b":
            score_int = float(val())
            any_arg = True
        elif flag == "C":
            in_color = True
        elif flag == "m":
            out_ma_fn = val()
            any_arg = True
        elif flag == "M":
            ma_in_fn = val()
            any_arg = True
        elif flag == "d":
            any_arg = True
        else:
            sys.stdout.write(help_text())
            return 0
        i += 1

    if (
        not any_arg
        or (score_slo == -1 and score_int != -1)
        or (score_slo != -1 and score_int == -1)
    ):
        sys.stdout.write(help_text())
        return 0
    if ma_in_fn is None:
        sys.stdout.write(help_text())
        return 0

    maln = read_ma(ma_in_fn)
    maln.cons_code = cons_scheme
    sort_aln_frags(maln)
    if assign_id is not None:
        maln.ref.id = assign_id

    if out_format in (6, 61):
        print_region(maln, reg_start, reg_end, out_format, in_color)
    else:
        show_consensus(maln, out_format)
    if out_format == 7:
        ace_output(maln)
    if out_ma_fn:
        write_ma(out_ma_fn, maln)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
