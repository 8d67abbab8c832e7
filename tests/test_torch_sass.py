"""utils/sass.py on a kept disassembly: a kernel's own loops and those of a
device function it calls out of line are told apart (no toolkit needed)."""
from mia_tpu_torch.utils import sass

LISTING = """
        Function : _Z4kernv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0020*/                   CALL.REL.NOINC 0x0080 ;
        /*0030*/                   ISETP.GE.AND P0, PT, R2, 0x10, PT ;
        /*0040*/               @!P0 BRA 0x0010 ;
        /*0050*/                   BRA 0x0030 ;
        /*0060*/                   EXIT ;
        /*0070*/                   NOP ;
        /*0080*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0090*/                   VIADDMNMX R3, R3, R0, R4, !PT ;
        /*00a0*/                   ISETP.GE.AND P1, PT, R0, 0x20, PT ;
        /*00b0*/               @!P1 BRA 0x0080 ;
        /*00c0*/                   RET.REL.NODEC R20 0x0 ;
"""


def _instrs():
    ks = sass.kernels(LISTING)
    assert list(ks) == ["_Z4kernv"]
    return [(a, t) for a, t in ks["_Z4kernv"] if sass.opcode(t) != "NOP"]


def test_loops_and_out_of_line_bodies():
    real = _instrs()
    assert sass.opcode("@!P0 BRA 0x0010") == "BRA"
    # the unconditional branch back is no loop
    assert sass.loops(real) == [(0x10, 0x40, 4), (0x80, 0xB0, 4)]
    parts = sass.bodies(real)
    assert parts == [("kernel", 0x0, 0x80), ("callee at 0x0080", 0x80, 0xC1)]
    kernel = [(a, t) for a, t in real if a < 0x80]
    assert sass.loops(kernel) == [(0x10, 0x40, 4)]


def test_report_lists_each_body(tmp_path, capsys):
    kept = tmp_path / "k.cu.sass"
    kept.write_text(LISTING)
    sass.report(str(kept), None)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "k.cu.sass _Z4kernv: 12 instructions"
    assert out[1:] == [
        "  kernel: 7 instructions",
        "  loop 0x0010..0x0040: 4 instructions",
        "    IADD3 1, CALL 1, ISETP 1, BRA 1",
        "  callee at 0x0080: 5 instructions",
        "  loop 0x0080..0x00b0: 4 instructions",
        "    IADD3 1, VIADDMNMX 1, ISETP 1, BRA 1",
    ]
