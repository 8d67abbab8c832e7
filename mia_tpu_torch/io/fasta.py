"""FASTA/FASTQ streaming readers with reference-identical truncation rules.

Behavioural contract (all quirks preserved, cf. src/io.c):

* ``find_input_type`` sniffs the first byte: '@' -> fastq else fasta
  (src/io.c:11-25).
* Read IDs are truncated at 100 chars, descriptions at 128
  (src/io.c:206-239).
* Read sequences are uppercased and hard-truncated at 256 bp with the rest of
  the record skipped (src/io.c:241-278); fastq quality strings likewise
  (src/io.c:133-159).
* ``qual_sum`` is the sum of (ascii-33) over the quality string
  (src/io.c:175-185).
* The reference FASTA reader keeps case (soft-masking!) and has no length cap
  (src/io.c:288-386); its reverse complement is built eagerly.

These are small state machines over a byte buffer; the heavy lifting
downstream is all array code.
"""
from __future__ import annotations

import io as _io
from dataclasses import dataclass, field

from ..constants import INIT_ALN_SEQ_LEN, MAX_DESC_LEN, MAX_ID_LEN
from ..utils.encoding import revcom
from ..core.types import FragSeq, RefSeq


def find_input_type(data: bytes) -> int:
    """0 => fasta, 1 => fastq (src/io.c:11-25)."""
    return 1 if data[:1] == b"@" else 0


class _ByteStream:
    """Minimal fgetc/ungetc shim over a bytes buffer."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def getc(self) -> int:
        if self.pos >= len(self.data):
            return -1
        c = self.data[self.pos]
        self.pos += 1
        return c

    def ungetc(self) -> None:
        if self.pos > 0:
            self.pos -= 1


def _isspace(c: int) -> bool:
    return c in (0x20, 0x09, 0x0A, 0x0B, 0x0C, 0x0D)


def read_fasta(fs: _ByteStream) -> FragSeq | None:
    """One fasta record -> FragSeq, or None at EOF (src/io.c:194-281)."""
    c = fs.getc()
    if c == -1 or c != ord(">"):
        return None
    frag = FragSeq()
    frag.qual = ""

    # id (truncated at MAX_ID_LEN)
    chars = []
    i = 0
    while True:
        c = fs.getc()
        if c == -1:
            return None
        if _isspace(c):
            break
        if i >= MAX_ID_LEN:
            break
        chars.append(c)
        i += 1
    frag.id = bytes(chars).decode("latin-1")

    # description: everything else on the header line
    if c == ord("\n"):
        frag.desc = ""
    else:
        while c != ord("\n") and _isspace(c):
            c = fs.getc()
        # reference quirk: it ungetc()s the first non-space char and then also
        # appends the stale variable, duplicating it (src/io.c:230-238)
        dchars = []
        i = 0
        fs.ungetc()
        while c != ord("\n") and c != -1 and i < MAX_DESC_LEN:
            dchars.append(c)
            i += 1
            c = fs.getc()
        frag.desc = bytes(dchars).decode("latin-1")

    # sequence: until '>' or EOF, truncated at INIT_ALN_SEQ_LEN
    schars = []
    i = 0
    c = fs.getc()
    while c != ord(">") and c != -1 and i < INIT_ALN_SEQ_LEN:
        if not _isspace(c):
            schars.append(c)
            i += 1
        c = fs.getc()
    seq = bytes(schars).decode("latin-1").upper()
    frag.seq = seq
    frag.seq_len = i

    if c == ord(">"):
        fs.ungetc()
        return frag

    if i == INIT_ALN_SEQ_LEN:
        # wind through the rest of this record (src/io.c:267-278)
        while c != ord(">") and c != -1:
            c = fs.getc()
        if c == ord(">"):
            fs.ungetc()
        import sys

        print(f"{frag.id} is longer than allowed length: {INIT_ALN_SEQ_LEN}", file=sys.stderr)
    return frag


def calc_qual_sum(qual: str) -> int:
    return sum(ord(q) - 33 for q in qual)


def read_fastq(fs: _ByteStream) -> FragSeq | None:
    """One fastq record -> FragSeq, or None at EOF (src/io.c:46-167)."""
    import sys

    c = fs.getc()
    if c == -1:
        return None
    if c != ord("@"):
        print(
            "While reading fastq file, saw record not beginning with @\n"
            "Maybe badly formed input? Continuing, anyway...",
            file=sys.stderr,
        )
        return None
    frag = FragSeq()

    chars = []
    i = 0
    while True:
        c = fs.getc()
        if c == -1:
            return None
        if _isspace(c):
            break
        if i >= MAX_ID_LEN:
            break
        chars.append(c)
        i += 1
    frag.id = bytes(chars).decode("latin-1")

    if c == ord("\n"):
        frag.desc = ""
    else:
        while c != ord("\n") and _isspace(c):
            c = fs.getc()
        dchars = []
        i = 0
        while c != ord("\n") and c != -1 and i < MAX_DESC_LEN:
            dchars.append(c)
            i += 1
            c = fs.getc()
        frag.desc = bytes(dchars).decode("latin-1")

    # sequence (single line)
    schars = []
    i = 0
    c = fs.getc()
    while c != ord("\n") and c != -1 and i < INIT_ALN_SEQ_LEN:
        if not _isspace(c):
            schars.append(c)
            i += 1
        c = fs.getc()
    frag.seq = bytes(schars).decode("latin-1").upper()
    frag.seq_len = i
    if i == INIT_ALN_SEQ_LEN:
        while c != ord("\n") and c != -1:
            c = fs.getc()

    # '+' header line
    c = fs.getc()
    if c != ord("+"):
        print(f"Problem reading quality line for {frag.id}", file=sys.stderr)
        return frag
    c = fs.getc()
    while c != ord("\n") and c != -1:
        c = fs.getc()

    # quality line
    qchars = []
    i = 0
    c = fs.getc()
    while c != ord("\n") and c != -1 and i < INIT_ALN_SEQ_LEN:
        if not _isspace(c):
            qchars.append(c)
            i += 1
        c = fs.getc()
    frag.qual = bytes(qchars).decode("latin-1")
    frag.qual_sum = calc_qual_sum(frag.qual)
    if i == INIT_ALN_SEQ_LEN:
        while c != ord("\n") and c != -1:
            c = fs.getc()

    if i != frag.seq_len:
        print(f"{frag.id} has unequal sequence and qual line lengths", file=sys.stderr)
        return None
    return frag


def iter_frag_seqs(path: str):
    """Yield FragSeq records from a fasta or fastq file (format sniffed)."""
    with open(path, "rb") as fh:
        data = fh.read()
    seq_code = find_input_type(data)
    fs = _ByteStream(data)
    reader = read_fastq if seq_code else read_fasta
    while True:
        frag = reader(fs)
        if frag is None:
            return
        yield frag


def read_fasta_ref(path: str) -> RefSeq:
    """Load a reference FASTA (keeps case, grows without cap) and build its
    reverse complement (src/io.c:288-399)."""
    with open(path, "rb") as fh:
        data = fh.read()
    fs = _ByteStream(data)
    c = fs.getc()
    if c == -1 or c != ord(">"):
        raise ValueError(f"{path}: not a fasta reference")
    ref = RefSeq()

    chars = []
    n = 0
    while True:
        c = fs.getc()
        if c == -1:
            raise ValueError(f"{path}: truncated header")
        if _isspace(c):
            break
        if n >= MAX_ID_LEN:
            break
        chars.append(c)
        n += 1
    ref.id = bytes(chars).decode("latin-1")

    dchars = []
    n = 0
    done = c == ord("\n")
    if not done:
        c = fs.getc()  # reference skips exactly one whitespace char
    while not done and c != ord("\n"):
        if c == -1:
            raise ValueError(f"{path}: truncated header")
        dchars.append(c)
        n += 1
        if n == MAX_DESC_LEN:
            break
        c = fs.getc()
    ref.desc = bytes(dchars).decode("latin-1")

    schars = []
    c = fs.getc()
    while c != ord(">") and c != -1:
        if not _isspace(c):
            schars.append(c)
        c = fs.getc()
    ref.seq = bytes(schars).decode("latin-1")
    ref.seq_len = len(ref.seq)
    # size doubles from INIT_REF_SEQ_LEN as needed (maln SIZE field parity)
    from ..constants import INIT_REF_SEQ_LEN

    size = INIT_REF_SEQ_LEN
    while ref.seq_len >= size:
        size *= 2
    ref.size = size
    ref.rcseq = revcom(ref.seq)
    ref.wrap_seq_len = ref.seq_len
    return ref
