"""Sequence-ID allow-list parsing (parse_ids, src/io.c:1088-1135).

The reference loads newline-separated IDs (truncated at MAX_ID_LEN) into a
sorted array for bsearch; a hash set gives the same membership semantics.
"""
from __future__ import annotations

from ..constants import MAX_ID_LEN


def parse_ids(path: str) -> set[str]:
    ids: set[str] = set()
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError as e:
        # fileOpen (src/io.c:918-927) prints the name + perror; the reference
        # then dereferences the NULL handle (a crash) — we exit cleanly after
        # emitting the same stderr prefix.
        import sys

        print(path, file=sys.stderr)
        print(f"Cannot open file: {e.strerror}", file=sys.stderr)
        raise SystemExit(1)
    # only newline-terminated lines count (a trailing partial line is dropped,
    # matching the reference's per-'\n' commit)
    for line in data.split(b"\n")[:-1]:
        ids.add(line[:MAX_ID_LEN].decode("latin-1"))
    return ids
