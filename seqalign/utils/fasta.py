"""FASTA/FASTQ reading with gzip support.

Replacement for the reference's vendored ``seq_file`` C library
(L0 in SURVEY.md §1; used at ``src/alignment_cmdline.c:335-457``). Supports
FASTA and FASTQ, plain or gzip, from a path, ``-``/stdin, or a file object.
Format is autodetected from the first non-blank character ('>' = FASTA,
'@' = FASTQ), like seq_file does.

A native C++ fast path (``seqalign.utils.native_io``) parses large
databases with the same semantics; this module is the always-available pure
Python implementation and the behavioral spec.
"""

from __future__ import annotations

import gzip
import io
import sys
from dataclasses import dataclass
from typing import Iterator


@dataclass
class SeqRecord:
    """One sequence record: FASTA/FASTQ name line (sans marker) + sequence."""

    name: str
    seq: str


def _open_stream(path: str):
    if path in ("-", ""):
        return sys.stdin.buffer
    return open(path, "rb")


def _maybe_gzip(stream):
    head = stream.peek(2) if hasattr(stream, "peek") else b""
    if head[:2] == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=stream))
    return stream


def _lines(stream) -> Iterator[str]:
    for raw in stream:
        yield raw.decode("ascii", errors="replace").rstrip("\r\n")


def read_fasta(path_or_stream) -> Iterator[SeqRecord]:
    """Yield records from a FASTA/FASTQ file (gzip autodetected)."""
    if isinstance(path_or_stream, str):
        stream = _open_stream(path_or_stream)
        close = path_or_stream not in ("-", "")
    else:
        stream = path_or_stream
        close = False
    stream = _maybe_gzip(stream)
    try:
        lines = _lines(stream)
        first = None
        for line in lines:
            if line.strip():
                first = line
                break
        if first is None:
            return
        if first[0] == ">":
            yield from _read_fasta_records(first, lines)
        elif first[0] == "@":
            yield from _read_fastq_records(first, lines)
        else:
            raise ValueError(
                "unrecognized sequence file format (expected FASTA '>' or "
                f"FASTQ '@', got {first[:1]!r})"
            )
    finally:
        if close:
            stream.close()


def _read_fasta_records(first: str, lines: Iterator[str]):
    name = first[1:]
    chunks: list[str] = []
    for line in lines:
        if not line:
            continue
        if line[0] == ">":
            yield SeqRecord(name, "".join(chunks))
            name = line[1:]
            chunks = []
        else:
            chunks.append(line.strip())
    yield SeqRecord(name, "".join(chunks))


def _read_fastq_records(first: str, lines: Iterator[str]):
    name = first[1:]
    while True:
        seq = next(lines, None)
        if seq is None:
            return
        _plus = next(lines, None)
        _qual = next(lines, None)
        yield SeqRecord(name, seq.strip())
        nxt = next(lines, None)
        while nxt is not None and not nxt.strip():
            nxt = next(lines, None)
        if nxt is None:
            return
        if nxt[0] != "@":
            raise ValueError("malformed FASTQ: expected '@' record start")
        name = nxt[1:]


def read_first(path: str) -> SeqRecord:
    """Read the first record (the query), erroring on empty files."""
    for rec in read_fasta(path):
        if not rec.seq:
            raise ValueError(f"Error: Query file {path} is empty or invalid")
        return rec
    raise ValueError(f"Error: Query file {path} is empty or invalid")
