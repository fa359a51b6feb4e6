"""Input format detection for FASTA/FASTQ (plain or gzip), the input
files of a folder, the verbatim record reader of --filter, the record
iterator of the per-batch engine (native loader, native/loader.cpp) and
the binary opener of its chunked reader, and the text readers of the
index build and the tools (iter_fasta, iter_fastq, first_sequence)."""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterator


def open_text(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(
            io.BufferedReader(gzip.open(path, "rb"), buffer_size=1 << 20),
            encoding="ascii",
        )
    return open(path, "r", buffering=1 << 20)


def binary_opener(path: str):
    """Zero-arg callable yielding a fresh binary stream (decompressed for
    .gz): the chunked reader re-opens the file after its info pre-scan."""
    if path.endswith(".gz"):
        return lambda: gzip.open(path, "rb")
    return lambda: open(path, "rb")


def sniff_format(path: str) -> str:
    """'fasta' or 'fastq' from the first character (Compare.hpp:2984-2995)."""
    with open_text(path) as fh:
        first = fh.read(1)
    if first == ">":
        return "fasta"
    if first == "@":
        return "fastq"
    raise ValueError("Input does not start with @ or >.")


def first_sequence(path: str) -> str:
    """First sequence line, for alphabet auto-detection."""
    with open_text(path) as fh:
        fh.readline()
        return fh.readline().strip()


@dataclass
class Record:
    name: str       # header without the leading > or @
    seq: str
    nlines: int = 1  # sequence lines (the reference's char counter
                     # includes one newline per line, Read.hpp:730-731)


def iter_fasta(path: str) -> Iterator[Record]:
    name = None
    parts: list[str] = []
    with open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\n").rstrip("\r")
            if not line:
                continue
            if line[0] == ">":
                if name is not None:
                    yield Record(name, "".join(parts), max(len(parts), 1))
                name = line[1:]
                parts = []
            else:
                parts.append(line)
        if name is not None:
            yield Record(name, "".join(parts), max(len(parts), 1))


def iter_fastq(path: str) -> Iterator[Record]:
    with open_text(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            header = header.rstrip("\n").rstrip("\r")
            if not header:
                continue
            seq = fh.readline().rstrip("\n").rstrip("\r")
            fh.readline()   # +
            fh.readline()   # quality
            yield Record(header[1:], seq)


def iter_records(path: str, fmt: str | None = None) -> Iterator[Record]:
    """The records of a fasta/fastq(.gz) file, parsed by the native
    loader (native/loader.cpp)."""
    from ..native import load_fastx
    fmt = fmt or sniff_format(path)
    parsed = load_fastx(path, is_fastq=(fmt == "fastq"))
    if parsed is None:
        raise RuntimeError(f"could not parse {path} (the native host "
                           "library needs g++ and zlib)")
    seq, seq_off, names, name_off, nlines = parsed

    def gen():
        nb, sb = names.tobytes(), seq.tobytes()
        for i in range(len(nlines)):
            yield Record(nb[name_off[i]:name_off[i + 1]].decode("ascii"),
                         sb[seq_off[i]:seq_off[i + 1]].decode("ascii"),
                         int(nlines[i]))
    return gen()


def iter_raw_records(path: str, fmt: str | None = None) -> Iterator[list]:
    """Yield each record's original lines verbatim (for --filter's
    pass-through copy, Compare.hpp:2498-2603)."""
    fmt = fmt or sniff_format(path)
    with open_text(path) as fh:
        if fmt == "fasta":
            block: list = []
            for line in fh:
                line = line.rstrip("\n")
                if not line:
                    continue
                if line[0] == ">":
                    if block:
                        yield block
                    block = [line]
                else:
                    block.append(line)
            if block:
                yield block
        else:
            while True:
                lines = [fh.readline() for _ in range(4)]
                if not lines[0]:
                    return
                block = [ln.rstrip("\n") for ln in lines]
                if block[0] == "":
                    continue
                yield block


def gather_input_files(path: str) -> list[str]:
    """The files of a folder (hidden ones skipped), sorted; a file
    path is its own list."""
    if os.path.isdir(path):
        return sorted(os.path.join(path, f) for f in os.listdir(path)
                      if not f.startswith("."))
    return [path]
