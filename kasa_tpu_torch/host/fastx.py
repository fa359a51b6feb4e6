"""Input format detection for FASTA/FASTQ (plain or gzip), the input
files of a folder, and the verbatim record reader of --filter.  The
records themselves are parsed by the native loader (native/loader.cpp)."""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator


def open_text(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(
            io.BufferedReader(gzip.open(path, "rb"), buffer_size=1 << 20),
            encoding="ascii",
        )
    return open(path, "r", buffering=1 << 20)


def sniff_format(path: str) -> str:
    """'fasta' or 'fastq' from the first character (Compare.hpp:2984-2995)."""
    with open_text(path) as fh:
        first = fh.read(1)
    if first == ">":
        return "fasta"
    if first == "@":
        return "fastq"
    raise ValueError("Input does not start with @ or >.")


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
