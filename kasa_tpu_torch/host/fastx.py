"""Input format detection for FASTA/FASTQ (plain or gzip).  The
records themselves are parsed by the native loader (native/loader.cpp)."""

from __future__ import annotations

import gzip
import io


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
