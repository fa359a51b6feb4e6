"""Content file (taxa metadata) entries and writer -- the subset of
kasa_tpu/index/content.py that the synthetic corpus needs."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ContentEntry:
    name: str
    taxid: str
    lowest_taxids: list[str] = field(default_factory=list)
    accessions: list[str] = field(default_factory=list)
    str_index: str = ""  # only with --taxidasstr (5th column)


def write_content_file(path: str, entries: list[ContentEntry], taxids_as_strings: bool = False):
    with open(path, "w") as fh:
        for i, e in enumerate(entries, start=1):
            row = [e.name.replace(",", ""), e.taxid,
                   ";".join(e.lowest_taxids), ";".join(e.accessions)]
            if taxids_as_strings:
                row.append(str(i))
            fh.write("\t".join(row) + "\n")
