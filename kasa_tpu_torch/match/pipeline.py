"""The identify pipeline (port of kasa_tpu/match/pipeline.py, turbo
engine only): fastq/fasta(.gz) -> per-read output + profile.

The port covers kasa_tpu's default CLI identify: single-end DNA in
three frames on a 64-bit index with resident turbo tables.  Every other
mode or flag raises NotImplementedError naming the later slice; nothing
falls back to another engine or to the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .. import resolve_device
from ..config import Config
from ..index import artifacts


@dataclass
class ContentMeta:
    organisms: list     # row -> name (commas removed, Compare.hpp:135)
    idx_to_tax: list    # row -> taxid (int)
    tax_to_idx: dict    # taxid -> row
    num_species: int    # rows including row 0 = non_unique


def load_content_for_identify(path: str) -> ContentMeta:
    """loadContentAndFrequencyFiles content part (Compare.hpp:111-153)."""
    organisms = ["non_unique"]
    idx_to_tax = [0]
    tax_to_idx = {0: 0}
    taxids_as_strings = False
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) >= 5 and not taxids_as_strings:
                taxids_as_strings = True
            if len(parts) < 4:
                raise RuntimeError("Content file contains less than 4 columns")
            organisms.append(parts[0].replace(",", ""))
            tax = int(parts[4]) if taxids_as_strings else int(parts[1])
            idx_to_tax.append(tax)
            tax_to_idx[tax] = len(idx_to_tax) - 1
    return ContentMeta(organisms, idx_to_tax, tax_to_idx, len(idx_to_tax))


def load_frequencies(index_path: str, num_species: int, max_k: int, min_k: int
                     ) -> np.ndarray:
    """_f.txt -> (S, numK) freq matrix, column j -> k = maxK - j
    (Compare.hpp:165-179)."""
    freqs = np.zeros((num_species, max_k - min_k + 1), dtype=np.uint64)
    with open(index_path + "_f.txt") as fh:
        row = 0
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            num_of_k = len(parts) - 1
            for j, i in enumerate(range(max_k, min_k - 1, -1)):
                freqs[row, j] = int(parts[1 + num_of_k - i])
            row += 1
    return freqs


# flag -> the later slice of the port that brings it
_UNSUPPORTED = (
    ("six_frames", "--six (six frames)", "the flag variants"),
    ("one_frame", "--one (one frame)", "the flag variants"),
    ("unique", "-e (unique k-mers per read)", "the flag variants"),
    ("translated", "-z (protein input)", "the flag variants"),
    ("paired_end_1", "paired-end input (-1/-2)", "the flag variants"),
    ("codon_table", "-a (custom codon table)", "the flag variants"),
    ("filter", "--filter", "the flag variants"),
    ("coverage", "--coverage", "the fallback engines"),
    ("post_process", "--coherence", "the fallback engines"),
    ("visualize", "--visualize", "the fallback engines"),
    ("sloppy", "-j (sloppy)", "the fallback engines"),
)


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for a configuration outside this slice."""
    for attr, what, later in _UNSUPPORTED:
        if getattr(cfg, attr, None):
            raise NotImplementedError(
                f"{what} is not ported yet ({later}: a later slice of "
                "kasa_tpu_torch); this slice runs the default identify")


def identify(cfg: Config, index_path: str | None = None,
             input_path: str | None = None, out_file: str | None = None,
             profile_file: str | None = None, device=None):
    """Run the classifier over one single-end input file on `device`
    (None = cuda; raises without CUDA).  Returns (counts_all,
    counts_unique, reads, k-mers in input)."""
    dev = resolve_device(device)
    index_path = index_path or cfg.index_file or cfg.db_out
    input_path = input_path if input_path is not None else cfg.input
    out_file = out_file if out_file is not None else cfg.read_to_taxa_file
    profile_file = profile_file if profile_file is not None else cfg.table_file
    check_supported(cfg)
    if input_path and os.path.isdir(input_path):
        raise NotImplementedError(
            "a directory of inputs (identify_multiple) is a later slice of "
            "the port")

    limbs, taxids, highest_k, _ = artifacts.read_index(index_path)
    cfg.highest_k = highest_k
    cfg.clamp_ks()
    min_k, max_k = cfg.lower_k, cfg.higher_k

    content = load_content_for_identify(
        cfg.content_file or index_path + "_content.txt")
    freqs = load_frequencies(index_path, content.num_species, max_k, min_k)
    from .join import map_tax_rows
    tax_rows = map_tax_rows(taxids, content.tax_to_idx) \
        if len(taxids) else np.zeros(0, np.int32)

    from .fast import fast_identify
    return fast_identify(cfg, index_path, input_path, out_file,
                         profile_file, content, freqs, limbs, taxids,
                         highest_k, tax_rows, dev)
