"""The identify pipeline (port of kasa_tpu/match/pipeline.py, turbo
engine only): fastq/fasta(.gz) -> per-read output + profile.

The port covers kasa_tpu's CLI identify on the turbo engine: DNA in
one, three or six frames, protein input (-z), a custom codon table
(-a), unique k-mers per read (-e), paired-end input (-1/-2), --filter,
a folder of inputs (identify_multiple) and 64-bit, 128-bit or halved
indices with resident turbo tables, and 64-bit indices over the device
budget through the tiered chunk streaming.  Every other mode or flag
raises NotImplementedError naming the later slice; nothing falls back
to another engine or to the CPU.
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
    ("coverage", "--coverage", "the fallback engines"),
    ("post_process", "--coherence", "the fallback engines"),
    ("visualize", "--visualize", "the fallback engines"),
    ("sloppy", "-j (sloppy)", "the fallback engines"),
)


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for a configuration outside the ported
    slices."""
    for attr, what, later in _UNSUPPORTED:
        if getattr(cfg, attr, None):
            raise NotImplementedError(
                f"{what} is not ported yet ({later}: a later slice of "
                "kasa_tpu_torch)")


def _output_names(cfg: Config, files: list, input_path: str,
                  out_file: str | None, profile_file: str | None):
    """Per-file outputs of a folder: <q><name><ending> and <p><name>.csv
    (Compare.hpp:2918-2928, 3052, 3079)."""
    from ..host.output import file_ending
    outs, profs = [], []
    for f in files:
        rel = f[len(input_path):].lstrip("/")
        parts = rel.split(".")
        name = parts[0] if len(parts) == 1 else ".".join(parts[:-1])
        outs.append(out_file + name + file_ending(cfg.output_format)
                    if out_file else None)
        profs.append(profile_file + name + ".csv" if profile_file else None)
    return outs, profs


def _load_index(cfg: Config, index_path: str):
    """-> (limbs, taxids, highest_k, content, freqs, tax_rows) with the
    k range clamped to the index.  A halved index is reconstructed to
    full k-mers; its stored values are already content rows."""
    limbs, taxids, highest_k, itype = artifacts.read_index(index_path)
    halved = itype == artifacts.INDEX_TYPE_HALF
    if halved:
        limbs, tax_rows = artifacts.read_halved_reconstructed(index_path)
    cfg.highest_k = highest_k
    cfg.clamp_ks()
    content = load_content_for_identify(
        cfg.content_file or index_path + "_content.txt")
    freqs = load_frequencies(index_path, content.num_species, cfg.higher_k,
                             cfg.lower_k)
    if halved:
        taxids = np.asarray(content.idx_to_tax, dtype=np.uint32)[tax_rows]
    else:
        from .join import map_tax_rows
        tax_rows = map_tax_rows(taxids, content.tax_to_idx) \
            if len(taxids) else np.zeros(0, np.int32)
    return limbs, taxids, highest_k, content, freqs, tax_rows


def identify(cfg: Config, index_path: str | None = None,
             input_path: str | None = None, out_file: str | None = None,
             profile_file: str | None = None, device=None):
    """Run the classifier over one input file, a paired-end pair or a
    folder of files on `device` (None = cuda; raises without CUDA).
    Returns (counts_all, counts_unique, reads, k-mers in input); for a
    folder, a list of such tuples, one per file (counts None when the
    packed path ran without profiles)."""
    dev = resolve_device(device)
    index_path = index_path or cfg.index_file or cfg.db_out
    input_path = input_path if input_path is not None else cfg.input
    out_file = out_file if out_file is not None else cfg.read_to_taxa_file
    profile_file = profile_file if profile_file is not None else cfg.table_file
    check_supported(cfg)

    if input_path and os.path.isdir(input_path):
        from ..host import fastx
        files = fastx.gather_input_files(input_path)
        outs, profs = _output_names(cfg, files, input_path, out_file,
                                    profile_file)
        if (len(files) > 1 and not cfg.filter and not cfg.paired_end_1
                and not (cfg.six_frames and not cfg.translated)):
            # packed multi-file path: one shared batch stream, per-file
            # output demux; with profiles the kernels split the count
            # matrices per file
            from .fast import fast_identify_multi
            limbs, taxids, highest_k, content, freqs, tax_rows = \
                _load_index(cfg, index_path)
            return fast_identify_multi(
                cfg, index_path, files, outs, content, freqs, limbs, taxids,
                highest_k, tax_rows, dev,
                profile_files=profs if profile_file else None)
        return [identify(cfg, index_path=index_path, input_path=f,
                         out_file=o, profile_file=p, device=dev)
                for f, o, p in zip(files, outs, profs)]

    limbs, taxids, highest_k, content, freqs, tax_rows = \
        _load_index(cfg, index_path)
    from .fast import fast_identify
    return fast_identify(cfg, index_path, input_path, out_file,
                         profile_file, content, freqs, limbs, taxids,
                         highest_k, tax_rows, dev)


def identify_multiple(cfg: Config, device=None):
    """identify_multiple mode (main.cpp:1118-1334): classify every file
    of a folder against one loaded index; outputs as identify on the
    folder."""
    from ..host import fastx
    if not os.path.isdir(cfg.input):
        raise RuntimeError("identify_multiple requires a folder with multiple "
                           "files in it!")
    if len(fastx.gather_input_files(cfg.input)) < 2:
        raise RuntimeError("identify_multiple requires a folder with at least "
                           "2 files in it!")
    return identify(cfg, device=device)


def write_filtered(cfg: Config, input_path: str, filtered_ids: list):
    """--filter second pass (Compare.hpp:2448-2604): split the input
    into clean / contaminated files, paired-end aware, optional .gz."""
    import gzip as gzip_mod
    from ..host import fastx

    paired = bool(cfg.paired_end_1)
    paths = [cfg.paired_end_1, cfg.paired_end_2] if paired else [input_path]
    fmt = fastx.sniff_format(paths[0])
    ending = ".fasta" if fmt == "fasta" else ".fastq"
    gz = ".gz" if cfg.gzip_out else ""
    doomed = set(filtered_ids)

    def openw(path):
        if cfg.gzip_out:
            return gzip_mod.open(path, "wt")
        return open(path, "w")

    outs = {}
    for tag, base in (("clean", cfg.filtered_clean_out),
                      ("cont", cfg.filtered_contaminants_out)):
        if base == "_":
            continue
        if paired:
            outs[tag] = [openw(base + "_1" + ending + gz),
                         openw(base + "_2" + ending + gz)]
        else:
            outs[tag] = [openw(base + ending + gz)]

    iters = [fastx.iter_raw_records(p, fmt) for p in paths]
    for rid, blocks in enumerate(zip(*iters)):
        tag = "cont" if rid in doomed else "clean"
        if tag not in outs:
            continue
        for fh, block in zip(outs[tag], blocks):
            for line in block:
                fh.write(line + "\n")
    for fhs in outs.values():
        for fh in fhs:
            fh.close()
