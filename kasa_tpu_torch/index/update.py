"""Index mutation modes: update, delete, merge (port of
kasa_tpu/index/update.py; update's new entries come from build_index, on
cfg.device for a 128-bit index's sort, K13).

Reference: Update.hpp (UpdateFromFasta :99-179, DeleteFromLib :28-94),
Read::MergeTwoIndices (Read.hpp:3180-3243), Build::merge 2-way dedup
merge (Build.hpp:152-300) and the dummy-taxid remap machinery of
mergeContentFiles (GenerateContentFile.hpp:449-611).

The 2-way merge compares on ORIGINAL (kmer, taxid) order and applies
the dummy remaps at emit time, exactly like the reference (so a remap
that breaks taxid ordering reproduces the reference's output order).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from ..config import Config
from ..core import kmer
from . import artifacts
from .build import build_index, compute_frequencies
from .content import generate_content_file, merge_content_files, read_content_file


def _pair_key(limbs: np.ndarray, tax: np.ndarray) -> np.ndarray:
    """(N, L+1) int64 sort-key array: limbs then taxid."""
    n = len(tax)
    out = np.empty((n, limbs.shape[1] + 1), dtype=np.int64)
    out[:, :limbs.shape[1]] = limbs
    out[:, -1] = tax.astype(np.int64)
    return out


def merge_sorted_indices(
    limbs_a: np.ndarray, tax_a: np.ndarray,
    limbs_b: np.ndarray, tax_b: np.ndarray,
    remap_a: dict[int, int] | None = None,
    remap_b: dict[int, int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Build::merge (Build.hpp:152-300): merge two sorted dedup'd
    (kmer, taxid) arrays; exact (kmer, taxid) duplicates across the two
    emit only the B-side element; remaps apply at emit time while the
    merge order uses original taxids."""
    ka = _pair_key(limbs_a, tax_a)
    kb = _pair_key(limbs_b, tax_b)

    # drop A elements exactly equal to a B element (equal case emits B)
    if len(tax_b) and len(tax_a):
        # row-wise membership via void view
        va = np.ascontiguousarray(ka).view([("", ka.dtype)] * ka.shape[1]).ravel()
        vb = np.ascontiguousarray(kb).view([("", kb.dtype)] * kb.shape[1]).ravel()
        dup_a = np.isin(va, vb)
    else:
        dup_a = np.zeros(len(tax_a), dtype=bool)

    keep_a = ~dup_a
    out_tax_a = tax_a[keep_a].astype(np.uint32)
    out_tax_b = tax_b.astype(np.uint32).copy()
    if remap_a:
        for old, new in remap_a.items():
            out_tax_a[out_tax_a == np.uint32(old)] = np.uint32(new)
    if remap_b:
        for old, new in remap_b.items():
            out_tax_b[out_tax_b == np.uint32(old)] = np.uint32(new)

    all_keys = np.concatenate([ka[keep_a], kb])
    all_limbs = np.concatenate([limbs_a[keep_a], limbs_b])
    all_tax = np.concatenate([out_tax_a, out_tax_b])
    order = np.lexsort(tuple(all_keys[:, i] for i in range(all_keys.shape[1] - 1, -1, -1)))
    return all_limbs[order], all_tax[order]


def _write_artifact_family(out_path: str, limbs: np.ndarray, tax: np.ndarray,
                           highest_k: int, content_path: str):
    artifacts.write_index(out_path, limbs, tax, highest_k)
    prefixes, counts = artifacts.trie_from_sorted_prefixes(limbs[:, 0])
    artifacts.write_trie(out_path, prefixes, counts)
    entries = read_content_file(content_path)
    freq = compute_frequencies(limbs, tax, entries, highest_k, lowest_k=1)
    artifacts.write_frequency_file(out_path, entries, freq)


def update_index(cfg: Config):
    """update mode (main.cpp:699-770; Update.hpp:99-179)."""
    index_in = cfg.index_file
    out_path = cfg.db_out or index_in
    content_in = cfg.content_file or index_in + "_content.txt"
    content_out = cfg.content_file_after_update or (
        (cfg.db_out + "_content.txt") if not cfg.content_file else content_in)

    limbs_old, tax_old, highest_k, itype = artifacts.read_index(index_in)
    if itype == artifacts.INDEX_TYPE_HALF:
        raise RuntimeError("Halved indices cannot be modified in this way. Sorry...")

    remap1: dict[int, int] = {}
    remap2: dict[int, int] = {}
    if content_out:
        # addToContentFile (GenerateContentFile.hpp:615-636)
        with tempfile.TemporaryDirectory() as td:
            tmp_content = os.path.join(td, "tempContent.txt")
            generate_content_file(cfg.input, tmp_content,
                                  acc2tax_path=cfg.acc_to_tax_files,
                                  taxonomy_path=cfg.taxonomy_path,
                                  tax_level=cfg.tax_level or "species",
                                  taxids_as_strings=cfg.taxids_as_strings,
                                  verbose=cfg.verbose)
            remap1, remap2 = merge_content_files(
                content_in, tmp_content, content_out, merge_existing_indices=True)
        content_in = content_out

    limbs_new, tax_new = build_index(
        cfg.input, content_in, out_path, highest_k=highest_k,
        six_frames=cfg.six_frames, one_frame=cfg.one_frame,
        protein=cfg.translated, sloppy=cfg.sloppy,
        temp_dir=cfg.temp_path or None, write_artifacts=False,
        verbose=cfg.verbose, device=cfg.device)

    limbs, tax = merge_sorted_indices(limbs_old, tax_old, limbs_new, tax_new,
                                      remap1, remap2)
    _write_artifact_family(out_path, limbs, tax, highest_k, content_in)


def delete_from_index(cfg: Config):
    """delete mode (Update.hpp:28-94): drop entries whose taxid is in
    delnodes.dmp; rebuild trie + frequency file."""
    index_in = cfg.index_file
    out_path = cfg.db_out
    if not out_path:
        raise RuntimeError("No output file given!")
    content_in = cfg.content_file or index_in + "_content.txt"

    limbs, tax, highest_k, itype = artifacts.read_index(index_in)
    if itype == artifacts.INDEX_TYPE_HALF:
        raise RuntimeError("Halved indices cannot be modified in this way. Sorry...")

    doomed = set()
    with open(cfg.delnodes_file) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line:
                doomed.add(int(line.split("\t")[0]))
    keep = ~np.isin(tax.astype(np.int64), np.array(sorted(doomed), dtype=np.int64))
    _write_artifact_family(out_path, limbs[keep], tax[keep], highest_k, content_in)


def merge_indices(cfg: Config):
    """merge mode (main.cpp:877-977; Read.hpp:3180-3243)."""
    first, second = cfg.first_old_index, cfg.second_old_index
    out_path = cfg.db_out
    if os.path.exists(out_path):
        raise RuntimeError("Output file already exists, aborting to avoid overwrite")
    c1 = cfg.content_file1 or first + "_content.txt"
    c2 = cfg.content_file2 or second + "_content.txt"
    content_out = cfg.content_file or out_path + "_content.txt"

    limbs_a, tax_a, hk_a, it_a = artifacts.read_index(first)
    limbs_b, tax_b, hk_b, it_b = artifacts.read_index(second)
    if it_a != it_b:
        raise RuntimeError("Indices have different bit-ness (64 vs 128); cannot merge")
    if artifacts.INDEX_TYPE_HALF in (it_a, it_b):
        raise RuntimeError("Halved indices cannot be merged. Sorry...")

    remap1, remap2 = merge_content_files(c1, c2, content_out,
                                         merge_existing_indices=True)
    limbs, tax = merge_sorted_indices(limbs_a, tax_a, limbs_b, tax_b,
                                      remap1, remap2)

    # Reference quirk (MergeTwoIndices, Read.hpp:3180-3243): the merged
    # index gets NO _info.txt, and the subsequent GetFrequencyK then
    # reads a size of 0 and writes an all-zero frequency file.  We
    # replicate both for byte parity; run `trie`/`getFrequency` after
    # restoring an _info.txt to get usable sidecars.
    artifacts.write_index(out_path, limbs, tax, hk_a)
    os.remove(out_path + "_info.txt")
    prefixes, counts = artifacts.trie_from_sorted_prefixes(limbs[:, 0])
    artifacts.write_trie(out_path, prefixes, counts)
    entries = read_content_file(content_out)
    freq = compute_frequencies(limbs[:0], tax[:0], entries, hk_a, lowest_k=1)
    artifacts.write_frequency_file(out_path, entries, freq)
