"""The identify pipeline (port of kasa_tpu/match/pipeline.py):
fastq/fasta(.gz) -> per-read output + profile, through any of kasa_tpu's
three engines (cfg.engine):

  tpu   (the default) the fused path (match/fast.py: the turbo
        strategies or, where the turbo structure does not apply, the
        classic engine); -j, --coherence, --visualize and the input the
        fused path declines (FastPathUnavailable: an empty input, reads
        above MAXLEN_CAP, paired-end input on the classic engine) run
        the per-batch engine below (K9 per batch, match/engine.py), and
        over the memory budget (-m) its chunk streaming
        (match/oocore.py, K9 per index chunk); --coverage switches to
        the join engine, as in kasa_tpu;
  join  the per-batch join engine (match/join.py: K12, K10, K11 and the
        host group statistics);
  exact the per-batch host engine that reproduces the reference binary
        bit for bit (match/exact.py; match/walk128.py for 128-bit
        indices).

Every engine encodes with K1 on the device.  DNA in one, three or six
frames, protein input (-z), a custom codon table (-a), -e, paired-end
input, --filter, a folder of inputs (identify_multiple), -j,
--coherence, --coverage and --visualize, on 64-bit, 128-bit or halved
indices.  Nothing falls back to the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .. import resolve_device
from ..config import Config
from ..index import artifacts
from ..utils import timers


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


ENGINES = ("tpu", "join", "exact")


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
    engine = cfg.engine or "tpu"
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r}: one of {', '.join(ENGINES)}")

    if input_path and os.path.isdir(input_path):
        from ..host import fastx
        files = fastx.gather_input_files(input_path)
        outs, profs = _output_names(cfg, files, input_path, out_file,
                                    profile_file)
        if (engine == "tpu" and len(files) > 1 and not cfg.filter
                and not cfg.paired_end_1
                and not (cfg.six_frames and not cfg.translated)
                and not cfg.post_process and not cfg.sloppy
                and not cfg.visualize and not cfg.coverage):
            # packed multi-file path: one shared batch stream, per-file
            # output demux; with profiles the kernels split the count
            # matrices per file
            from .fast import FastPathUnavailable, fast_identify_multi
            limbs, taxids, highest_k, content, freqs, tax_rows = \
                _load_index(cfg, index_path)
            try:
                return fast_identify_multi(
                    cfg, index_path, files, outs, content, freqs, limbs,
                    taxids, highest_k, tax_rows, dev,
                    profile_files=profs if profile_file else None)
            except FastPathUnavailable as e:
                print(f"OUT: packed multi-file unavailable ({e}); "
                      "running per file", flush=True)
        return [identify(cfg, index_path=index_path, input_path=f,
                         out_file=o, profile_file=p, device=dev)
                for f, o, p in zip(files, outs, profs)]

    limbs, taxids, highest_k, content, freqs, tax_rows = \
        _load_index(cfg, index_path)
    if engine == "tpu" and not (cfg.post_process or cfg.sloppy
                                or cfg.visualize or cfg.coverage):
        from .fast import FastPathUnavailable, fast_identify
        try:
            return fast_identify(cfg, index_path, input_path, out_file,
                                 profile_file, content, freqs, limbs, taxids,
                                 highest_k, tax_rows, dev)
        except FastPathUnavailable as e:
            print(f"OUT: fast path unavailable ({e}); using the per-batch "
                  "tpu engine", flush=True)
    return _identify_per_batch(cfg, index_path, input_path, out_file,
                               profile_file, limbs, taxids, highest_k,
                               content, freqs, tax_rows, dev, engine)


def encode_batch(batch, encoder, highest_k: int, protein: bool,
                 one_frame: bool, want_positions: bool = False):
    """Encode all line buffers of a batch (K1 through the Encoder) ->
    (query limbs (M, L), read ids (M,)) [+ (positions (M,), frames (M,))
    for --coherence: position = emission index within the line
    (iPositionInString, Read.hpp:84-220), frame = 0 forward / 1
    reverse-complement line]."""
    from ..core import kmer
    L = 2 if encoder.sloppy else kmer.num_limbs(highest_k)
    empty = (np.zeros((0, L), np.int32), np.zeros(0, np.int32))
    if want_positions:
        empty = empty + (np.zeros(0, np.int32), np.zeros(0, np.int8))
    if not batch.buffers:
        return empty
    buf = np.concatenate(batch.buffers)
    starts = np.cumsum([0] + [len(b) for b in batch.buffers[:-1]])
    if protein:
        windows = encoder.encode_protein_buffer(buf, highest_k)
    else:
        windows = encoder.encode_dna_buffer(buf, highest_k)
    keep_parts, rid_parts, pos_parts, frm_parts = [], [], [], []
    for li, (s, cnt, rid) in enumerate(zip(starts, batch.line_counts,
                                           batch.line_read_ids)):
        if cnt == 0:
            continue
        if one_frame and not protein:
            keep_parts.append(windows[s:s + 3 * cnt:3])
        else:
            keep_parts.append(windows[s:s + cnt])
        rid_parts.append(np.full(cnt, rid, dtype=np.int32))
        if want_positions:
            pos_parts.append(np.arange(cnt, dtype=np.int32))
            frm_parts.append(np.full(cnt, batch.line_frames[li], np.int8))
    if not keep_parts:
        return empty
    out = (np.concatenate(keep_parts), np.concatenate(rid_parts))
    if want_positions:
        out = out + (np.concatenate(pos_parts), np.concatenate(frm_parts))
    return out


def stable_sort_queries(q_limbs: np.ndarray, read_ids: np.ndarray):
    """Host stable sort by k-mer (ties keep input order, which makes the
    reference's std::unique -e semantics reproducible)."""
    L = q_limbs.shape[1]
    order = np.lexsort(tuple(q_limbs[:, i] for i in range(L - 1, -1, -1)))
    return q_limbs[order], read_ids[order]


def unique_consecutive(q_limbs: np.ndarray, read_ids: np.ndarray):
    """-e: std::unique on (kmer, readID) over the sorted batch
    (Compare.hpp:3166-3177) -- consecutive duplicates only."""
    if len(read_ids) == 0:
        return q_limbs, read_ids
    keep = np.ones(len(read_ids), dtype=bool)
    keep[1:] = ~(np.all(q_limbs[1:] == q_limbs[:-1], axis=1)
                 & (read_ids[1:] == read_ids[:-1]))
    return q_limbs[keep], read_ids[keep]


def _u128_keys(limbs: np.ndarray) -> list:
    """The k-mers as Python ints (the 128-bit walk's keys)."""
    from ..core import kmer
    hi, lo = kmer.limbs_to_u128_parts(limbs)
    return [(int(h) << 64) | int(l) for h, l in zip(hi, lo)]


def _exact_batch(cfg, idx_u64, limbs, tax_rows, q_limbs, read_ids,
                 highest_k, R, S, score_rows):
    """The exact engine on one batch (kasa_tpu pipeline.py:395-418) ->
    (result, the sorted and -e deduped windows and read ids)."""
    from ..core import kmer
    from .exact import exact_identify_batch
    from .walk128 import walk_identify_128
    q_limbs, read_ids = stable_sort_queries(q_limbs, read_ids)
    if cfg.unique:
        q_limbs, read_ids = unique_consecutive(q_limbs, read_ids)
    if highest_k <= 12:
        res = exact_identify_batch(
            idx_u64, tax_rows, kmer.limbs_to_u64(q_limbs), read_ids,
            cfg.lower_k, cfg.higher_k, highest_k, R, S,
            coverage=cfg.coverage, want_scores=score_rows)
    else:
        # the reference's 128-bit walk, uint64-truncated comparator and all
        res = walk_identify_128(
            _u128_keys(limbs), tax_rows, _u128_keys(q_limbs), read_ids,
            cfg.lower_k, cfg.higher_k, highest_k, R, S,
            coverage=cfg.coverage, want_scores=score_rows)
    return res, q_limbs, read_ids


def _matcher(cfg, engine, index_path, limbs, taxids, highest_k, content,
             tax_rows, itype, dev):
    """The per-batch engine's index for `engine`: TpuEngine (resident
    classic tables), TieredIndex (chunk streaming over the memory budget,
    kasa_tpu pipeline.py:334-350), JoinIndex, or None (exact)."""
    min_k, max_k = cfg.lower_k, cfg.higher_k
    S = content.num_species
    if engine == "join":
        from .join import load_join_index
        with timers.stage("join/tables"):
            return load_join_index(index_path, limbs, taxids,
                                   content.tax_to_idx, highest_k, min_k,
                                   max_k, S, dev, tax_rows)
    if engine != "tpu":
        return None
    from .oocore import TieredIndex, bytes_per_entry
    per_entry = bytes_per_entry(limbs.shape[1], max_k - min_k + 1)
    table_bytes = per_entry * max(len(taxids), 1)
    budget = int(cfg.memory_avail * 0.8)
    if (not cfg.ram and table_bytes > budget
            and itype == artifacts.INDEX_TYPE_64 and min_k >= 6):
        chunk_entries = max(budget // per_entry, 1 << 16)
        print(f"OUT: index tables ({table_bytes >> 20} MiB) exceed the "
              f"memory budget; streaming {chunk_entries}-entry chunks",
              flush=True)
        with timers.stage("oocore/open"):
            return TieredIndex(
                index_path, content.tax_to_idx, min_k, max_k, S,
                chunk_entries, dev,
                cache_dir=(os.path.join(cfg.temp_path,
                                        f"oocache_torch_{cfg.call_idx}")
                           if cfg.temp_path else None))
    from .engine import TpuEngine
    return TpuEngine(limbs, taxids, content.tax_to_idx, highest_k, min_k,
                     max_k, S, dev, tax_rows, index_path)


def _visualize_batch(cfg, batch, vis, engine, q_limbs, read_ids, limbs,
                     taxids, tax_rows, highest_k, R, S):
    """--visualize (kasa_tpu pipeline.py:422-455, Compare.hpp:3330-3386):
    the frame strings and the walk's matched k-mers accumulate across
    batches (the reference never clears either) and print per batch."""
    from ..core import kmer
    from ..core.alphabet import apply_custom_codon_table, build_codon_lut
    from . import visualize as vis_mod
    from .walk128 import walk_identify_128
    frames, matched = vis
    lut = build_codon_lut()
    if cfg.codon_table:
        lut = apply_custom_codon_table(lut, cfg.codon_table, cfg.codon_id)
    vis_mod.frame_strings(batch, highest_k, lut, frames,
                          protein=cfg.translated)
    if engine != "exact":
        # the exact engine's windows come sorted (and -e deduped)
        q_limbs, read_ids = stable_sort_queries(q_limbs, read_ids)
    if highest_k <= 12:
        ikeys = kmer.limbs_to_u64(limbs).tolist()
        qkeys = kmer.limbs_to_u64(q_limbs).tolist()
    else:
        ikeys, qkeys = _u128_keys(limbs), _u128_keys(q_limbs)
    walk_identify_128(ikeys, tax_rows, qkeys, read_ids, cfg.lower_k,
                      cfg.higher_k, highest_k, R, S, want_scores=False,
                      vis=matched, idx_raw_tax=np.asarray(taxids))
    vis_mod.print_visualization(frames, matched)


def _identify_per_batch(cfg: Config, index_path: str, input_path: str,
                        out_file, profile_file, limbs, taxids, highest_k,
                        content, freqs, tax_rows, dev, engine="tpu"):
    """The per-batch engines (kasa_tpu pipeline.py:269-520):
    memory-bounded batches of reads (single-end input through the
    reference's chunked reader, which may split a read across batches
    and carries its partial scores), each encoded by K1 and matched by
    the engine -- tpu: K9 (match/engine.py TpuEngine, or per index chunk
    over the memory budget, match/oocore.py); join: match/join.py;
    exact: match/exact.py or the 128-bit walk -- then ranked and written
    per read; --coherence scores the reads' overlapping match runs,
    --visualize prints the walk's matches.  In a multi-process run only
    rank 0 runs them (no mesh arm): another rank raises NotWriter."""
    from ..parallel.dist import writer_only
    writer_only()
    from ..core import kmer
    from ..core.encode import Encoder, custom_code_lut
    from ..host import fastx
    from ..host import output as out_mod
    from . import chunking
    from . import ingest as ingest_mod
    from .join import match_and_score

    min_k, max_k = cfg.lower_k, cfg.higher_k
    num_k = max_k - min_k + 1
    S = content.num_species
    protein = cfg.translated
    entries, itype = artifacts.read_info(index_path)
    if cfg.post_process and highest_k > 12:
        raise RuntimeError("--coherence supports 64-bit indices only")
    if engine == "tpu" and cfg.coverage:
        # counts_total is a per-group-per-batch statistic the classic
        # kernel does not keep: kasa_tpu runs the join engine
        print("OUT: --coverage uses the join engine", flush=True)
        engine = "join"

    builder = ingest_mod.BatchBuilder(highest_k, min_k, protein=protein,
                                      six_frames=cfg.six_frames,
                                      one_frame=cfg.one_frame)
    encoder = Encoder(codon_code_lut=custom_code_lut(cfg),
                      sloppy=cfg.sloppy, device=dev)
    score_rows = out_file is not None or cfg.filter
    if cfg.paired_end_1:
        max_kmers = max(int(cfg.memory_avail) // 64, 1 << 16)
        batches = ingest_mod.read_paired_batches(
            cfg.paired_end_1, cfg.paired_end_2, builder,
            max_kmers_per_batch=max_kmers)
    else:
        soft0 = chunking.identify_soft_budget(
            cfg, index_path, content.organisms, content.idx_to_tax,
            min_k, max_k, itype, entries)
        elem = chunking.input_elem_size(highest_k > 12, cfg.post_process)
        batches = chunking.chunked_batches(
            fastx.binary_opener(input_path),
            fastx.sniff_format(input_path) == "fasta", builder, soft0, S,
            score_rows, cfg.post_process, elem)

    counts_all = np.zeros((num_k, S), dtype=np.float64)
    counts_unique = np.zeros((num_k, S), dtype=np.uint64)
    counts_total = np.zeros((num_k, S), dtype=np.uint64)
    num_kmers_in_input = 0
    num_reads_sum = 0
    filtered_ids: list = []
    saved_scores = None   # partial scores of a read split across batches
    vis = ([], [])        # --visualize: frame strings, matched k-mers
    writer = fh = None
    if out_file:
        # latin-1: codepoints 0-255 map to raw bytes 1:1 (the kraken
        # unclassified row emits length%256 as a raw byte)
        fh = open(out_file, "w", encoding="latin-1")
        writer = out_mod.ReadResultWriter(fh, cfg.output_format,
                                          num_of_beasts=cfg.num_of_beasts,
                                          coherence=cfg.post_process)
    matcher = _matcher(cfg, engine, index_path, limbs, taxids, highest_k,
                       content, tax_rows, itype, dev)
    idx_u64 = kmer.limbs_to_u64(limbs) if highest_k <= 12 and (
        cfg.post_process or engine == "exact") else None

    try:
        for batch in batches:
            with timers.stage("identify/encode"):
                enc = encode_batch(batch, encoder, highest_k, protein,
                                   cfg.one_frame,
                                   want_positions=cfg.post_process)
            q_limbs, read_ids = enc[0], enc[1]
            num_kmers_in_input += batch.num_kmers
            R = batch.num_reads
            coh = None
            if cfg.post_process:
                # --coherence: per-k-mer max matched k -> overlap-cluster
                # scores (postProcess, Compare.hpp:2607-2728) on the
                # unsorted batch, ordered (readID, frame-line, position)
                from .coherence import coherence_scores, max_match_lengths
                mlens = max_match_lengths(idx_u64,
                                          kmer.limbs_to_u64(q_limbs),
                                          min_k, max_k, highest_k)
                coh = coherence_scores(read_ids, enc[3], enc[2], mlens, R,
                                       cfg.six_frames)
            with timers.stage("identify/match"):
                if engine == "tpu":
                    res = matcher.classify(q_limbs, read_ids, R,
                                           unique=cfg.unique)
                elif engine == "join":
                    res = match_and_score(matcher, q_limbs, read_ids, R,
                                          unique=cfg.unique,
                                          coverage=cfg.coverage,
                                          want_scores=score_rows)
                else:
                    res, q_limbs, read_ids = _exact_batch(
                        cfg, idx_u64, limbs, tax_rows, q_limbs, read_ids,
                        highest_k, R, S, score_rows)
            scores = res.scores
            counts_all += res.counts_all
            counts_unique += res.counts_unique
            if cfg.coverage:
                counts_total += res.counts_total
            if cfg.visualize:
                _visualize_batch(cfg, batch, vis, engine, q_limbs, read_ids,
                                 limbs, taxids, tax_rows, highest_k, R, S)
            completed = R - 1 if batch.add_tail else R
            if score_rows:
                with timers.stage("identify/score+output"):
                    def emit(readnum, name, length, score_row, coh_val):
                        hits = out_mod.rank_read(
                            score_row, length, freqs[:, 0], min_k, max_k,
                            highest_k, protein, cfg.num_frames,
                            cfg.threshold, cfg.num_of_beasts)
                        if writer is not None:
                            writer.write_read(readnum, name, length, hits,
                                              content.idx_to_tax,
                                              content.organisms,
                                              coherence_val=coh_val)
                        # --filter: a read matching the index well is
                        # flagged as contaminated (Compare.hpp:1597-1608,
                        # double arithmetic); with --coherence a high
                        # coherence also flags it
                        if cfg.filter and hits.spec_idx:
                            best = hits.best_score
                            if (float(best) - float(max(hits.kmer_scores))) \
                                    / float(best) < cfg.error_threshold:
                                filtered_ids.append(readnum)
                            elif coh is not None and \
                                    float(coh_val) >= cfg.coherence_threshold:
                                filtered_ids.append(readnum)

                    # saveResults (Compare.hpp:2324-2446): a read continued
                    # from the previous batch merges its saved partial
                    # scores (one float32 add per species) and goes first
                    row0 = 0
                    if saved_scores is not None and batch.finished:
                        merged = saved_scores + np.asarray(scores[0],
                                                           np.float32)
                        emit(num_reads_sum, batch.names[0], batch.lengths[0],
                             merged, float(coh[0]) if coh is not None
                             else 0.0)
                        saved_scores = None
                        row0 = 1
                    for r in range(row0, completed):
                        emit(num_reads_sum + r, batch.names[r],
                             batch.lengths[r], scores[r],
                             float(coh[r]) if coh is not None else 0.0)
                    if batch.add_tail:
                        # park the unfinished last row's scores
                        tail = np.asarray(scores[R - 1], np.float32)
                        if (tail[1:] > 0.0).any():
                            saved_scores = tail.copy() \
                                if saved_scores is None \
                                else saved_scores + tail
            num_reads_sum += completed
    finally:
        if writer is not None:
            writer.close()
            fh.close()

    if profile_file:
        out_mod.write_profile(profile_file, content.organisms,
                              content.idx_to_tax, counts_all, counts_unique,
                              counts_total if cfg.coverage else None, freqs,
                              num_kmers_in_input, num_reads_sum, min_k,
                              max_k, cfg.num_frames, coverage=cfg.coverage)
    if cfg.filter:
        write_filtered(cfg, input_path, filtered_ids)
    timers.count("reads", num_reads_sum)
    if cfg.verbose:
        timers.report()
    from . import fast
    fast.LAST_DISPATCH = getattr(matcher, "tables", matcher)
    return counts_all, counts_unique, num_reads_sum, num_kmers_in_input


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
