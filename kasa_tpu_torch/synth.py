"""Synthetic benchmark corpora (the port's copy of bench_corpus.py's
generator: same constants, same seed, same files), and two large-index
variants of it.

Generates, once, under ``.synth_corpus/`` at the repo root (listed in
.gitignore):

  * a reference-format index family (index + _info.txt + _trie +
    _trie.txt + _f.txt + _content.txt) built from NUM_SPECIES synthetic
    genomes -- random DNA translated through the real codon table, with
    a pool of conserved "core genes" shared across genomes (multi-taxa
    groups up to T~16, a few T~60, one ultra-conserved T~150 that
    exercises the host recompute), ~32.7 M entries at full size;
  * 150 bp read sets sampled from those genomes with 0.5 % substitution
    errors, as fastq (reads, a small set and a warm-up set), plus the
    first SMOKE_READS reads as their own file;
  * SMOKE_READS / 2 read pairs, as two fastq files of mates: both mates
    of a pair come from one fragment of one genome (an insert of
    INSERT_MIN..INSERT_MAX bp), mate 1 its first 150 bp, mate 2 the
    reverse complement of its last 150 bp (Illumina's FR orientation).

Two large-index variants, each in its own directory:

  * ``bigS/`` (``generate_big_s``): BIG_S = 10,001 species, the species
    count of the RefSeq-scale index in docs/perf.md, so the index takes
    the sparse multi fold (more than SPARSE_FOLD_S species, no hot tier).
    Genomes of BIG_GENOME_LEN = 8,000 bp with one 300 bp core gene each
    keep the default corpus's conserved share (2 x 300 of 16,000 = 3.75
    %); BIG_CORE_GENES = 625 keeps ~16 genomes per gene; the same 150
    genomes carry the ultra-conserved gene.  ~80 M index entries.  Its
    own 150 bp reads (warm-up and smoke sets), no pairs.
  * ``wide/`` (``generate_wide``): the default corpus's 2,047 genomes
    (same seed, so the same genomes) as a 128-bit index at highestK =
    25 (five limbs per k-mer, ~32.6 M entries).  The default corpus's
    reads serve it: they come from the same genomes.

``long_reads`` writes long read lines from the default corpus's genomes:
single-end reads of 1-8 kbp and 2 x 250 bp pairs.
``protein_reads`` writes seeded protein reads cut from a protein fasta
(the golden protein reads of tests/golden match nothing).
``taxonomy_from_content`` writes a taxonomy and an acc2tax file under
which generateCF reproduces a content file, and ``STANDARD_GC_PRT`` is
NCBI's standard genetic code (table 1) in gc.prt layout: the inputs of
the golden index modes that read the reference's taxonomy or codon
table.  ``write_genomes_fasta`` writes a corpus's genomes as the FASTA
``build`` reads.

``python -m kasa_tpu_torch.synth [default] [bigS] [wide]`` builds the
named corpora and, with ``--tables``, the turbo-table sidecar each is
identified with (``prepare``); with ``--tiered BYTES`` also the tiered
path's chunk cache (``<index>_oocache_turbo_torch``) for a device budget
of BYTES, as identify builds it under ``KASA_DEVICE_BUDGET=BYTES``.
``generate`` takes the sizes as arguments so tests can build a tiny
corpus.
"""

from __future__ import annotations

import os
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIR = os.path.join(REPO, ".synth_corpus")
NUM_SPECIES = 2047
GENOME_LEN = 16_000
CORE_GENES = 256        # 300 bp each, ~16 genomes share one gene
CORE_PER_GENOME = 2
ULTRA_GENOMES = 150     # genomes embedding the one ultra-conserved gene
READS = 200_000
WARM_READS = 8_192
SMALL_READS = 12_288
SMOKE_READS = 65_536    # 8 full batches of 8192 reads
READ_LEN = 150
INSERT_MIN, INSERT_MAX = 300, 500
ERR_RATE = 0.005
SEED = 20260820
BIG_S = 10_001
BIG_GENOME_LEN = 8_000
BIG_CORE_GENES = 625
BIG_CORE_PER_GENOME = 1
WIDE_K = 25
LONG_READS = 8_192      # one batch of long single-end reads
LONG_MIN, LONG_MAX = 1_000, 8_000
LONG_PAIRS = 8_192
LONG_MATE = 250

_DNA = np.frombuffer(b"ACGT", np.uint8)


def _gen_genomes(rng, num_species, genome_len, core_genes,
                 core_per_genome=CORE_PER_GENOME):
    core = rng.integers(0, 4, size=(core_genes, 300))
    ultra = rng.integers(0, 4, size=300)
    genomes = []
    for g in range(num_species):
        dna = rng.integers(0, 4, size=genome_len)
        for pick in rng.integers(0, core_genes, size=core_per_genome):
            off = int(rng.integers(0, genome_len - 300))
            dna[off:off + 300] = core[pick]
        if g < ULTRA_GENOMES:
            off = int(rng.integers(0, genome_len - 300))
            dna[off:off + 300] = ultra
        genomes.append(_DNA[dna])
    return genomes


def _index_from_genomes(genomes, highest_k=12):
    """All windows of every genome -> sorted, deduplicated (limbs,
    taxids), ordered by (limb0, ..., limb L-1, taxid).  64-bit keys go
    through the native sort; wider ones (highest_k > 12) through
    np.lexsort."""
    from .core import kmer
    from .core.encode import (build_codon_code_lut, dna_to_aa_codes_np,
                              encode_windows_np)
    from .native import sort_kmer_tax
    lut = build_codon_code_lut()
    all_limbs, all_tax = [], []
    for g, dna in enumerate(genomes):
        aa = dna_to_aa_codes_np(dna, lut)
        w = len(dna) - 3 * highest_k + 1   # windows fully inside the genome
        all_limbs.append(encode_windows_np(aa, highest_k, 3)[:w])
        all_tax.append(np.full(w, g + 1, np.uint32))
    limbs = np.concatenate(all_limbs)
    del all_limbs
    taxids = np.concatenate(all_tax)
    keys = kmer.limbs_to_u64(limbs) if highest_k <= 12 else None
    if keys is not None and sort_kmer_tax(keys, taxids, 60,
                                          os.cpu_count() or 1):
        limbs = kmer.u64_to_limbs(keys)
    else:
        order = np.lexsort((taxids,) + tuple(
            limbs[:, i] for i in range(limbs.shape[1] - 1, -1, -1)))
        limbs, taxids = limbs[order], taxids[order]
    keep = np.ones(len(taxids), bool)
    keep[1:] = np.any(limbs[1:] != limbs[:-1], axis=1) \
        | (taxids[1:] != taxids[:-1])
    return np.ascontiguousarray(limbs[keep]), taxids[keep]


def _write_artifacts(index, limbs, taxids, num_species, highest_k=12):
    from .index import artifacts
    from .index.build import compute_frequencies
    from .index.content import ContentEntry, write_content_file
    entries = [ContentEntry(name=f"Synthetic species {i}", taxid=str(i),
                            lowest_taxids=[str(i)], accessions=[f"SYN{i}"])
               for i in range(1, num_species + 1)]
    write_content_file(index + "_content.txt", entries)
    artifacts.write_index(index, limbs, taxids, highest_k)
    prefixes, counts = artifacts.trie_from_sorted_prefixes(limbs[:, 0])
    artifacts.write_trie(index, prefixes, counts)
    freq = compute_frequencies(limbs, taxids, entries, highest_k, 1,
                               threads=os.cpu_count() or 1)
    artifacts.write_frequency_file(index, entries, freq)


def _emit(fh, rng, genomes, n, tag):
    qual = b"I" * READ_LEN
    gsel = rng.integers(0, len(genomes), size=n)
    for i in range(n):
        g = genomes[gsel[i]]
        off = int(rng.integers(0, len(g) - READ_LEN))
        r = g[off:off + READ_LEN].copy()
        err = np.nonzero(rng.random(READ_LEN) < ERR_RATE)[0]
        if len(err):
            r[err] = _DNA[rng.integers(0, 4, size=len(err))]
        fh.write(b"@%s_%d src%d\n" % (tag, i, gsel[i] + 1))
        fh.write(r.tobytes())
        fh.write(b"\n+\n")
        fh.write(qual)
        fh.write(b"\n")


def _emit_pairs(fh1, fh2, rng, genomes, n, read_len=READ_LEN,
                insert=(INSERT_MIN, INSERT_MAX)):
    """n read pairs, both mates from one fragment (see the module
    docstring); the mates share a name, as paired fastq files do."""
    from .core.alphabet import build_revcomp_lut
    revcomp = build_revcomp_lut()
    qual = b"I" * read_len
    gsel = rng.integers(0, len(genomes), size=n)
    for i in range(n):
        g = genomes[gsel[i]]
        ins = int(rng.integers(insert[0], insert[1] + 1))
        off = int(rng.integers(0, len(g) - ins))
        frag = g[off:off + ins]
        for fh, mate in ((fh1, frag[:read_len].copy()),
                         (fh2, revcomp[frag[ins - read_len:]][::-1].copy())):
            err = np.nonzero(rng.random(read_len) < ERR_RATE)[0]
            if len(err):
                mate[err] = _DNA[rng.integers(0, 4, size=len(err))]
            fh.write(b"@p_%d src%d\n" % (i, gsel[i] + 1))
            fh.write(mate.tobytes())
            fh.write(b"\n+\n")
            fh.write(qual)
            fh.write(b"\n")


def long_reads(directory: str, n: int = LONG_READS, n_pairs: int = LONG_PAIRS,
               seed: int = SEED + 7) -> dict:
    """Long read lines from the corpus's genomes (the same seed gives the
    same genomes): n single-end reads of LONG_MIN..LONG_MAX bp (uniform
    lengths, 0.5 % substitutions) and n_pairs pairs of 2 x LONG_MATE bp
    mates (inserts of 500..800 bp), as fastq files in `directory`.
    -> their paths."""
    out = dict(reads=os.path.join(directory, "long_reads.fastq"),
               pairs=[os.path.join(directory, f"long_pairs_{m}.fastq")
                      for m in (1, 2)])
    genomes = _gen_genomes(np.random.default_rng(SEED), NUM_SPECIES,
                           GENOME_LEN, CORE_GENES)
    rng = np.random.default_rng(seed)
    gsel = rng.integers(0, len(genomes), size=n)
    lens = rng.integers(LONG_MIN, LONG_MAX + 1, size=n)
    with open(out["reads"], "wb") as fh:
        for i in range(n):
            g = genomes[gsel[i]]
            off = int(rng.integers(0, len(g) - lens[i]))
            r = g[off:off + lens[i]].copy()
            err = np.nonzero(rng.random(len(r)) < ERR_RATE)[0]
            r[err] = _DNA[rng.integers(0, 4, size=len(err))]
            fh.write(b"@l_%d src%d\n%s\n+\n%s\n"
                     % (i, gsel[i] + 1, r.tobytes(), b"I" * len(r)))
    with open(out["pairs"][0], "wb") as fh1, \
            open(out["pairs"][1], "wb") as fh2:
        _emit_pairs(fh1, fh2, rng, genomes, n_pairs, LONG_MATE, (500, 800))
    return out


def protein_reads(fasta: str, out_path: str, n: int = 80,
                  seed: int = 12) -> str:
    """n protein reads: 30-60 aa substrings of the records of `fasta`
    with up to two substitutions each, seeded; written to `out_path`."""
    recs, cur = [], []
    with open(fasta) as fh:
        for line in fh.read().splitlines():
            if line.startswith(">"):
                cur = []
                recs.append(cur)
            else:
                cur.append(line.strip())
    seqs = ["".join(r) for r in recs]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = seqs[i % len(seqs)]
        m = int(rng.integers(30, 61))
        o = int(rng.integers(0, len(s) - m))
        read = list(s[o:o + m])
        for j in rng.integers(0, m, size=int(rng.integers(0, 3))):
            read[j] = "ACDEFGHIKLMNPQRSTVWY"[int(rng.integers(0, 20))]
        out.append(f">pr{i}\n{''.join(read)}\n")
    with open(out_path, "w") as fh:
        fh.write("".join(out))
    return out_path


# NCBI's standard genetic code as the reference's gc.prt lists it; read
# through -a <file> 1, it differs from the built-in alphabet in TGA
STANDARD_GC_PRT = """--**************************************************************
Genetic-code-table ::= {
 {
  name "Standard" ,
  name "SGC0" ,
  id 1 ,
  ncbieaa  "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
  sncbieaa "---M------**--*----M---------------M----------------------------"
  -- Base1  TTTTTTTTTTTTTTTTCCCCCCCCCCCCCCCCAAAAAAAAAAAAAAAAGGGGGGGGGGGGGGGG
  -- Base2  TTTTCCCCAAAAGGGGTTTTCCCCAAAAGGGGTTTTCCCCAAAAGGGGTTTTCCCCAAAAGGGG
  -- Base3  TCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAGTCAG
 }
}
"""


def taxonomy_from_content(content: str, directory: str) -> str:
    """Write names.dmp, nodes.dmp and acc2tax.txt into `directory` such
    that generateCF at the species level (-y directory -f
    directory/acc2tax.txt -u species) gives back `content`'s rows: every
    taxid a species under the root, named as the row names it, each
    accession mapped to its row's taxid.  The rows of headers without an
    accession (EWAN_<n>, dummy taxids) need no entry.  -> directory."""
    os.makedirs(directory, exist_ok=True)
    names, nodes, acc = [], [], []
    with open(content) as fh:
        for line in fh:
            name, taxid, _, accs = line.rstrip("\n").split("\t")[:4]
            if name.startswith("EWAN_"):
                continue
            names.append(f"{taxid}\t|\t{name}\t|\t\t|\tscientific name\t|\n")
            nodes.append(f"{taxid}\t|\t1\t|\tspecies\t|\n")
            acc += [f"{a}\t{taxid}\n" for a in accs.split(";") if a]
    for fname, rows in (("names.dmp", names), ("nodes.dmp", nodes),
                        ("acc2tax.txt", acc)):
        with open(os.path.join(directory, fname), "w") as fh:
            fh.write("".join(rows))
    return directory


def write_genomes_fasta(path: str, num_species: int = NUM_SPECIES,
                        genome_len: int = GENOME_LEN,
                        core_genes: int = CORE_GENES,
                        seed: int = SEED) -> str:
    """The corpus's genomes (the same seed gives the same genomes as
    generate and generate_wide) as FASTA records named SYN<i>, the
    accessions of the corpus's content file, 70 bases a line."""
    genomes = _gen_genomes(np.random.default_rng(seed), num_species,
                           genome_len, core_genes)
    with open(path, "wb") as fh:
        for g, dna in enumerate(genomes, start=1):
            fh.write(b">SYN%d\n" % g)
            for o in range(0, len(dna), 70):
                fh.write(dna[o:o + 70].tobytes() + b"\n")
    return path


def paths(directory: str = DIR) -> dict:
    return dict(index=os.path.join(directory, "benchIndex"),
                reads=os.path.join(directory, "reads.fastq"),
                reads_small=os.path.join(directory, "reads_small.fastq"),
                warm=os.path.join(directory, "warm.fastq"),
                smoke=os.path.join(directory, "reads_smoke.fastq"),
                pairs=[os.path.join(directory, f"pairs_{m}.fastq")
                       for m in (1, 2)])


def generate(directory: str = DIR, num_species: int = NUM_SPECIES,
             genome_len: int = GENOME_LEN, core_genes: int = CORE_GENES,
             reads: int = READS, small_reads: int = SMALL_READS,
             warm_reads: int = WARM_READS, smoke_reads: int = SMOKE_READS,
             seed: int = SEED, log=print,
             core_per_genome: int = CORE_PER_GENOME,
             pairs: bool = True) -> dict:
    """Generate (once per directory) and return the corpus paths plus
    the entry count."""
    p = paths(directory)
    stamp = os.path.join(directory, "DONE")
    if not os.path.exists(stamp):
        os.makedirs(directory, exist_ok=True)
        rng = np.random.default_rng(seed)
        t0 = time.time()
        genomes = _gen_genomes(rng, num_species, genome_len, core_genes,
                               core_per_genome)
        log(f"# corpus: genomes generated ({time.time() - t0:.1f}s)")
        limbs, taxids = _index_from_genomes(genomes)
        log(f"# corpus: index built n={len(taxids):,} "
            f"({time.time() - t0:.1f}s)")
        _write_artifacts(p["index"], limbs, taxids, num_species)
        log(f"# corpus: artifacts written ({time.time() - t0:.1f}s)")
        for key, n, tag in (("reads", reads, b"r"),
                            ("reads_small", small_reads, b"s"),
                            ("warm", warm_reads, b"w")):
            with open(p[key], "wb") as fh:
                _emit(fh, rng, genomes, n, tag)
        with open(p["reads"], "rb") as src, open(p["smoke"], "wb") as dst:
            for _ in range(4 * min(smoke_reads, reads)):
                dst.write(src.readline())
        if pairs:
            with open(p["pairs"][0], "wb") as fh1, \
                    open(p["pairs"][1], "wb") as fh2:
                _emit_pairs(fh1, fh2, rng, genomes, smoke_reads // 2)
        log(f"# corpus: reads written ({time.time() - t0:.1f}s)")
        with open(stamp, "w") as fh:
            fh.write(f"{len(taxids)}\n")
    with open(stamp) as fh:
        p["n_entries"] = int(fh.read().split()[0])
    p["num_species"] = num_species
    return p


def generate_big_s(directory: str = os.path.join(DIR, "bigS"),
                   num_species: int = BIG_S,
                   genome_len: int = BIG_GENOME_LEN,
                   core_genes: int = BIG_CORE_GENES,
                   smoke_reads: int = SMOKE_READS,
                   warm_reads: int = WARM_READS, log=print) -> dict:
    """The large-species corpus (module docstring): its index, a warm-up
    read set and smoke_reads reads."""
    return generate(directory, num_species, genome_len, core_genes,
                    reads=smoke_reads, small_reads=0, warm_reads=warm_reads,
                    smoke_reads=smoke_reads, log=log,
                    core_per_genome=BIG_CORE_PER_GENOME, pairs=False)


def generate_wide(directory: str = os.path.join(DIR, "wide"),
                  num_species: int = NUM_SPECIES,
                  genome_len: int = GENOME_LEN,
                  core_genes: int = CORE_GENES, highest_k: int = WIDE_K,
                  seed: int = SEED, log=print) -> dict:
    """The default corpus's genomes as a 128-bit index (module
    docstring); only the index family is written."""
    index = os.path.join(directory, "benchIndex")
    stamp = os.path.join(directory, "DONE")
    if not os.path.exists(stamp):
        os.makedirs(directory, exist_ok=True)
        t0 = time.time()
        genomes = _gen_genomes(np.random.default_rng(seed), num_species,
                               genome_len, core_genes)
        limbs, taxids = _index_from_genomes(genomes, highest_k)
        log(f"# wide corpus: index built n={len(taxids):,} "
            f"({time.time() - t0:.1f}s)")
        _write_artifacts(index, limbs, taxids, num_species, highest_k)
        log(f"# wide corpus: artifacts written ({time.time() - t0:.1f}s)")
        with open(stamp, "w") as fh:
            fh.write(f"{len(taxids)}\n")
    with open(stamp) as fh:
        n = int(fh.read().split()[0])
    return dict(index=index, n_entries=n, num_species=num_species)


# the k range each corpus is identified with
K_RANGES = {"default": (7, 12), "bigS": (7, 12), "wide": (20, 25)}


def _peak_gib() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def prepare(which: str, tables: bool = False, tiered_budget: int = 0,
            log=print) -> dict:
    """Generate corpus `which` ("default", "bigS" or "wide") and, with
    tables, build its turbo-table sidecar for its k range on the host
    (the identify runs then load it from disk); with tiered_budget > 0,
    also the tiered chunk cache for that device budget in bytes."""
    corpus = {"default": generate, "bigS": generate_big_s,
              "wide": generate_wide}[which](log=log)
    if not (tables or tiered_budget):
        return corpus
    from .config import Config
    from .match.pipeline import _load_index
    cfg = Config()
    cfg.lower_k, cfg.higher_k = K_RANGES[which]
    limbs, _, highest_k, content, _, tax_rows = \
        _load_index(cfg, corpus["index"])
    if tables:
        from .match.turbo import load_or_build_turbo
        t0 = time.time()
        load_or_build_turbo(corpus["index"], limbs, tax_rows, highest_k,
                            cfg.lower_k, cfg.higher_k, content.num_species,
                            "cpu")
        log(f"# {which}: turbo tables k {cfg.lower_k}..{cfg.higher_k} "
            f"built in {time.time() - t0:.1f}s, peak host memory "
            f"{_peak_gib():.1f} GiB")
    if tiered_budget:
        import torch
        from .match.tiered import TieredTurboDispatch, chunk_entries_for
        t0 = time.time()
        disp = TieredTurboDispatch(
            corpus["index"], limbs, tax_rows, highest_k, cfg.lower_k,
            cfg.higher_k, content.num_species,
            chunk_entries_for(tiered_budget, cfg.num_k), torch.device("cpu"))
        log(f"# {which}: tiered chunk cache for a {tiered_budget}-byte "
            f"budget, {len(disp.chunks)} chunks of <= {disp.chunk_pad} "
            f"entries, built in {time.time() - t0:.1f}s, peak host memory "
            f"{_peak_gib():.1f} GiB")
    return corpus


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(prog="python -m kasa_tpu_torch.synth")
    ap.add_argument("names", nargs="*", default=["default"])
    ap.add_argument("--tables", action="store_true")
    ap.add_argument("--tiered", type=int, default=0, metavar="BYTES")
    args = ap.parse_args()
    for name in args.names:
        print(prepare(name, args.tables, args.tiered), flush=True)
