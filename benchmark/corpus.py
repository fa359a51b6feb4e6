"""Inputs of the benchmark, made from seeds: a configuration's index
family (once, from its corpus seed) and a traffic mix's reads (every
run, from ``--seed``).

The genomes are those of ``kasa_tpu_torch/synth.py`` (the same numpy
draws from the same constants and seed), so the index is the one that
``PERF.md`` reports on, byte for byte.  Windowing, the codon table, the
sort and the writer are this module's own, vectorised in torch on the
run's device: the index is what the reference reads too, and nothing of
the port makes it.

Index family (what identify loads): ``<dir>/benchIndex`` (kASA's packed
records: u64 key + u32 taxid, or u128 + u32 at highestK 25, padded to
stxxl blocks), ``_info.txt``, ``_content.txt`` and ``_f.txt`` (the
per-taxon k-mer counts); ``<dir>/DONE`` holds the entry count.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

# the 64 codons in TCAG order (NCBI table 1); kASA writes the stops TAA
# and TAG as '[' and TGA as ']', and any triplet with an 'X' as '^'
_AA_TCAG = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
BASES = b"ACGT"
PAD = 4                 # base index of 'X' (a position past the line)
CODE_PAD = 30           # letter code of a triplet with an 'X' ('^')
LETTERS_PER_WORD = 12   # 60 bits of 5-bit letters in an int64 word
BLOCK_64, BLOCK_128 = 2101248, 2048000
REC_64 = np.dtype([("kmer", "<u8"), ("taxid", "<u4")])
REC_128 = np.dtype([("lo", "<u8"), ("hi", "<u8"), ("taxid", "<u4")])


def codon_codes() -> np.ndarray:
    """(125,) uint8: letter code of the triplet of base indices (b1, b2,
    b3) at b1 * 25 + b2 * 5 + b3 (A 0, C 1, G 2, T 3, X 4)."""
    out = np.full(125, CODE_PAD, np.uint8)
    for i1, c1 in enumerate("ACGT"):
        for i2, c2 in enumerate("ACGT"):
            for i3, c3 in enumerate("ACGT"):
                letter = _AA_TCAG["TCAG".index(c1) * 16
                                  + "TCAG".index(c2) * 4 + "TCAG".index(c3)]
                if letter == "*":
                    letter = "]" if c1 + c2 + c3 == "TGA" else "["
                out[i1 * 25 + i2 * 5 + i3] = ord(letter) & 31
    return out


def base_index() -> np.ndarray:
    """(256,) uint8: ASCII byte -> base index; every other byte is 'X'."""
    lut = np.full(256, PAD, np.uint8)
    for i, c in enumerate(BASES):
        lut[c] = i
    return lut


def word_letters(highest_k: int) -> list[int]:
    """Letters held by each int64 word of a key: 12, 12, ... then the
    rest; the first letter sits in a word's highest bits."""
    out, rem = [], highest_k
    while rem > 0:
        out.append(min(LETTERS_PER_WORD, rem))
        rem -= LETTERS_PER_WORD
    return out


def pack_words(letters: torch.Tensor, highest_k: int) -> list[torch.Tensor]:
    """(M, highest_k) letter codes -> the key as int64 words (lex order
    over the words is kASA's numeric order of the key)."""
    words, pos = [], 0
    for m in word_letters(highest_k):
        acc = torch.zeros(letters.shape[0], dtype=torch.int64,
                          device=letters.device)
        for j in range(m):
            acc |= letters[:, pos + j].to(torch.int64) << (5 * (m - 1 - j))
        words.append(acc)
        pos += m
    return words


def window_letters(codes: torch.Tensor, n_windows: int,
                   highest_k: int) -> torch.Tensor:
    """codes (rows, P) letter codes of each position's triplet -> (rows,
    n_windows, highest_k): window w takes codes[w + 3 j]."""
    idx = (torch.arange(n_windows, device=codes.device)[:, None]
           + 3 * torch.arange(highest_k, device=codes.device)[None, :])
    return codes[:, idx]


def triplet_codes(bidx: torch.Tensor) -> torch.Tensor:
    """(rows, P) base indices -> (rows, P - 2) letter codes."""
    table = torch.from_numpy(codon_codes()).to(bidx.device)
    b = bidx.to(torch.int64)
    return table[b[:, :-2] * 25 + b[:, 1:-1] * 5 + b[:, 2:]]


# ---------------------------------------------------------------------------
# genomes and the index family

def genomes(cfg: dict) -> np.ndarray:
    """(num_species, genome_len) uint8 ASCII genomes: synth.py's
    _gen_genomes, draw for draw (random DNA, core genes shared by about
    num_species * core_per_genome / core_genes genomes, one
    ultra-conserved gene in the first ultra_genomes)."""
    rng = np.random.default_rng(cfg["corpus_seed"])
    glen, glen_core = cfg["genome_len"], cfg["core_gene_len"]
    core = rng.integers(0, 4, size=(cfg["core_genes"], glen_core))
    ultra = rng.integers(0, 4, size=glen_core)
    out = np.empty((cfg["num_species"], glen), np.uint8)
    dna_of = np.frombuffer(BASES, np.uint8)
    for g in range(cfg["num_species"]):
        dna = rng.integers(0, 4, size=glen)
        for pick in rng.integers(0, cfg["core_genes"],
                                 size=cfg["core_per_genome"]):
            off = int(rng.integers(0, glen - glen_core))
            dna[off:off + glen_core] = core[pick]
        if g < cfg["ultra_genomes"]:
            off = int(rng.integers(0, glen - glen_core))
            dna[off:off + glen_core] = ultra
        out[g] = dna_of[dna]
    return out


def index_entries(gen: np.ndarray, highest_k: int, device,
                  genomes_per_block: int = 256):
    """Every window that lies inside a genome -> (words, taxids): the
    distinct (key, taxid) entries sorted by key, then taxid (genome g
    has taxid g + 1)."""
    dev = torch.device(device)
    lut = torch.from_numpy(base_index()).to(dev)
    n_win = gen.shape[1] - 3 * highest_k + 1
    parts, taxa = [], []
    for g0 in range(0, len(gen), genomes_per_block):
        block = torch.from_numpy(gen[g0:g0 + genomes_per_block]).to(dev)
        codes = triplet_codes(lut[block.long()])
        let = window_letters(codes, n_win, highest_k)
        parts.append(pack_words(let.reshape(-1, highest_k), highest_k))
        taxa.append(torch.arange(g0 + 1, g0 + 1 + len(block), device=dev)
                    .repeat_interleave(n_win))
        del codes, let
    words = [torch.cat([p[i] for p in parts]) for i in range(len(parts[0]))]
    tax = torch.cat(taxa)
    del parts, taxa
    # least significant word first; the stable sorts keep genome order
    # (taxid order) among equal keys
    perm = torch.arange(len(tax), device=dev)
    for w in reversed(words):
        perm = perm[torch.argsort(w[perm], stable=True)]
    words = [w[perm] for w in words]
    tax = tax[perm]
    keep = torch.ones(len(tax), dtype=torch.bool, device=dev)
    same = tax[1:] == tax[:-1]
    for w in words:
        same &= w[1:] == w[:-1]
    keep[1:] = ~same
    return [w[keep] for w in words], tax[keep]


def words_to_records(words: list[np.ndarray], taxids: np.ndarray,
                     highest_k: int) -> np.ndarray:
    """Key words -> kASA's packed records (u64 or u128 key, u32 taxid)."""
    if highest_k <= LETTERS_PER_WORD:
        rec = np.empty(len(taxids), REC_64)
        rec["kmer"] = words[0].astype(np.uint64)
    elif highest_k == 25:
        w0, w1, w2 = (w.astype(np.uint64) for w in words)
        rec = np.empty(len(taxids), REC_128)
        rec["hi"] = (w0 << np.uint64(1)) | (w1 >> np.uint64(59))
        rec["lo"] = ((w1 & np.uint64((1 << 59) - 1)) << np.uint64(5)) | w2
    else:
        raise ValueError(f"highest_k {highest_k}: indices are 64-bit (12) "
                         "or 128-bit (25)")
    rec["taxid"] = taxids.astype(np.uint32)
    return rec


def records_to_words(rec: np.ndarray, highest_k: int) -> list[np.ndarray]:
    """Inverse of words_to_records: int64 key words of packed records."""
    if highest_k <= LETTERS_PER_WORD:
        return [rec["kmer"].astype(np.int64)]
    hi, lo = rec["hi"], rec["lo"]
    return [(hi >> np.uint64(1)).astype(np.int64),
            (((hi & np.uint64(1)) << np.uint64(59))
             | (lo >> np.uint64(5))).astype(np.int64),
            (lo & np.uint64(31)).astype(np.int64)]


def write_family(path: str, rec: np.ndarray, num_species: int,
                 highest_k: int) -> None:
    """The index, _info.txt, _content.txt and _f.txt of `path`."""
    block = BLOCK_64 if rec.dtype == REC_64 else BLOCK_128
    with open(path, "wb") as fh:
        rec.tofile(fh)
        fh.write(b"\x00" * (-(-max(rec.nbytes, 1) // block) * block
                            - rec.nbytes))
    with open(path + "_info.txt", "w") as fh:
        fh.write(str(len(rec)) + ("\n128" if rec.dtype == REC_128 else ""))
    with open(path + "_content.txt", "w") as fh:
        fh.write("".join(f"Synthetic species {i}\t{i}\t{i}\tSYN{i}\n"
                         for i in range(1, num_species + 1)))
    # per-taxon counts of entries whose letter at each position is not
    # '^' (k = highestK .. 1): every letter of a genome window is valid
    per_tax = np.bincount(rec["taxid"].astype(np.int64),
                          minlength=num_species + 1)
    rows = ["non_unique" + "\t0" * highest_k]
    rows += [f"Synthetic species {i}" + f"\t{int(per_tax[i])}" * highest_k
             for i in range(1, num_species + 1)]
    with open(path + "_f.txt", "w") as fh:
        fh.write("\n".join(rows) + "\n")


def ensure_index(cfg: dict, directory: str, device, log=print) -> str:
    """The configuration's index family under `directory`, generated on
    the first call (a DONE stamp marks a finished family) -> index path."""
    index = os.path.join(directory, "benchIndex")
    stamp = os.path.join(directory, "DONE")
    if os.path.exists(stamp):
        return index
    t0 = time.perf_counter()
    tmp = directory + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    gen = genomes(cfg)
    words, tax = index_entries(gen, cfg["highest_k"], device)
    words = [w.cpu().numpy() for w in words]
    tax = tax.cpu().numpy()
    rec = words_to_records(words, tax, cfg["highest_k"])
    del words, tax
    write_family(os.path.join(tmp, "benchIndex"), rec, cfg["num_species"],
                 cfg["highest_k"])
    with open(os.path.join(tmp, "DONE"), "w") as fh:
        fh.write(f"{len(rec)}\n")
    shutil.rmtree(directory, ignore_errors=True)
    os.replace(tmp, directory)
    log(f"corpus: {cfg['name']}: {len(rec):,} entries in "
        f"{time.perf_counter() - t0:.1f} s")
    return index


# ---------------------------------------------------------------------------
# reads

def _grid(lo: int, hi: int, n: int, gen, device) -> torch.Tensor:
    """n sizes spread evenly over lo..hi, in an order drawn from `gen`:
    every seed gets the same set of sizes."""
    sizes = lo + (torch.arange(n, device=device) * (hi - lo + 1)) // n
    return sizes[torch.randperm(n, generator=gen, device=device)]


def _normal_quantiles(n: int, device) -> torch.Tensor:
    """(n,) float64: the standard normal's quantiles at (i + 1/2) / n."""
    p = (torch.arange(n, device=device, dtype=torch.float64) + 0.5) / n
    return torch.special.ndtri(p)


def _lognormal_sizes(traffic: dict, n: int, gen, device) -> torch.Tensor:
    """n read lengths at the quantiles of the log-normal of mean
    read_len_mean and s.d. read_len_sd, rounded and clipped to
    read_len_min..read_len_max, in an order drawn from `gen`: every seed
    gets the same set of lengths."""
    m, sd = traffic["read_len_mean"], traffic["read_len_sd"]
    sig2 = float(np.log1p((sd / m) ** 2))
    mu = float(np.log(m)) - sig2 / 2
    sizes = torch.exp(mu + sig2 ** 0.5 * _normal_quantiles(n, device))
    sizes = torch.round(sizes).clamp(traffic["read_len_min"],
                                     traffic["read_len_max"]).long()
    return sizes[torch.randperm(n, generator=gen, device=device)]


def _accuracies(traffic: dict, n: int, gen, device) -> torch.Tensor:
    """n per-read accuracies at the quantiles of the normal of mean
    accuracy_mean and s.d. accuracy_sd, clipped to accuracy_min..
    accuracy_max, in an order drawn from `gen`."""
    acc = (traffic["accuracy_mean"]
           + traffic["accuracy_sd"] * _normal_quantiles(n, device))
    acc = acc.clamp(traffic["accuracy_min"], traffic["accuracy_max"])
    return acc[torch.randperm(n, generator=gen, device=device)]


def _sample(flat: torch.Tensor, pos: torch.Tensor, rate: float, gen,
            complement: bool = False) -> torch.Tensor:
    """The bases at `pos` of the flat genomes, complemented if asked,
    each replaced by a random base with probability `rate`."""
    acgt = torch.tensor(list(BASES), dtype=torch.uint8, device=flat.device)
    out = flat[pos]
    if complement:
        out = _complement(out)
    hit = torch.rand(len(pos), generator=gen, device=flat.device) < rate
    repl = acgt[torch.randint(0, 4, (len(pos),), generator=gen,
                              device=flat.device)]
    return torch.where(hit, repl, out)


def _complement(seq: torch.Tensor) -> torch.Tensor:
    comp = torch.zeros(256, dtype=torch.uint8, device=seq.device)
    comp[list(BASES)] = torch.tensor(list(b"TGCA"), dtype=torch.uint8,
                                     device=seq.device)
    return comp[seq.long()]


def _long_reads(flat: torch.Tensor, start: torch.Tensor, size: torch.Tensor,
                acc: torch.Tensor, rev: torch.Tensor, ratio: list, gen):
    """Reads of exactly `size` bases copied from the flat genomes at
    `start` with errors at the rate 1 - acc, split into substitutions,
    insertions and deletions by `ratio`: each source base is deleted,
    replaced by another base or kept, and a random base is inserted
    after it; reads marked `rev` are reverse-complemented.
    -> (blob uint8, offs int64 (R + 1,)) on the device."""
    dev = flat.device
    R = len(size)
    r_sub, r_ins, r_del = (x / sum(ratio) for x in ratio)
    # source spans long enough for the read at any accuracy: the output
    # of a source base averages 1 + err (r_ins - r_del) >= 1
    span = size + 16 + size // 16
    soffs = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    soffs[1:] = torch.cumsum(span, 0)
    n = int(soffs[-1])
    read = torch.repeat_interleave(torch.arange(R, device=dev), span)
    pos = start[read] + torch.arange(n, device=dev) - soffs[:-1][read]
    err = (1.0 - acc)[read]
    u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
    kept = u >= err * r_del
    sub = kept & (u < err * (r_del + r_sub))
    ins = torch.rand(n, generator=gen, device=dev,
                     dtype=torch.float64) < err * r_ins
    bidx = torch.from_numpy(base_index()).to(dev)[flat[pos].long()]
    shift = torch.randint(1, 4, (n,), generator=gen, device=dev)
    bidx = torch.where(sub, (bidx + shift) % 4, bidx)
    extra = torch.randint(0, 4, (n,), generator=gen, device=dev)
    # two slots a source base: the base (unless deleted), the insertion
    slots = torch.stack([bidx, extra], 1).reshape(-1)
    valid = torch.stack([kept, ins], 1).reshape(-1)
    out = slots[valid]
    got = torch.bincount(read.repeat_interleave(2)[valid], minlength=R)
    got_offs = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    got_offs[1:] = torch.cumsum(got, 0)
    size = torch.minimum(size, got)
    offs = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    offs[1:] = torch.cumsum(size, 0)
    rid = torch.repeat_interleave(torch.arange(R, device=dev), size)
    within = torch.arange(int(offs[-1]), device=dev) - offs[:-1][rid]
    within = torch.where(rev[rid], size[rid] - 1 - within, within)
    acgt = torch.tensor(list(BASES), dtype=torch.uint8, device=dev)
    seq = acgt[out[got_offs[:-1][rid] + within]]
    seq = torch.where(rev[rid], _complement(seq), seq)
    return seq, offs


def draw_ring(traffic: dict, gen_t: torch.Tensor, seed: int) -> list:
    """The run's reads, from `seed`: ring_batches batches of
    reads_per_batch reads (pairs count as one read).  gen_t: the (G,
    glen) uint8 genomes on the device that draws.  Pairs: FR mates of
    inserts spread evenly over insert_min..insert_max, substitutions at
    error_rate.  Single reads: log-normal lengths, per-read accuracies
    and a share of reverse strands as the traffic states them (each the
    same set for every seed, in the seed's order), errors by _long_reads.
    -> per batch a list of mates, each (blob uint8, offs int64 (R + 1,))
    on the host."""
    dev = gen_t.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    G, glen = gen_t.shape
    flat = gen_t.reshape(-1)
    rpb, nb = traffic["reads_per_batch"], traffic["ring_batches"]
    paired = traffic["paired"]
    n = rpb * nb
    if paired:
        sizes = _grid(traffic["insert_min"], traffic["insert_max"], n, gen,
                      dev)
    else:
        sizes = _lognormal_sizes(traffic, n, gen, dev)
        accs = _accuracies(traffic, n, gen, dev)
        revs = (torch.arange(n, device=dev)
                < round(n * traffic["reverse_share"]))
        revs = revs[torch.randperm(n, generator=gen, device=dev)]
    ring = []
    for b in range(nb):
        size = sizes[b * rpb:(b + 1) * rpb]
        g = torch.randint(0, G, (rpb,), generator=gen, device=dev)
        span = size if paired else size + 16 + size // 16
        off = (torch.rand(rpb, generator=gen, device=dev, dtype=torch.float64)
               * (glen - span + 1)).long()
        start = g * glen + off
        if paired:
            rate = traffic["error_rate"]
            m = traffic["mate_len"]
            j = torch.arange(m, device=dev)
            fwd = (start[:, None] + j).reshape(-1)
            rev = (start[:, None] + size[:, None] - 1 - j).reshape(-1)
            offs = np.arange(rpb + 1, dtype=np.int64) * m
            mates = [(_sample(flat, fwd, rate, gen).cpu().numpy(), offs),
                     (_sample(flat, rev, rate, gen, True).cpu().numpy(),
                      offs.copy())]
        else:
            blob, offs = _long_reads(flat, start, size,
                                     accs[b * rpb:(b + 1) * rpb],
                                     revs[b * rpb:(b + 1) * rpb],
                                     traffic["error_ratio"], gen)
            mates = [(blob.cpu().numpy(), offs.cpu().numpy())]
        ring.append(mates)
    return ring
