"""The plain reference of identify's scoring, in torch operations only
(any device), from the index files and the reads alone.

Semantics (kASA identify, as kasa_tpu_torch states them): a read's
lines (the read, or its reverse complement and the read under --six;
both mates' lines for a pair) are windowed at every base offset; window
w takes the letter of the triplet at w + 3 j for j < highestK, a
triplet reaching past the line reading '^'.  At each k of the range,
a window whose first k letters are valid matches the group of index
entries that share those k letters; the group's T distinct taxa each
get w(k) / T of the read's score (w(k) = k^2 / 625 in float32), 1 / T
of the profile's counts_all[k] and, where T = 1, one of
counts_unique[k].  Under -e each distinct window (all highestK letters)
counts once a read.  A read's hits are the taxa with a score above 0.

Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .corpus import (REC_128, REC_64, base_index, pack_words,
                     records_to_words, triplet_codes, window_letters,
                     word_letters)


def weight(k: int) -> float:
    """w(k): kASA's tabulated float32 literal of k^2 / 625."""
    return float(np.float32(np.float32(k * k) / np.float32(625.0)))


def read_content_rows(path: str) -> np.ndarray:
    """The content file's taxids, row r + 1 for line r (row 0 is
    kASA's non_unique)."""
    tax = []
    with open(path) as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                tax.append(int(parts[4] if len(parts) >= 5 else parts[1]))
    return np.asarray(tax, np.int64)


def _lex_less(a: list, b: list) -> torch.Tensor:
    less = torch.zeros_like(a[0], dtype=torch.bool)
    eq = torch.ones_like(a[0], dtype=torch.bool)
    for x, y in zip(a, b):
        less |= eq & (x < y)
        eq &= x == y
    return less


class Level:
    """The groups of one k: entries sharing their first k letters."""

    def __init__(self, k: int, words: list, rows: torch.Tensor, S: int,
                 highest_k: int):
        self.k = k
        self.masks = []
        pos = 0
        for m in word_letters(highest_k):
            keep = min(max(k - pos, 0), m)
            self.masks.append(((1 << (5 * keep)) - 1) << (5 * (m - keep)))
            pos += m
        n = len(rows)
        new = torch.ones(n, dtype=torch.bool, device=rows.device)
        if n > 1:
            same = torch.ones(n - 1, dtype=torch.bool, device=rows.device)
            for w, mk in zip(words, self.masks):
                same &= (w[1:] & mk) == (w[:-1] & mk)
            new[1:] = ~same
        self.gid = torch.cumsum(new.to(torch.int64), 0) - 1
        self.num_groups = int(self.gid[-1]) + 1 if n else 0
        pair = torch.unique(self.gid * S + rows)
        self.pair_gid = pair // S
        self.pair_row = pair % S
        self.T = torch.bincount(self.pair_gid, minlength=self.num_groups)
        self.pstart = torch.zeros(self.num_groups + 1, dtype=torch.int64,
                                  device=rows.device)
        self.pstart[1:] = torch.cumsum(self.T, 0)


class Index:
    """An index family read back from its files, grouped at every k of
    [k_low, k_high]."""

    def __init__(self, path: str, k_low: int, k_high: int, device):
        dev = torch.device(device)
        with open(path + "_info.txt") as fh:
            tok = fh.read().split()
        n = int(tok[0])
        wide = len(tok) > 1 and tok[1] == "128"
        self.highest_k = 25 if wide else 12
        rec = np.fromfile(path, dtype=REC_128 if wide else REC_64, count=n)
        self.words = [torch.from_numpy(w).to(dev)
                      for w in records_to_words(rec, self.highest_k)]
        content = read_content_rows(path + "_content.txt")
        self.S = len(content) + 1
        order = np.argsort(content, kind="stable")
        taxid = rec["taxid"].astype(np.int64)
        at = np.searchsorted(content[order], taxid)
        if np.any(content[order][np.minimum(at, len(content) - 1)] != taxid):
            raise ValueError("an index taxid is not in the content file")
        rows = torch.from_numpy(order[at] + 1).to(dev)
        del rec
        self.n = n
        self.k_low, self.k_high = k_low, k_high
        self.levels = [Level(k, self.words, rows, self.S, self.highest_k)
                       for k in range(k_high, k_low - 1, -1)]
        self.device = dev

    @property
    def key_bytes(self) -> int:
        """Bytes of one key in kASA's record (u64 or u128)."""
        return 8 if self.highest_k <= 12 else 16

    def lower_bound(self, q: list) -> torch.Tensor:
        """First entry whose key is not below each query key (lex order
        over the words)."""
        w0 = self.words[0]
        pos = torch.searchsorted(w0, q[0])
        if len(self.words) == 1:
            return pos
        hi_all = torch.searchsorted(w0, q[0], right=True)
        sel = torch.nonzero(hi_all > pos).squeeze(1)
        if len(sel):
            lo, hi = pos[sel], hi_all[sel]
            qs = [x[sel] for x in q[1:]]
            for _ in range(int((hi - lo).max()).bit_length() + 1):
                act = lo < hi
                mid = (lo + hi) // 2
                less = _lex_less([w[mid.clamp(max=self.n - 1)]
                                  for w in self.words[1:]], qs)
                lo = torch.where(act & less, mid + 1, lo)
                hi = torch.where(act & ~less, mid, hi)
            pos[sel] = lo
        return pos

    def match(self, q: list, valid_len: torch.Tensor):
        """-> (gids (numK, M): each window's group at each k, -1 where it
        matches none; land (M,): the entry that the search lands on at
        the window's longest matched k, -1 for none)."""
        pos = self.lower_bound(q)
        e1 = pos.clamp(max=self.n - 1)
        e0 = (pos - 1).clamp(min=0)
        r1 = [w[e1] for w in self.words]
        r0 = [w[e0] for w in self.words]
        gids = torch.full((len(self.levels), len(pos)), -1,
                          dtype=torch.int64, device=pos.device)
        land = torch.full_like(pos, -1)
        for ki, lv in enumerate(self.levels):
            m1 = pos < self.n
            m0 = pos > 0
            for a, b, c, mk in zip(r1, r0, q, lv.masks):
                m1 &= (a & mk) == (c & mk)
                m0 &= (b & mk) == (c & mk)
            ok = (m1 | m0) & (valid_len >= lv.k)
            e = torch.where(m1, e1, e0)
            gids[ki] = torch.where(ok, lv.gid[e], -1)
            land = torch.where(ok & (land < 0), e, land)
        return gids, land


def batch_lines(mates: list, six: bool):
    """A batch's lines, as (seq blob, offs, read of each line): under
    --six each read line's reverse complement comes first, then the
    line; a pair's mates follow each other."""
    comp = np.zeros(256, np.uint8)
    comp[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)
    R = len(mates[0][1]) - 1
    blobs, lens, reads = [], [], []
    for r in range(R):
        for blob, offs in mates:
            s = blob[offs[r]:offs[r + 1]]
            if six:
                blobs.append(comp[s[::-1]])
                lens.append(len(s))
                reads.append(r)
            blobs.append(s)
            lens.append(len(s))
            reads.append(r)
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return np.concatenate(blobs), offs, np.asarray(reads, np.int64)


# letters of windows built at once (int64: 512 MiB)
CHUNK_LETTERS = 1 << 26


def windows(blob: np.ndarray, offs: np.ndarray, line_read: np.ndarray,
            highest_k: int, k_low: int, unique: bool, device):
    """Every window of every line that can match at k_low, in chunks of
    whole reads -> yields (words, valid_len, read) of each chunk."""
    dev = torch.device(device)
    lut = torch.from_numpy(base_index()).to(dev)
    lens = np.diff(offs)
    n_lines = len(lens)
    line = 0
    while line < n_lines:
        width = int(lens[line:].max()) + 3 * highest_k + 2
        per = max(1, CHUNK_LETTERS // (width * highest_k))
        end = min(n_lines, line + per)
        # keep a read's lines together (dedup is per read)
        while end < n_lines and line_read[end] == line_read[end - 1]:
            end += 1
        L = lens[line:end]
        width = int(L.max()) + 3 * highest_k + 2
        mat = np.full((end - line, width), ord("X"), np.uint8)
        rr = np.repeat(np.arange(end - line), L)
        cc = np.arange(int(L.sum())) - np.repeat(np.cumsum(L) - L, L)
        mat[rr, cc] = blob[offs[line]:offs[end]]
        codes = triplet_codes(lut[torch.from_numpy(mat).to(dev).long()])
        n_win = int(L.max()) - 3 * k_low + 1
        let = window_letters(codes, max(n_win, 0), highest_k)
        keep = (torch.arange(max(n_win, 0), device=dev)[None, :]
                <= torch.from_numpy(L - 3 * k_low).to(dev)[:, None])
        let = let[keep]
        read = torch.from_numpy(line_read[line:end]).to(dev)[:, None] \
            .expand(keep.shape)[keep]
        valid = torch.cumprod((let < 30).to(torch.int64), 1).sum(1)
        words = pack_words(let, highest_k)
        if unique:
            perm = torch.arange(len(read), device=dev)
            for w in reversed(words + [read]):
                perm = perm[torch.argsort(w[perm], stable=True)]
            words = [w[perm] for w in words]
            read, valid = read[perm], valid[perm]
            dup = read[1:] == read[:-1]
            for w in words:
                dup &= w[1:] == w[:-1]
            first = torch.ones(len(read), dtype=torch.bool, device=dev)
            first[1:] = ~dup
            words = [w[first] for w in words]
            read, valid = read[first], valid[first]
        yield words, valid, read
        line = end


def taxa_sectors(level: Level, gids: torch.Tensor) -> int:
    """Distinct 32-byte sectors of the taxa (4 bytes each, in the
    level's pair table, group by group) of the groups `gids` match:
    what a scorer reads to give each taxon of a group its share."""
    g = torch.unique(gids)
    if not len(g):
        return 0
    first = level.pstart[g] * 4 // 32
    last = (level.pstart[g + 1] * 4 - 1) // 32
    # groups lie in order, so two can share only the sector where one
    # ends and the next starts
    shared = int((first[1:] == last[:-1]).sum())
    return int((last - first + 1).sum()) - shared


class BatchHits:
    """What one batch of reads matches: per k, the group of every
    matched window and the read it belongs to; the distinct key sectors
    that the searches land on, and the distinct sectors of the matched
    groups' taxa."""

    def __init__(self, index: Index, mates: list, six: bool, unique: bool):
        blob, offs, line_read = batch_lines(mates, six)
        self.num_reads = len(mates[0][1]) - 1
        numK = len(index.levels)
        gid_parts = [[] for _ in range(numK)]
        read_parts = [[] for _ in range(numK)]
        sectors = []
        for words, valid, read in windows(blob, offs, line_read,
                                          index.highest_k, index.k_low,
                                          unique, index.device):
            gids, land = index.match(words, valid)
            for ki in range(numK):
                ok = gids[ki] >= 0
                gid_parts[ki].append(gids[ki][ok])
                read_parts[ki].append(read[ok])
            sectors.append(torch.unique(land[land >= 0]
                                        * index.key_bytes // 32))
        self.gid = [torch.cat(p) for p in gid_parts]
        self.read = [torch.cat(p) for p in read_parts]
        self.key_sectors = int(torch.unique(torch.cat(sectors)).numel())
        self.taxa_sectors = sum(taxa_sectors(lv, g)
                                for lv, g in zip(index.levels, self.gid))

    def group_hits(self, index: Index) -> list:
        """Per k, the number of windows that matched each group."""
        return [torch.bincount(g, minlength=lv.num_groups)
                for g, lv in zip(self.gid, index.levels)]


def profile_of(index: Index, hits: list, dtype=torch.float64):
    """Per-k group hit counts -> (counts_all (numK, S), counts_unique
    (numK, S) int64)."""
    numK = len(index.levels)
    ca = torch.zeros((numK, index.S), dtype=dtype, device=index.device)
    cu = torch.zeros((numK, index.S), dtype=torch.int64, device=index.device)
    for ki, (h, lv) in enumerate(zip(hits, index.levels)):
        hp = h[lv.pair_gid]
        ca[ki].index_add_(0, lv.pair_row,
                          (hp.to(torch.float64) / lv.T[lv.pair_gid])
                          .to(dtype))
        one = lv.T[lv.pair_gid] == 1
        cu[ki].index_add_(0, lv.pair_row[one], hp[one])
    return ca, cu


def read_scores(index: Index, bh: BatchHits, reads: np.ndarray,
                dtype=torch.float64) -> torch.Tensor:
    """(len(reads), S) scores of the batch's reads `reads`."""
    dev = index.device
    slot = torch.full((bh.num_reads,), -1, dtype=torch.int64, device=dev)
    slot[torch.from_numpy(np.asarray(reads, np.int64)).to(dev)] = \
        torch.arange(len(reads), device=dev)
    score = torch.zeros(len(reads) * index.S, dtype=dtype, device=dev)
    for g, r, lv in zip(bh.gid, bh.read, index.levels):
        s = slot[r]
        g, s = g[s >= 0], s[s >= 0]
        T = lv.T[g]
        start = lv.pstart[g]
        rep = torch.repeat_interleave(torch.arange(len(g), device=dev), T)
        within = torch.arange(len(rep), device=dev) \
            - torch.repeat_interleave(torch.cumsum(T, 0) - T, T)
        tax = lv.pair_row[start[rep] + within]
        add = (weight(lv.k) / T[rep].to(torch.float64)).to(dtype)
        score.index_add_(0, s[rep] * index.S + tax, add)
    return score.view(len(reads), index.S)


def answers_of(scores: torch.Tensor) -> list:
    """Score rows -> per read (taxa rows ascending, their scores as
    float64), the taxa with a score above 0."""
    out = []
    sc = scores.to(torch.float64).cpu().numpy()
    for row in sc:
        t = np.nonzero(row > 0)[0]
        out.append((t.astype(np.int64), row[t]))
    return out
