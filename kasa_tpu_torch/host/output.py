"""Profile CSV writer (the CompareWithLib tail, Compare.hpp:3466-3700;
doubles via C++ default operator<<, 6 significant digits) and the
per-read ranking and writer of the per-batch engine (ports of kasa_tpu's
match/score.py rank_read and host/output.py ReadResultWriter:
scoringFunc, Compare.hpp:1452-1890, floats via host/dtoa.py).  The
fused engines' per-read text comes from native/writer.cpp
(NativeRanker), byte-identical to this writer."""

from __future__ import annotations

import math

import numpy as np

from .dtoa import cpp_default, dtoa, ftoa

_U64 = 1 << 64
_U32 = 1 << 32


def calculate_best_score(read_len: int, min_k: int, max_k: int,
                         protein: bool, num_frames: int) -> np.float32:
    """calculateBestScore (Compare.hpp:1452-1480): float32 accumulation
    over i = minK..maxK; the (len - 3i + 1) term is size_t arithmetic
    and wraps for short reads."""
    from ..match.join import weight
    best = np.float32(0)
    for i in range(min_k, max_k + 1):
        w = weight(i)
        if protein:
            n = (read_len - i + 1) % _U64
        elif num_frames == 1:
            n = (read_len // 3 - i + 1) % _U64
        elif num_frames == 6:
            n = (2 * ((read_len - i * 3 + 1) % _U64)) % _U64
        else:
            n = (read_len - i * 3 + 1) % _U64
        # C: (size_t)n * (float)w -> float32 multiply of float32(n)
        best = np.float32(best + np.float32(np.float32(n) * w))
    return best


def relative_score(kmer_score: np.float32, read_len: int, freq_max_k: int,
                   highest_k: int, protein: bool) -> float:
    """Compare.hpp:1506-1511.  The length term is uint32 arithmetic
    (wraps for reads shorter than 3*highestK-1) converted to double."""
    if protein:
        term = (read_len - highest_k + 1) % _U32
    else:
        term = (read_len - highest_k * 3 + 1) % _U32
    x = freq_max_k * float(term)
    if x > 0:
        denom = 1.0 + math.log2(x)
    elif x == 0:
        denom = float("-inf")  # C log2(0) = -inf -> relScore = -0.0
    else:
        denom = float("nan")
    return float(kmer_score) / denom


class ReadHits:
    """Threshold-filtered, ranked hits of one read."""

    __slots__ = ("spec_idx", "kmer_scores", "rel_scores", "top_hit_count", "best_score")

    def __init__(self, spec_idx, kmer_scores, rel_scores, top_hit_count, best_score):
        self.spec_idx = spec_idx
        self.kmer_scores = kmer_scores
        self.rel_scores = rel_scores
        self.top_hit_count = top_hit_count
        self.best_score = best_score


def rank_read(score_row: np.ndarray, read_len: int, freqs_max_k: np.ndarray,
              min_k: int, max_k: int, highest_k: int, protein: bool,
              num_frames: int, threshold: float, num_of_beasts: int) -> ReadHits:
    """score_row: (S,) float32 (index 0 unused).  freqs_max_k: (S,)
    frequency at the user's maxK per species row."""
    best = calculate_best_score(read_len, min_k, max_k, protein, num_frames)
    hit_idx = np.nonzero(score_row[1:] > 0.0)[0] + 1
    spec, ksc, rsc = [], [], []
    for i in hit_idx:
        k = score_row[i]
        r = relative_score(k, read_len, int(freqs_max_k[i]), highest_k, protein)
        if r >= threshold:
            spec.append(int(i))
            ksc.append(np.float32(k))
            rsc.append(r)
    if not spec:
        return ReadHits([], [], [], 0, best)
    order = sorted(range(len(spec)), key=lambda j: -rsc[j])
    spec = [spec[j] for j in order]
    ksc = [ksc[j] for j in order]
    rsc = [rsc[j] for j in order]
    max_k_score = max(ksc)
    top = 1
    for i in range(1, len(spec)):
        if i >= num_of_beasts:
            break
        if np.float32(ksc[i]) / np.float32(max_k_score) > np.float32(0.8):
            top += 1
        else:
            break
    return ReadHits(spec, ksc, rsc, top, best)


class ReadResultWriter:
    """Streams per-read results in one of the four formats."""

    def __init__(self, fh, fmt: str, num_of_beasts: int = 3, coherence: bool = False):
        self.fh = fh
        self.fmt = fmt
        self.beasts = num_of_beasts
        self.coherence = coherence
        if fmt == "json":
            fh.write("[\n")
        elif fmt == "tsv":
            if coherence:
                fh.write("#Read number\tSpecifier from input file\tMatched taxa\tNames\tScores{relative,k-mer}\tError\tCoherence\n")
            else:
                fh.write("#Read number\tSpecifier from input file\tMatched taxa\tNames\tScores{relative,k-mer}\tError\n")

    def close(self):
        if self.fmt == "json":
            self.fh.write("\n]")

    # ------------------------------------------------------------------
    def write_read(self, read_num: int, name: str, length: int, hits: ReadHits,
                   idx_to_tax: list, organisms: list, coherence_val: float = 0.0):
        w = self.fh.write
        fmt = self.fmt
        if not hits.spec_idx:
            if fmt == "tsv":
                w(f"{read_num}\t{name}\t-\t-\t-\t-")
                if self.coherence:
                    w("\t-")
                w("\n")
            elif fmt == "json":
                w("{\n" if read_num == 0 else ",\n{\n")
                w(f'\t"Read number": {read_num},\n\t"Specifier from input file": "{name}",\n\t"Length": {length},\n\t"Top hits": [\n\t],\n\t"Further hits": [\n\t]\n}}')
            elif fmt == "jsonl":
                w(f'{{ "Read number": {read_num}, "Specifier from input file": "{name}", "Length": {length}, "Top hits": [], "Further hits": [] }}\n')
            else:  # kraken
                # reference quirk: the unclassified row's length goes
                # through BufferedWriter::operator+=(char), so it is
                # emitted as the raw byte length%256 (Compare.hpp:1568)
                w(f"U\t{name}\t0\t{chr(length & 0xFF)}\tA:00\n")
            return

        best = hits.best_score
        spec, ksc, rsc = hits.spec_idx, hits.kmer_scores, hits.rel_scores
        top = hits.top_hit_count
        n = len(spec)

        def err(i):
            # (bestScore - score) / bestScore in FLOAT arithmetic
            # (Compare.hpp:1634/1710), then printed as double
            return dtoa(float(np.float32(best - ksc[i]) / np.float32(best)))

        if fmt == "tsv":
            s1 = [str(read_num), name]
            taxa, names, scores, errors = [], [], [], []
            j = 0
            val_before = np.float32(0)
            i = 0
            while i < n and j < self.beasts:
                taxa.append(str(idx_to_tax[spec[i]]))
                names.append(organisms[spec[i]])
                scores.append(dtoa(rsc[i]) + "," + ftoa(ksc[i]))
                errors.append(err(i))
                if val_before != ksc[i]:
                    val_before = ksc[i]
                    j += 1
                i += 1
            if names:
                w(str(read_num) + "\t" + name + "\t" + ";".join(taxa) + "\t"
                  + ";".join(names) + "\t" + ";".join(scores) + "\t" + ";".join(errors))
                if self.coherence:
                    w("\t" + dtoa(coherence_val))
                w("\n")
            return

        if fmt in ("json", "jsonl"):
            pretty = fmt == "json"
            if pretty:
                w("{\n" if read_num == 0 else ",\n{\n")
                w(f'\t"Read number": {read_num},\n\t"Specifier from input file": "{name}",\n\t"Length": {length},\n\t"Top hits": [\n')
            else:
                w(f'{{ "Read number": {read_num}, "Specifier from input file": "{name}", "Length": {length}, "Top hits": [')

            def emit_hit(i, first, pretty, top_section):
                if pretty:
                    w("\t{\n" if first else ",\n\t{\n")
                    w(f'\t\t"tax ID": "{idx_to_tax[spec[i]]}",\n')
                    w(f'\t\t"Name": "{organisms[spec[i]]}",\n')
                    w(f'\t\t"k-mer Score": {ftoa(ksc[i])},\n')
                    w(f'\t\t"Relative Score": {dtoa(rsc[i])},\n')
                    w(f'\t\t"Error": {err(i)}')
                    if self.coherence:
                        w(f',\n\t\t"Coherence": {dtoa(coherence_val)}')
                    w("\n\t}")
                else:
                    # reference quirk: further-hit jsonl separator is ", {"
                    if first:
                        w("{")
                    else:
                        w(",{" if top_section else ", {")
                    w(f' "tax ID": "{idx_to_tax[spec[i]]}",')
                    w(f' "Name": "{organisms[spec[i]]}",')
                    w(f' "k-mer Score": {ftoa(ksc[i])},')
                    w(f' "Relative Score": {dtoa(rsc[i])},')
                    w(f' "Error": {err(i)}')
                    if self.coherence:
                        w(f',"Coherence": {dtoa(coherence_val)}')
                    w("}")

            it = 0
            for i in range(top):
                emit_hit(it, i == 0, pretty, True)
                it += 1
            if pretty:
                w('\n\t],\n\t"Further hits": [\n')
            else:
                w('], "Further hits": [')
            j = top
            val_before = np.float32(0)
            first_further = True
            while it < n and j < self.beasts:
                emit_hit(it, first_further, pretty, False)
                first_further = False
                if val_before != ksc[it]:
                    val_before = ksc[it]
                    j += 1
                it += 1
            if pretty:
                w("\n\t]\n}")
            else:
                w("] }\n")
            return

        # kraken
        w(f"C\t{name}\t{idx_to_tax[spec[0]]}\t{length}\t")
        it = 0
        for i in range(top):
            w(f"{idx_to_tax[spec[it]]}:{ftoa(ksc[it])} ")
            it += 1
        j = top
        val_before = np.float32(0)
        while it < n and j < self.beasts:
            w(f"{idx_to_tax[spec[it]]}:{ftoa(ksc[it])} ")
            if val_before != ksc[it]:
                val_before = ksc[it]
                j += 1
            it += 1
        w("\n")




def file_ending(fmt: str) -> str:
    """Per-read output suffix of a format (identify on a folder)."""
    return {"kraken": ".ktsv", "json": ".json", "jsonl": ".jsonl",
            "tsv": ".tsv"}[fmt]


def write_profile(
    path: str,
    organisms: list,
    idx_to_tax: list,
    counts_all: np.ndarray,      # (numK, S) float64
    counts_unique: np.ndarray,   # (numK, S) uint64
    counts_total: np.ndarray,    # (numK, S) uint64 (coverage) or None
    frequencies: np.ndarray,     # (S, numK) per-species freq at k=maxK..minK
    num_kmers_in_input: int,
    num_reads: int,
    min_k: int,
    max_k: int,
    num_frames: int,
    coverage: bool = False,
):
    """Profile CSV (Compare.hpp:3466-3665)."""
    num_k = max_k - min_k + 1
    S = counts_all.shape[1]

    # per-taxon tuples in species-row order, then sort by unique counts
    # (vector compare, k = maxK first), ties keep row order (stable).
    rows = []
    for s in range(1, S):
        uniq = tuple(int(counts_unique[ki, s]) for ki in range(num_k))
        rows.append((s, uniq))
    rows.sort(key=lambda r: tuple(-u for u in r[1]))

    sum_unique = counts_unique.sum(axis=1)           # per k
    sum_nonunique = counts_all.sum(axis=1)           # per k (double)

    frame_mult = num_frames
    garbage = np.zeros(num_k, dtype=np.uint64)
    # Compare.hpp:3499-3503: garbage[j] = reads * frames * (maxK-minK-j)
    for j, i in enumerate(range(max_k - min_k, 0, -1)):
        garbage[j] = np.uint64(num_reads) * np.uint64(frame_mult) * np.uint64(i)

    with open(path, "w") as fh:
        fh.write("#taxID,Name")
        for label in ("Unique counts", "Unique rel. freq.", "Non-unique counts",
                      "Non-unique rel. freq.", "Overall rel. freq.",
                      "Overall unique rel. freq."):
            for ki in range(num_k):
                fh.write(f",{label} k={max_k - ki}")
        if coverage:
            for label in ("Special Counts", "Genome Coverage"):
                for ki in range(num_k):
                    fh.write(f",{label} k={max_k - ki}")
        fh.write("\n")

        body = []
        sum_identified = np.zeros(num_k)
        sum_unique_identified = np.zeros(num_k)
        for s, _uniq in rows:
            if counts_all[num_k - 1, s] > 0:
                parts = [str(idx_to_tax[s]), organisms[s].replace(",", " ")]
                for ki in range(num_k):
                    parts.append(str(int(counts_unique[ki, s])))
                for ki in range(num_k):
                    u = int(counts_unique[ki, s])
                    parts.append("0" if u == 0 else cpp_default(u / float(sum_unique[ki])))
                for ki in range(num_k):
                    parts.append(cpp_default(float(counts_all[ki, s])))
                for ki in range(num_k):
                    c = float(counts_all[ki, s])
                    parts.append("0" if c == 0 else cpp_default(c / sum_nonunique[ki]))
                for ki in range(num_k):
                    sum_identified[ki] += float(counts_all[ki, s])
                    parts.append(cpp_default(
                        float(counts_all[ki, s]) / (num_kmers_in_input - int(garbage[ki]))))
                for ki in range(num_k):
                    sum_unique_identified[ki] += int(counts_unique[ki, s])
                    parts.append(cpp_default(
                        int(counts_unique[ki, s]) / (num_kmers_in_input - int(garbage[ki]))))
                if coverage:
                    for ki in range(num_k):
                        parts.append(str(int(counts_total[ki, s])))
                    for ki in range(num_k):
                        parts.append(cpp_default(
                            int(counts_total[ki, s]) / float(frequencies[s, ki])))
                body.append(",".join(parts))

        # "not identified" first row
        fh.write("0,not identified")
        for _ in range(num_k * 4):
            fh.write(",0")
        for ki in range(num_k):
            denom = float(num_kmers_in_input) - float(garbage[ki])
            fh.write("," + cpp_default(
                (float(num_kmers_in_input) - float(garbage[ki]) - sum_identified[ki]) / denom))
        for ki in range(num_k):
            denom = float(num_kmers_in_input) - float(garbage[ki])
            fh.write("," + cpp_default(
                (float(num_kmers_in_input) - float(garbage[ki]) - sum_unique_identified[ki]) / denom))
        if coverage:
            for _ in range(num_k * 2):
                fh.write(",0")
        fh.write("\n")
        for line in body:
            fh.write(line + "\n")
