"""Profile CSV writer (the CompareWithLib tail, Compare.hpp:3466-3700;
doubles via C++ default operator<<, 6 significant digits).  Per-read
output text comes from native/writer.cpp (NativeRanker)."""

from __future__ import annotations

import numpy as np

from .dtoa import cpp_default


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
