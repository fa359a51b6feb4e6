"""DNA reconstruction from the 3-frame AA-like translation.

Algorithmic proof (reference scripts/reconstructDNA.py, paper
supplement) that the rolling 3-frame translation kASA indexes is
lossless: every position p of the DNA constrains the triplet
S[p..p+2] to the codon preimage of its AA letter, and consecutive
triplets overlap by two characters, so a left-to-right backtracking
walk recovers the original sequence.

Unlike the reference script (hard-coded default alphabet), this works
for any codon table via core.alphabet, including custom `-a` tables.
"""

from __future__ import annotations

from ..core.alphabet import codon_letter


def letter_to_codons(lut=None) -> dict[str, list[str]]:
    """AA letter -> list of codons, from the (possibly custom) LUT."""
    del lut
    inv: dict[str, list[str]] = {}
    for c1 in "ACGT":
        for c2 in "ACGT":
            for c3 in "ACGT":
                codon = c1 + c2 + c3
                inv.setdefault(codon_letter(codon), []).append(codon)
    return inv


def translate_frames(dna: str) -> list[str]:
    """Rolling 3-frame translation: frame f holds the letters at
    positions p with p % 3 == f (reference scripts/reconstructDNA.py
    builds the same three strings round-robin)."""
    frames = ["", "", ""]
    for p in range(len(dna) - 2):
        frames[p % 3] += codon_letter(dna[p:p + 3])
    return frames


def reconstruct(frames: list[str]) -> str | None:
    """Interleave the frames back into the per-position letter sequence
    and solve the overlap constraints by backtracking; returns the DNA
    or None if the letters are inconsistent."""
    inv = letter_to_codons()
    letters: list[str] = []
    i = 0
    while True:
        f = i % 3
        j = i // 3
        if j >= len(frames[f]):
            break
        letters.append(frames[f][j])
        i += 1
    n = len(letters)
    if n == 0:
        return None

    def solve(pos: int, prefix: str) -> str | None:
        if pos == n:
            return prefix
        for codon in inv.get(letters[pos], ()):
            if pos > 0 and codon[:2] != prefix[-2:]:
                continue
            result = solve(pos + 1, prefix + codon if pos == 0 else prefix + codon[2])
            if result is not None:
                return result
        return None

    return solve(0, "")


def reconstruct_dna(dna: str, scramble: bool = False) -> str | None:
    """CLI behavior of scripts/reconstructDNA.py: translate, optionally
    sort the frames (demonstrating order independence), reconstruct and
    print the alignment."""
    frames = translate_frames(dna)
    print("Frame 1:", frames[0], "Frame 2:", frames[1], "Frame 3:", frames[2])
    if scramble:
        print("scramble on")
        frames = sorted(frames)
        print("Frame 1:", frames[0], "Frame 2:", frames[1], "Frame 3:", frames[2])
        # recover the true interleave order: frame 1 is the longest (or
        # tied-longest) -- try all permutations until one reconstructs
        import itertools
        for perm in itertools.permutations(frames):
            if list(map(len, perm)) == sorted(map(len, perm), reverse=True):
                result = reconstruct(list(perm))
                if result == dna:
                    frames = list(perm)
                    break
    result = reconstruct(frames)
    if result is None or len(result) != len(dna):
        print("error, wrong order!", result or "")
        return None
    print(dna)
    print("".join("|" if a == b else " " for a, b in zip(dna, result)))
    print(result)
    return result
