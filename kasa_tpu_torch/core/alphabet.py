"""DNA -> amino-acid-like alphabet for kASA-compatible encoding.

The reference hashes a DNA triplet (c1,c2,c3) to an index
``((c1&14)<<5) | ((c2&14)<<2) | ((c3&14)>>1)`` into a 366-entry
letter table (reference: source/kASA.hpp:69-87, 621-667).  Letters are
ASCII in ['@'..'_']; the 5-bit code of a letter is ``char & 31``.

We *generate* that table from the standard genetic code plus kASA's
conventions instead of copying it:

  * any triplet containing 'Z' (the sanitizer's stand-in for a non-ACGT
    character)                         -> '_'  (code 31, "illegal", kills k-mers)
  * else any triplet containing 'X'    -> '^'  (code 30, "unknown")
  * stop codons TAA/TAG                -> '['  (code 27)
  * special stop TGA                   -> ']'  (code 29)
  * otherwise the standard genetic code letter.

Verified letter-for-letter against the reference table in
tests/test_alphabet.py.
"""

from __future__ import annotations

import numpy as np

# 5-bit letter codes
CODE_UNKNOWN = 30   # '^'  — from 'X' in DNA; suffix padding marker
CODE_ILLEGAL = 31   # '_'  — from 'Z' (sanitized non-ACGT); poisons k-mers at build
CODE_STOP = 27      # '['
CODE_STOP_TGA = 29  # ']'

# Standard genetic code, with kASA's stop-codon letters.
_GENETIC_CODE = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "[", "TAG": "[",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "]", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}

_BASES = "ACTGXZ"


def triplet_index(c1: int, c2: int, c3: int) -> int:
    """Reference's triplet hash (kASA.hpp:75)."""
    return ((c1 & 14) << 5) | ((c2 & 14) << 2) | ((c3 & 14) >> 1)


def codon_letter(codon: str) -> str:
    if "Z" in codon:
        return "_"
    if "X" in codon:
        return "^"
    return _GENETIC_CODE[codon]


def build_codon_lut() -> np.ndarray:
    """366-entry uint8 LUT: triplet hash -> AA letter (ASCII).

    Unreachable slots hold ' ' like the reference (kASA.hpp:628).
    """
    lut = np.full(366, ord(" "), dtype=np.uint8)
    for a in _BASES:
        for b in _BASES:
            for c in _BASES:
                lut[triplet_index(ord(a), ord(b), ord(c))] = ord(codon_letter(a + b + c))
    return lut


def build_codon_code_lut() -> np.ndarray:
    """366-entry uint8 LUT: triplet hash -> 5-bit letter code (char & 31)."""
    return build_codon_lut() & np.uint8(31)


def apply_custom_codon_table(lut: np.ndarray, gc_prt_path: str, table_id: str) -> np.ndarray:
    """Overwrite `lut` (ASCII letters) from an NCBI gc.prt codon table.

    Mirrors kASA::setCodonTable (kASA.hpp:579-615): finds the block with
    ``  id <table_id> ,``, then reads the ncbieaa line and the three base
    lines; '*' maps to '['.
    """
    lut = lut.copy()
    with open(gc_prt_path, "r") as fh:
        lines = fh.read().splitlines()
    found = -1
    for i, line in enumerate(lines):
        if f"  id {table_id} ," in line:
            found = i
            break
    if found < 0:
        import sys

        print("WARNING: codon table not found in file. Using built-in.", file=sys.stderr)
        return lut
    amino_acids = lines[found + 1]
    base1, base2, base3 = lines[found + 3], lines[found + 4], lines[found + 5]
    pos_aa = amino_acids.find('"') + 1
    pos_b = min(
        (p for p in (base1.find(ch) for ch in "TGCA") if p >= 0), default=len(base1)
    )
    while pos_b < len(base1):
        letter = amino_acids[pos_aa]
        lut[triplet_index(ord(base1[pos_b]), ord(base2[pos_b]), ord(base3[pos_b]))] = ord(
            "[" if letter == "*" else letter
        )
        pos_b += 1
        pos_aa += 1
    return lut


def build_revcomp_lut() -> np.ndarray:
    """256-entry uint8 LUT for reverse complement of *sanitized* DNA.

    Reference indexes a 6-entry table with ``(c>>1)&7``
    (kASA.hpp:54, 214-221): A<->T, C<->G, X->X, Z->Z (case-folded).
    """
    small = np.frombuffer(b"TGACXZ", dtype=np.uint8)
    lut = np.zeros(256, dtype=np.uint8)
    for c in b"ACTGXZactgxz":
        lut[c] = small[(c >> 1) & 7]
    return lut


def build_sanitize_lut(protein: bool = False) -> np.ndarray:
    """256-entry uint8 LUT replicating searchAndReplaceLettersOfRead
    (reference: Read.hpp:657-675): DNA keeps ACGTacgt, everything else
    becomes 'Z'; protein maps '*' -> '[' and keeps the rest."""
    lut = np.arange(256, dtype=np.uint8)
    if protein:
        lut[ord("*")] = ord("[")
    else:
        keep = set(b"ACGTacgt")
        for c in range(256):
            if c not in keep:
                lut[c] = ord("Z")
    return lut


def is_dna_like(seq: str) -> bool:
    """Alphabet auto-detection (reference: kASA.hpp:161-183)."""
    dna = set("ACGTURYKMSWBDHVN-")
    up = seq.upper()
    return len(up) > 0 and all(c in dna for c in up)


def aa_string_to_codes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("ascii"), dtype=np.uint8) & np.uint8(31)


def codes_to_aa_string(codes) -> str:
    """5-bit codes -> AA letters (code | 64, reference kASA.hpp:383-396)."""
    arr = (np.asarray(codes, dtype=np.uint8) & 31) | 64
    return arr.tobytes().decode("ascii")
