"""Sequence -> k-mer window encoding (port of kasa_tpu/core/encode.py).

A DNA window of 3*highestK characters at every start offset is
translated triplet-wise to the AA-like alphabet and packed into int32
limbs of six 5-bit letters (Read.hpp:84-220):

  1. ``aa[p] = LUT[hash(S[p], S[p+1], S[p+2])]`` for every position p,
  2. window w, letter j  ->  ``aa[w + 3*j]``.

Protein input (-z) skips step 1: a letter is the byte itself (code =
byte & 31) and window w takes ``byte[w + j]``.  One frame (--one) keeps
every third DNA window (window c starts at byte 3c).

The batch encoder works on a padded (rows, maxlen) read matrix: the
first W windows of a row never read past the row's end (DNA: W =
maxlen - 3*highestK + 1, the last triplet of window W-1 ends at
maxlen-1; protein: W = maxlen - highestK + 1; one frame: W = maxlen//3 -
highestK + 1, window W-1 ends at 3*(maxlen//3) - 1), so each row encodes
on its own.  A window is ``kmer.num_limbs(highestK)`` limbs: two at
highestK = 12 (64-bit indices), five at 25 (128-bit indices).  ``encode_windows`` is the wrapper of kernel K1
(csrc/encode.cu); ``encode_windows_plain`` is its plain PyTorch version.
The numpy twins serve the host recompute of flagged reads.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kmer
from .alphabet import build_codon_code_lut  # noqa: F401  (re-export)

BITS = kmer.BITS_PER_LETTER
LPL = kmer.LETTERS_PER_LIMB


def dna_to_aa_codes_np(buf: np.ndarray, lut: np.ndarray,
                       protein: bool = False) -> np.ndarray:
    """uint8 DNA buffer -> int32 5-bit AA codes per position (the last
    two positions read wrapped bytes and must be masked by the caller);
    protein letters are the bytes themselves."""
    b = buf.astype(np.int32)
    if protein:
        return b & 31
    c1 = b
    c2 = np.roll(b, -1)
    c3 = np.roll(b, -2)
    idx = ((c1 & 14) << 5) | ((c2 & 14) << 2) | ((c3 & 14) >> 1)
    return lut[idx]


def encode_windows_np(aa_codes: np.ndarray, highest_k: int,
                      letter_stride: int) -> np.ndarray:
    """AA code array (N,) -> (W, L) int32 limbs of all windows."""
    aa_codes = np.asarray(aa_codes, dtype=np.int32)
    n = aa_codes.shape[0]
    w = n - letter_stride * highest_k + 1
    if w <= 0:
        return np.zeros((0, kmer.num_limbs(highest_k)), dtype=np.int32)
    limbs = []
    pos = 0
    for nlet in kmer.limb_letters(highest_k):
        acc = np.zeros((w,), dtype=np.int32)
        for j in range(nlet):
            start = (pos + j) * letter_stride
            acc = acc | (aa_codes[start:start + w] << (BITS * (LPL - 1 - j)))
        limbs.append(acc)
        pos += nlet
    return np.stack(limbs, axis=-1)


def custom_code_lut(cfg) -> np.ndarray | None:
    """-a <gc.prt> <id>: the code-space LUT of a custom codon table, or
    None for the default alphabet (setCodonTable, kASA.hpp:579-615)."""
    if not getattr(cfg, "codon_table", ""):
        return None
    from .alphabet import apply_custom_codon_table, build_codon_lut
    lut = apply_custom_codon_table(build_codon_lut(), cfg.codon_table,
                                   cfg.codon_id)
    return (lut & np.uint8(31)).astype(np.uint8)


def window_span(protein: bool, one_frame: bool,
                highest_k: int) -> tuple[int, int]:
    """(bytes one window covers, bytes between window starts)."""
    if protein:
        return highest_k, 1
    return 3 * highest_k, (3 if one_frame else 1)


def _check(byte_mat: torch.Tensor, lut: torch.Tensor, w: int,
           protein: bool, one_frame: bool, highest_k: int) -> None:
    if byte_mat.dtype != torch.uint8 or byte_mat.dim() != 2:
        raise ValueError("byte_mat must be a (rows, maxlen) uint8 tensor")
    if lut.dtype != torch.int32 or lut.dim() != 1:
        raise ValueError("lut must be a 1-d int32 tensor")
    if not 1 <= highest_k <= 25:
        raise ValueError(f"highest_k={highest_k}: k-mers hold 1..25 letters")
    span, step = window_span(protein, one_frame, highest_k)
    if w < 1 or (w - 1) * step + span > byte_mat.shape[1]:
        raise ValueError(f"w={w} windows do not fit rows of "
                         f"{byte_mat.shape[1]} characters")


def encode_windows_plain(byte_mat: torch.Tensor, lut: torch.Tensor, w: int,
                         protein: bool = False, one_frame: bool = False,
                         highest_k: int = 12) -> torch.Tensor:
    """(rows, maxlen) uint8 -> (rows * w, L) int32 limbs of the first w
    windows of every row, L = kmer.num_limbs(highest_k) limbs of
    kmer.limb_letters(highest_k) letters (two full limbs at highestK =
    12, five at 25 with one letter in the last).  DNA: letters at stride
    3 through the LUT, triplet hashes past the LUT clamped to its last
    entry as a gather does in kasa_tpu; one frame keeps windows 0, 3,
    6, ...; protein: letter = byte & 31 at stride 1 (the LUT unused)."""
    _check(byte_mat, lut, w, protein, one_frame, highest_k)
    rows = byte_mat.shape[0]
    b = byte_mat.to(torch.int32)
    if protein:
        aa, stride = b & 31, 1
    else:
        idx = ((b[:, :-2] & 14) << 5) | ((b[:, 1:-1] & 14) << 2) \
            | ((b[:, 2:] & 14) >> 1)
        aa, stride = lut[idx.clamp(max=lut.numel() - 1).long()], 3
    step = 3 if one_frame and not protein else 1
    n = (w - 1) * step + 1          # window starts 0 .. (w-1)*step
    letters = kmer.limb_letters(highest_k)
    limbs = []
    for li, nlet in enumerate(letters):
        acc = torch.zeros((rows, n), dtype=torch.int32, device=b.device)
        for j in range(nlet):
            p = stride * (LPL * li + j)
            acc |= aa[:, p:p + n] << (BITS * (LPL - 1 - j))
        limbs.append(acc[:, ::step])
    return torch.stack(limbs, dim=-1).reshape(rows * w, len(letters))


def encode_windows(byte_mat: torch.Tensor, lut: torch.Tensor, w: int,
                   protein: bool = False, one_frame: bool = False,
                   highest_k: int = 12) -> torch.Tensor:
    """K1 wrapper: the CUDA kernel on a CUDA tensor, else the plain
    version."""
    if byte_mat.device.type == "cpu":
        return encode_windows_plain(byte_mat, lut, w, protein, one_frame,
                                    highest_k)
    _check(byte_mat, lut, w, protein, one_frame, highest_k)
    from .. import kernels
    return kernels.encode_windows(byte_mat, lut, w, protein, one_frame,
                                  highest_k)
