"""Sequence -> k-mer window encoding (port of kasa_tpu/core/encode.py).

A DNA window of 3*highestK characters at every start offset is
translated triplet-wise to the AA-like alphabet and packed into int32
limbs of six 5-bit letters (Read.hpp:84-220):

  1. ``aa[p] = LUT[hash(S[p], S[p+1], S[p+2])]`` for every position p,
  2. window w, letter j  ->  ``aa[w + 3*j]``.

The batch encoder works on a padded (rows, maxlen) read matrix: the
first W = maxlen - 3*highestK + 1 windows of a row never read past the
row's end (the last triplet of window W-1 ends at maxlen-1), so each
row encodes on its own.  ``encode_windows`` is the wrapper of kernel K1
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


def dna_to_aa_codes_np(buf: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """uint8 DNA buffer -> int32 5-bit AA codes per position (the last
    two positions read wrapped bytes and must be masked by the caller)."""
    b = buf.astype(np.int32)
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


def _check(byte_mat: torch.Tensor, lut: torch.Tensor, w: int) -> None:
    if byte_mat.dtype != torch.uint8 or byte_mat.dim() != 2:
        raise ValueError("byte_mat must be a (rows, maxlen) uint8 tensor")
    if lut.dtype != torch.int32 or lut.dim() != 1:
        raise ValueError("lut must be a 1-d int32 tensor")
    if not 1 <= w <= byte_mat.shape[1] - 36 + 1:
        raise ValueError(f"w={w} windows do not fit rows of "
                         f"{byte_mat.shape[1]} characters")


def encode_windows_plain(byte_mat: torch.Tensor, lut: torch.Tensor,
                         w: int) -> torch.Tensor:
    """(rows, maxlen) uint8 DNA -> (rows * w, 2) int32 limbs of the first
    w windows of every row (highestK = 12, letter stride 3).  Triplet
    hashes past the LUT clamp to its last entry, as a gather does in
    kasa_tpu."""
    _check(byte_mat, lut, w)
    rows = byte_mat.shape[0]
    b = byte_mat.to(torch.int32)
    idx = ((b[:, :-2] & 14) << 5) | ((b[:, 1:-1] & 14) << 2) \
        | ((b[:, 2:] & 14) >> 1)
    aa = lut[idx.clamp(max=lut.numel() - 1).long()]
    limbs = []
    for li in range(2):
        acc = torch.zeros((rows, w), dtype=torch.int32, device=b.device)
        for j in range(LPL):
            p = 3 * (LPL * li + j)
            acc |= aa[:, p:p + w] << (BITS * (LPL - 1 - j))
        limbs.append(acc)
    return torch.stack(limbs, dim=-1).reshape(rows * w, 2)


def encode_windows(byte_mat: torch.Tensor, lut: torch.Tensor,
                   w: int) -> torch.Tensor:
    """K1 wrapper: the CUDA kernel on a CUDA tensor, else the plain
    version."""
    if byte_mat.device.type == "cpu":
        return encode_windows_plain(byte_mat, lut, w)
    _check(byte_mat, lut, w)
    from .. import kernels
    return kernels.encode_windows(byte_mat, lut, w)
