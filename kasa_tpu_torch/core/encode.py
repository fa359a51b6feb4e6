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

Sloppy mode (-j) folds the 12 letters of a 64-bit window into 6 through
a 1,024-entry pair LUT (``sloppy_reduce``, K1's sloppy arm after the
window encode).  ``Encoder`` encodes the flat line buffers of the
per-batch engine (match/pipeline.py) through K1, or its plain version
on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kmer
from ._aas_table import AAS_OOB_TAIL, AAS_TABLE
from .alphabet import build_codon_code_lut

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


def aas_code_lut() -> np.ndarray:
    """1024-entry LUT of the sloppy pair reduction: index (code1 << 5) |
    code2, value the reduced 5-bit code.  Entries 900..1023 reproduce the
    reference binary's reads past its int8_t[900] table
    (_aas_table.AAS_OOB_TAIL)."""
    lut = np.zeros(1024, dtype=np.int32)
    for i, ch in enumerate(AAS_TABLE):
        lut[i] = ord(ch) & 31
    for i, b in enumerate(AAS_OOB_TAIL):
        lut[900 + i] = b & 31
    return lut


def sloppy_reduce_plain(limbs: torch.Tensor,
                        aas_lut: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1's sloppy arm (kasa_tpu
    core/encode.py:103 sloppy_reduce, aminoAcidsToAminoAcid,
    kASA.hpp:147-157): (M, 2) int32 windows of 12 letters -> (M, 2), the
    letter pairs (0,1), (2,3), ... joined through the pair LUT into the
    six letters of limb 0, limb 1 = 0."""
    if limbs.dim() != 2 or limbs.shape[1] != 2:
        raise ValueError("sloppy reduction takes (M, 2) windows of 12 "
                         "letters (highestK 12)")
    out0 = torch.zeros(limbs.shape[0], dtype=torch.int32,
                       device=limbs.device)
    for pair in range(6):
        ia, ja = divmod(2 * pair, LPL)
        ib, jb = divmod(2 * pair + 1, LPL)
        ca = (limbs[:, ia] >> (BITS * (LPL - 1 - ja))) & 31
        cb = (limbs[:, ib] >> (BITS * (LPL - 1 - jb))) & 31
        red = aas_lut[((ca << 5) | cb).long()]
        out0 |= red << (BITS * (LPL - 1 - pair))
    return torch.stack([out0, torch.zeros_like(out0)], dim=1)


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
           protein: bool, one_frame: bool, highest_k: int,
           aas_lut: torch.Tensor | None = None) -> None:
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
    if aas_lut is not None:
        if highest_k != 12:
            raise ValueError("-j folds windows of 12 letters: a 64-bit "
                             "index (highestK 12) only")
        if aas_lut.dtype != torch.int32 or tuple(aas_lut.shape) != (1024,):
            raise ValueError("aas_lut must be a (1024,) int32 tensor")


def encode_windows_plain(byte_mat: torch.Tensor, lut: torch.Tensor, w: int,
                         protein: bool = False, one_frame: bool = False,
                         highest_k: int = 12,
                         aas_lut: torch.Tensor | None = None) -> torch.Tensor:
    """(rows, maxlen) uint8 -> (rows * w, L) int32 limbs of the first w
    windows of every row, L = kmer.num_limbs(highest_k) limbs of
    kmer.limb_letters(highest_k) letters (two full limbs at highestK =
    12, five at 25 with one letter in the last).  DNA: letters at stride
    3 through the LUT, triplet hashes past the LUT clamped to its last
    entry as a gather does in kasa_tpu; one frame keeps windows 0, 3,
    6, ...; protein: letter = byte & 31 at stride 1 (the LUT unused).
    With aas_lut (-j) the windows are folded by sloppy_reduce_plain."""
    _check(byte_mat, lut, w, protein, one_frame, highest_k, aas_lut)
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
    out = torch.stack(limbs, dim=-1).reshape(rows * w, len(letters))
    return out if aas_lut is None else sloppy_reduce_plain(out, aas_lut)


def encode_windows(byte_mat: torch.Tensor, lut: torch.Tensor, w: int,
                   protein: bool = False, one_frame: bool = False,
                   highest_k: int = 12,
                   aas_lut: torch.Tensor | None = None) -> torch.Tensor:
    """K1 wrapper: the CUDA kernel on a CUDA tensor, else the plain
    version.  aas_lut (-j) selects the sloppy arm."""
    if byte_mat.device.type == "cpu":
        return encode_windows_plain(byte_mat, lut, w, protein, one_frame,
                                    highest_k, aas_lut)
    _check(byte_mat, lut, w, protein, one_frame, highest_k, aas_lut)
    from .. import kernels
    return kernels.encode_windows(byte_mat, lut, w, protein, one_frame,
                                  highest_k, aas_lut)


class Encoder:
    """Flat-buffer encoder of the per-batch engine and the index build
    (kasa_tpu core/encode.py:203): a line buffer -> its (W, L) windows,
    through K1 on `device` (a CUDA device) or its plain version (the
    CPU), with the sloppy fold under -j.  Returns host numpy arrays."""

    def __init__(self, codon_code_lut: np.ndarray | None = None,
                 sloppy: bool = False, device=None):
        self.device = torch.device("cpu" if device is None else device)
        self.sloppy = sloppy
        lut = np.asarray(codon_code_lut if codon_code_lut is not None
                         else build_codon_code_lut(), dtype=np.int32)
        self.lut = torch.from_numpy(lut).to(self.device)
        self.aas_lut = (torch.from_numpy(aas_code_lut()).to(self.device)
                        if sloppy else None)

    def _encode(self, buf: np.ndarray, highest_k: int, protein: bool,
                reduce: bool | None) -> np.ndarray:
        red = self.sloppy if reduce is None else reduce
        span = highest_k if protein else 3 * highest_k
        w = len(buf) - span + 1
        if w <= 0:
            return np.zeros((0, 2 if red else kmer.num_limbs(highest_k)),
                            np.int32)
        mat = torch.from_numpy(np.ascontiguousarray(buf, np.uint8)
                               .reshape(1, -1)).to(self.device)
        win = encode_windows(mat, self.lut, w, protein, False, highest_k,
                             self.aas_lut if red else None)
        return win.cpu().numpy()

    def encode_dna_buffer(self, buf: np.ndarray, highest_k: int,
                          reduce: bool | None = None) -> np.ndarray:
        """Sanitized DNA bytes -> (len - 3 * highestK + 1, L) windows
        (all three frames); `reduce=False` skips the sloppy fold."""
        return self._encode(buf, highest_k, False, reduce)

    def encode_protein_buffer(self, buf: np.ndarray, highest_k: int,
                              reduce: bool | None = None) -> np.ndarray:
        return self._encode(buf, highest_k, True, reduce)

    def reduce_windows(self, limbs: np.ndarray) -> np.ndarray:
        """The sloppy fold of already-encoded (M, 2) windows, on the host
        encoder of the index build (its window scan runs on the CPU)."""
        if self.device.type != "cpu":
            raise ValueError("reduce_windows: the build's encoder runs on "
                             "the CPU")
        win = torch.from_numpy(np.ascontiguousarray(limbs, np.int32))
        return sloppy_reduce_plain(win, torch.from_numpy(aas_code_lut()))\
            .numpy()
