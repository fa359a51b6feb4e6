"""ctypes bindings for the host C++ code (loader.cpp, writer.cpp,
sortidx.cpp, buildenc.cpp): fastx parsing, sanitizing, the dense and
sparse rank+format writers, the (key, tax) record sort and its
duplicate drop, the byte size of the reference's taxid map (the
per-batch engine's memory ledger), and the index build's window scan,
key unpacking and frequency count.

The shared library is built lazily with g++ on first use into
``kasa_tpu_torch/_build/`` (listed in .gitignore).  The build writes a
temporary file and renames it, so concurrent processes never load a
half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_SRCS = [os.path.join(_DIR, f) for f in ("loader.cpp", "writer.cpp",
                                          "sortidx.cpp", "buildenc.cpp")]
_SO = os.path.join(_BUILD, "libkasa_host.so")
_lib = None
_tried = False


def _build() -> bool:
    # -ffp-contract=off: the score/error arithmetic must round exactly
    # like the Python float32 path (no FMA fusion), or formatted floats
    # drift by an ulp
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-shared",
           "-fPIC", "-std=c++17", *_SRCS, "-o", tmp, "-lz", "-lpthread"]
    try:
        ok = subprocess.run(cmd, capture_output=True).returncode == 0
    except OSError:
        return False
    if ok:
        os.replace(tmp, _SO)
    return ok


def get_lib():
    """The loaded library, building it on first call; None if g++ or
    zlib is unavailable (callers raise: the port has no pure-Python
    parse or rank path)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < max(os.path.getmtime(s)
                                               for s in _SRCS)):
            if not _build():
                return None
        lib = ctypes.CDLL(_SO)
        lib.kasa_load_fastx.restype = ctypes.c_void_p
        lib.kasa_load_fastx.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.kasa_fill.restype = None
        lib.kasa_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
        lib.kasa_release.argtypes = [ctypes.c_void_p]
        lib.kasa_sanitize.restype = ctypes.c_int64
        lib.kasa_sanitize.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int]
        lib.kasa_sort_kmer_tax.restype = None
        lib.kasa_sort_kmer_tax.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int]
        lib.kasa_unpack_keys.restype = None
        lib.kasa_unpack_keys.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int]
        lib.kasa_sort_kmer_tax_dedup.restype = None
        lib.kasa_sort_kmer_tax_dedup.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64)]
        lib.kasa_encode_dna.restype = ctypes.c_int64
        lib.kasa_encode_dna.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.kasa_frequencies.restype = None
        lib.kasa_frequencies.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int]
        lib.kasa_umap_bytes.restype = ctypes.c_int64
        lib.kasa_umap_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.kasa_rank_format.restype = ctypes.c_void_p
        lib.kasa_rank_format.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]   # scores R S
            + [ctypes.c_void_p] * 2                             # names
            + [ctypes.c_void_p] * 2                             # lengths coh
            + [ctypes.c_void_p] * 4                             # tax org
            + [ctypes.c_void_p]                                 # freqs
            + [ctypes.c_int64] + [ctypes.c_int] * 5             # nums
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
            + [ctypes.POINTER(ctypes.c_int64)])
        lib.kasa_rank_format_sparse.restype = ctypes.c_void_p
        lib.kasa_rank_format_sparse.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64]
            + [ctypes.c_void_p] * 2                             # names
            + [ctypes.c_void_p] * 2                             # lengths coh
            + [ctypes.c_void_p] * 4                             # tax org
            + [ctypes.c_void_p]                                 # freqs
            + [ctypes.c_int64] + [ctypes.c_int] * 5             # nums
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
            + [ctypes.POINTER(ctypes.c_int64)])
        lib.kasa_buf_ptr.restype = ctypes.c_void_p
        lib.kasa_buf_ptr.argtypes = [ctypes.c_void_p]
        lib.kasa_buf_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def load_fastx(path: str, is_fastq: bool):
    """Parse a fasta/fastq(.gz) file natively.

    Returns (seq, seq_off, names, name_off, nlines) numpy arrays or
    None when the native library is unavailable or IO failed."""
    lib = get_lib()
    if lib is None:
        return None
    n = ctypes.c_int64()
    sb = ctypes.c_int64()
    nb = ctypes.c_int64()
    handle = lib.kasa_load_fastx(path.encode(), int(path.endswith(".gz")),
                                 int(is_fastq), ctypes.byref(n),
                                 ctypes.byref(sb), ctypes.byref(nb))
    if not handle:
        return None
    try:
        seq = np.empty(sb.value, np.uint8)
        seq_off = np.empty(n.value + 1, np.int64)
        names = np.empty(nb.value, np.uint8)
        name_off = np.empty(n.value + 1, np.int64)
        nlines = np.empty(n.value, np.int32)
        lib.kasa_fill(handle,
                      seq.ctypes.data_as(ctypes.c_void_p),
                      seq_off.ctypes.data_as(ctypes.c_void_p),
                      names.ctypes.data_as(ctypes.c_void_p),
                      name_off.ctypes.data_as(ctypes.c_void_p),
                      nlines.ctypes.data_as(ctypes.c_void_p))
    finally:
        lib.kasa_release(handle)
    return seq, seq_off, names, name_off, nlines


_FMT_CODE = {"json": 0, "jsonl": 1, "tsv": 2, "kraken": 3}


def _vp(a):
    return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None


def _blob(strings) -> tuple[np.ndarray, np.ndarray]:
    bs = [s.encode("latin-1") for s in strings]
    off = np.zeros(len(bs) + 1, np.int64)
    if bs:
        np.cumsum([len(b) for b in bs], out=off[1:])
    cat = b"".join(bs)
    return np.frombuffer(cat, np.uint8).copy() if cat else np.zeros(0, np.uint8), off


class NativeRanker:
    """Batch rank+format through writer.cpp, from dense (R, S) score rows
    (.format, the classic engine) or per-read compact hit lists
    (.format_sparse, the turbo engine).  Construct once per identify run
    (tax/organism blobs are cached)."""

    def __init__(self, idx_to_tax, organisms, freqs_max_k, min_k, max_k,
                 highest_k, protein, num_frames, threshold, num_beasts,
                 fmt, coherence_on=False, filter_on=False,
                 error_threshold=0.5, coherence_threshold=11.0):
        self.lib = get_lib()
        self.ok = self.lib is not None
        if not self.ok:
            return
        self.tax_blob, self.tax_off = _blob([str(t) for t in idx_to_tax])
        self.org_blob, self.org_off = _blob(organisms)
        self.freqs = np.ascontiguousarray(freqs_max_k, dtype=np.float64)
        self.params = (min_k, max_k, highest_k, int(protein), num_frames)
        self.threshold = float(threshold)
        self.num_beasts = int(num_beasts)
        self.fmt = _FMT_CODE[fmt]
        self.coherence_on = int(coherence_on)
        self.filter_on = int(filter_on)
        self.error_threshold = float(error_threshold)
        self.coherence_threshold = float(coherence_threshold)

    def _text(self, h, out_len) -> bytes:
        try:
            return ctypes.string_at(self.lib.kasa_buf_ptr(h), out_len.value)
        finally:
            self.lib.kasa_buf_free(h)

    def format(self, scores: np.ndarray, names: list, lengths,
               read_num_start: int):
        """-> (formatted bytes, filtered mask (R,) uint8 | None) from (R, S)
        float32 score rows (kasa_rank_format)."""
        scores = np.ascontiguousarray(scores, dtype=np.float32)
        R = scores.shape[0]
        name_blob, name_off = _blob(names)
        lengths = np.ascontiguousarray(lengths, dtype=np.uint32)
        filtered = np.zeros(R, np.uint8) if self.filter_on else None
        out_len = ctypes.c_int64()
        h = self.lib.kasa_rank_format(
            _vp(scores), R, scores.shape[1],
            _vp(name_blob), _vp(name_off), _vp(lengths), None,
            _vp(self.tax_blob), _vp(self.tax_off),
            _vp(self.org_blob), _vp(self.org_off), _vp(self.freqs),
            read_num_start, *self.params,
            ctypes.c_float(self.threshold), self.num_beasts, self.fmt,
            self.coherence_on, self.filter_on,
            ctypes.c_float(self.error_threshold),
            ctypes.c_float(self.coherence_threshold), _vp(filtered),
            ctypes.byref(out_len))
        return self._text(h, out_len), filtered

    def format_sparse(self, hit_tax: np.ndarray, hit_ksc: np.ndarray,
                      hit_cnt: np.ndarray, names: list, lengths,
                      read_num_start: int):
        """-> (formatted bytes, filtered mask (R,) uint8 | None).
        hit_tax/hit_ksc are (R, W) with hit_cnt[r] valid entries in
        ascending species order (kasa_rank_format_sparse)."""
        hit_tax = np.ascontiguousarray(hit_tax, dtype=np.int32)
        hit_ksc = np.ascontiguousarray(hit_ksc, dtype=np.float32)
        hit_cnt = np.ascontiguousarray(hit_cnt, dtype=np.int32)
        R, W = hit_tax.shape
        name_blob, name_off = _blob(names)
        lengths = np.ascontiguousarray(lengths, dtype=np.uint32)
        filtered = np.zeros(R, np.uint8) if self.filter_on else None
        out_len = ctypes.c_int64()
        h = self.lib.kasa_rank_format_sparse(
            _vp(hit_tax), _vp(hit_ksc), _vp(hit_cnt), R, W,
            _vp(name_blob), _vp(name_off), _vp(lengths), None,
            _vp(self.tax_blob), _vp(self.tax_off),
            _vp(self.org_blob), _vp(self.org_off), _vp(self.freqs),
            read_num_start, *self.params,
            ctypes.c_float(self.threshold), self.num_beasts, self.fmt,
            self.coherence_on, self.filter_on,
            ctypes.c_float(self.error_threshold),
            ctypes.c_float(self.coherence_threshold), _vp(filtered),
            ctypes.byref(out_len))
        return self._text(h, out_len), filtered


def sanitize_inplace(seq: np.ndarray, protein: bool) -> int | None:
    """In-place native sanitize; returns whitespace count or None."""
    lib = get_lib()
    if lib is None or not seq.flags.c_contiguous:
        return None
    return int(lib.kasa_sanitize(seq.ctypes.data_as(ctypes.c_void_p),
                                 len(seq), int(protein)))


def sort_kmer_tax(keys: np.ndarray, tax: np.ndarray, key_bits: int = 60,
                  nthreads: int = 2) -> bool:
    """In-place native (key, tax) lexicographic sort (sortidx.cpp).
    Returns False (arrays untouched) when the native lib is missing or
    the dtypes/layout do not match."""
    lib = get_lib()
    if (lib is None or keys.dtype != np.uint64 or tax.dtype != np.uint32
            or not keys.flags.c_contiguous or not tax.flags.c_contiguous
            or len(keys) != len(tax)):
        return False
    lib.kasa_sort_kmer_tax(
        len(keys), keys.ctypes.data_as(ctypes.c_void_p),
        tax.ctypes.data_as(ctypes.c_void_p), int(key_bits),
        max(int(nthreads), 1))
    return True


def umap_bytes(keys) -> int:
    """Byte size of the reference's taxid -> row unordered_map
    (Utilities.hpp:1028-1040) through libstdc++."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native host library (g++ and zlib) is "
                           "unavailable")
    arr = np.ascontiguousarray(keys, dtype=np.uint32)
    return int(lib.kasa_umap_bytes(arr.ctypes.data_as(ctypes.c_void_p),
                                   len(arr)))


def _need_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native host library (g++ and zlib) is "
                           "unavailable")
    return lib


def encode_dna_keys(seq: np.ndarray, lut: np.ndarray, highest_k: int,
                    frames: int = 3) -> np.ndarray:
    """The build's window scan (buildenc.cpp, the reference's dnaTokMers):
    sanitized bytes with the marker appended -> packed u64 keys of all
    VALID windows, frame-major."""
    lib = _need_lib()
    seq = np.ascontiguousarray(seq, np.uint8)
    lut = np.ascontiguousarray(lut, np.int32)
    w = len(seq) - 3 * highest_k + 1
    if w <= 0:
        return np.zeros(0, np.uint64)
    out = np.empty(w, np.uint64)
    n = lib.kasa_encode_dna(_vp(seq), len(seq), _vp(lut), highest_k, frames,
                            _vp(out))
    return out[:n]


def frequencies_native(keys: np.ndarray, rows: np.ndarray, num_cols: int,
                       S: int, nthreads: int = 2) -> np.ndarray:
    """The GetFrequencyK counting pass over packed keys: (S, num_cols)
    uint64 counts of valid letters per content row."""
    lib = _need_lib()
    keys = np.ascontiguousarray(keys, np.uint64)
    rows = np.ascontiguousarray(rows, np.int32)
    freq = np.zeros((S, num_cols), np.uint64)
    # each worker owns a private (S, num_cols) u64 accumulator; cap the
    # thread count so the combined footprint stays ~<= 1 GiB
    per_thread = max(int(S) * int(num_cols) * 8, 1)
    nthreads = max(1, min(int(nthreads), (1 << 30) // per_thread))
    lib.kasa_frequencies(_vp(keys), _vp(rows), len(keys), num_cols, S,
                         _vp(freq), nthreads)
    return freq


def unpack_keys(keys: np.ndarray, nthreads: int = 2) -> np.ndarray:
    """u64 packed keys -> (n, 2) int32 limbs."""
    lib = _need_lib()
    keys = np.ascontiguousarray(keys, np.uint64)
    out = np.empty((len(keys), 2), np.int32)
    lib.kasa_unpack_keys(_vp(keys), len(keys), _vp(out),
                         max(int(nthreads), 1))
    return out


def sort_dedup_kmer_tax(keys: np.ndarray, tax: np.ndarray,
                        key_bits: int = 60, nthreads: int = 2) -> int:
    """In-place (key, tax) sort of u64 keys and u32 taxids and the drop of
    exact duplicates (sortidx.cpp); returns the count kept, the valid
    prefix of both arrays."""
    lib = _need_lib()
    if (keys.dtype != np.uint64 or tax.dtype != np.uint32
            or not keys.flags.c_contiguous or not tax.flags.c_contiguous
            or len(keys) != len(tax)):
        raise ValueError("sort_dedup_kmer_tax: contiguous uint64 keys and "
                         "uint32 taxids of one length")
    out_n = ctypes.c_int64(len(keys))
    lib.kasa_sort_kmer_tax_dedup(len(keys), _vp(keys), _vp(tax),
                                 int(key_bits), max(int(nthreads), 1),
                                 ctypes.byref(out_n))
    return int(out_n.value)
