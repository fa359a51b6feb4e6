"""Build, bind and launch the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc for sm_90a into its own shared library
with a plain C interface (no PyTorch headers: seconds per file), all
sources at once in parallel, on first use, into ``kasa_tpu_torch/_build``
(listed in .gitignore).  ctypes binds the launchers; pointers come from
``tensor.data_ptr()`` and the stream from PyTorch's current stream.

Every wrapper checks dtype, shape, contiguity and device, allocates its
outputs and scratch with torch.empty/torch.zeros, launches, adds one to
its launch count, and raises if the launcher reports a CUDA error.
Nothing here synchronises.  Nothing here runs on the CPU: the callers
(core/encode.py, match/turbo.py, match/tiered.py, match/device.py,
match/join.py, index/build.py) take the plain PyTorch versions for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD = os.path.join(_DIR, "_build", "cuda")
SOURCES = ("encode", "turbo_match", "turbo_reads", "turbo_multi", "dedup",
           "sparse_fold", "tiered_route", "tiered_pass", "classic_classify",
           "join_match", "join_scatter", "query_sort", "sort_dedup",
           "mesh_merge")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches per kernel since the last reset_counts(): one per wrapper
# call that launched (turbo_reads counts its pre and post entry points;
# the long arms of K3 pre and K5 count apart, as "turbo_reads.long_smem"
# (shared memory), "turbo_reads.long" (global),
# "dedup.long" (shared memory) and "dedup.global"; K4 split for the mesh
# counts its cut as "turbo_multi" and its expansion as
# "turbo_multi.split"; K14's long arm as "mesh_merge.long"; K8's prefix
# tables as "tiered_pass.prefix"; K9's global arm as
# "classic_classify.global"; K7's global arm as "tiered_route.global")
COUNTS = {"encode": 0, "turbo_match": 0, "turbo_reads": 0,
          "turbo_reads.long": 0, "turbo_reads.long_smem": 0,
          "turbo_multi": 0, "turbo_multi.split": 0,
          "dedup": 0, "dedup.long": 0, "dedup.global": 0, "sparse_fold": 0,
          "tiered_route": 0, "tiered_route.global": 0, "tiered_pass": 0,
          "tiered_pass.prefix": 0,
          "classic_classify": 0, "classic_classify.global": 0,
          "join_match": 0, "join_scatter": 0, "query_sort": 0,
          "sort_dedup": 0, "mesh_merge": 0, "mesh_merge.long": 0}

_libs: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_MULTI = [_P] * 8 + [_I] * 8 + [_L, _I, _I] + [_P] * 14
_ARGTYPES = {
    "kasa_encode_windows": [_P, _P] + [_I] * 7 + [_P, _P, _P],
    "kasa_turbo_match": [_P] * 6 + [_L] + [_I] * 7 + [_P, _P, _P],
    "kasa_turbo_reads_pre": [_P, _P] + [_I] * 4 + [_P] * 7,
    "kasa_turbo_reads_pre_hist": [_P, _P] + [_I] * 5 + [_P] * 7,
    "kasa_turbo_reads_hist_max": [_I],
    "kasa_turbo_reads_pre_long": [_P, _P] + [_I] * 4 + [_P] * 9,
    "kasa_turbo_reads_post": [_P] * 13 + [_I] * 9 + [_L] + [_P] * 9,
    "kasa_turbo_multi": _MULTI,
    "kasa_turbo_multi_cut": _MULTI,
    "kasa_turbo_multi_expand": _MULTI,
    "kasa_dedup_windows": [_P] + [_I] * 5 + [_P, _P],
    "kasa_dedup_windows_long": [_P] + [_I] * 4 + [_P] * 2,
    "kasa_dedup_windows_global": [_P] + [_I] * 4 + [_P] * 3,
    "kasa_dedup_long_max_kpr": [_I, _I],
    "kasa_sparse_fold": [_P] * 6 + [_I] * 6 + [_P] * 5,
    "kasa_tiered_route": [_P, _P, _L, _I, _I, _I, _I] + [_P] * 6,
    "kasa_tiered_route_global_plan": [_L, _I, _P],
    "kasa_tiered_route_global": [_P, _P, _L, _I, _I, _I] + [_P] * 6,
    "kasa_tiered_pass": [_P] * 11 + [_L, _L] + [_I] * 11 + [_P] * 5,
    "kasa_tiered_prefix": [_P, _I, _P, _P],
    "kasa_classic_classify": [_P] * 11 + [_L] * 4 + [_I] * 10 + [_P] * 6,
    "kasa_classic_smem_budget": [_I],
    "kasa_join_match": [_P] * 7 + [_L] * 3 + [_I] * 4 + [_P] * 6,
    "kasa_join_scatter": [_P] * 6 + [_L] * 2 + [_I] * 2 + [_P] * 2,
    "kasa_query_sort": [_P] * 7 + [_L, _I, _I, _P, _P],
    "kasa_query_sort_plan": [_L, _I, _I, _P],
    "kasa_sort_dedup": [_P] * 7 + [_L, _I] + [_P] * 4,
    "kasa_sort_dedup_plan": [_L, _I, _P],
    "kasa_mesh_merge": [_P] * 4 + [_I] * 4 + [_L] + [_P] * 7,
}
_LIB_OF = {"kasa_encode_windows": "encode",
           "kasa_turbo_match": "turbo_match",
           "kasa_turbo_reads_pre": "turbo_reads",
           "kasa_turbo_reads_pre_hist": "turbo_reads",
           "kasa_turbo_reads_hist_max": "turbo_reads",
           "kasa_turbo_reads_pre_long": "turbo_reads",
           "kasa_turbo_reads_post": "turbo_reads",
           "kasa_turbo_multi": "turbo_multi",
           "kasa_turbo_multi_cut": "turbo_multi",
           "kasa_turbo_multi_expand": "turbo_multi",
           "kasa_dedup_windows": "dedup",
           "kasa_dedup_windows_long": "dedup",
           "kasa_dedup_windows_global": "dedup",
           "kasa_dedup_long_max_kpr": "dedup",
           "kasa_sparse_fold": "sparse_fold",
           "kasa_tiered_route": "tiered_route",
           "kasa_tiered_route_global_plan": "tiered_route",
           "kasa_tiered_route_global": "tiered_route",
           "kasa_tiered_pass": "tiered_pass",
           "kasa_tiered_prefix": "tiered_pass",
           "kasa_classic_classify": "classic_classify",
           "kasa_classic_smem_budget": "classic_classify",
           "kasa_join_match": "join_match",
           "kasa_join_scatter": "join_scatter",
           "kasa_query_sort": "query_sort",
           "kasa_query_sort_plan": "query_sort",
           "kasa_sort_dedup": "sort_dedup",
           "kasa_sort_dedup_plan": "sort_dedup",
           "kasa_mesh_merge": "mesh_merge"}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from kasa_tpu_torch/csrc at first use")


def _so(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = _so(name)
    if not os.path.exists(so):
        return True
    srcs = [os.path.join(CSRC, f"{name}.cu")] + [
        os.path.join(CSRC, h) for h in os.listdir(CSRC) if h.endswith(".cuh")]
    return os.path.getmtime(so) < max(os.path.getmtime(s) for s in srcs)


def build_all(force: bool = False) -> dict:
    """Compile every stale kernel source, one nvcc per source, all
    started together.  Returns {name: ptxas report} of the sources
    built in this call; raises with nvcc's output if one fails."""
    todo = [s for s in SOURCES if force or _stale(s)]
    if not todo:
        return {}
    os.makedirs(BUILD, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = f"{_so(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    reports, failed = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu ---\n{out}")
            continue
        os.replace(tmp, _so(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def _fn(sym: str):
    name = _LIB_OF[sym]
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            build_all()
        lib = ctypes.CDLL(_so(name))
        for s, lname in _LIB_OF.items():
            if lname == name:
                f = getattr(lib, s)
                f.restype = ctypes.c_int
                f.argtypes = _ARGTYPES[s]
        _libs[name] = lib
    return getattr(lib, sym)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(sym: str, counter: str, *args) -> None:
    rc = _fn(sym)(*args)
    COUNTS[counter] += 1
    if rc != 0:
        raise RuntimeError(f"{sym}: CUDA error {rc}")


def _sort_plan(sym: str, *args) -> tuple[int, int]:
    """-> (digit passes, int32 words of scratch) of a radix sort, from
    the library's own digit width and tile (csrc/radix.cuh)."""
    words = ctypes.c_longlong(0)
    passes = _fn(sym)(*args, ctypes.byref(words))
    return passes, words.value


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _device_index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _ptr(t: torch.Tensor | None) -> int | None:
    """The tensor's device address; None (a null pointer) for an absent
    optional input or output."""
    return None if t is None else t.data_ptr()


def _marks(marks, n: int):
    """ctypes array of the cudaEvent_t handles of n torch.cuda.Events
    (each recorded once here so that it exists), or None."""
    if marks is None:
        return None
    if len(marks) != n:
        raise ValueError(f"{len(marks)} marks, expected {n}")
    for ev in marks:
        ev.record()
    return (ctypes.c_void_p * n)(*[ev.cuda_event for ev in marks])


# ---------------------------------------------------------------------------
# K1 encode (csrc/encode.cu)

def encode_windows(byte_mat: torch.Tensor, lut: torch.Tensor, w: int,
                   protein: bool = False, one_frame: bool = False,
                   highest_k: int = 12,
                   aas_lut: torch.Tensor | None = None) -> torch.Tensor:
    """aas_lut, (1024,) int32: the sloppy arm (highestK 12 only)."""
    from .core.kmer import num_limbs
    dev = byte_mat.device
    if dev.type != "cuda":
        raise ValueError("encode_windows: the kernel takes CUDA tensors")
    rows, maxlen = byte_mat.shape
    _check(byte_mat, "byte_mat", torch.uint8, (rows, maxlen), dev)
    _check(lut, "lut", torch.int32, (lut.numel(),), dev)
    if lut.numel() < 1:
        raise ValueError("lut: empty")
    # a window's offset in its row is a 32-bit int in the kernel (the
    # per-batch engine encodes a whole batch as one row)
    if max(w, maxlen) >= 1 << 31:
        raise ValueError(f"rows of {maxlen} bytes: the kernel takes rows "
                         "below 2^31 bytes")
    if aas_lut is not None:
        _check(aas_lut, "aas_lut", torch.int32, (1024,), dev)
        if highest_k != 12:
            raise ValueError("the sloppy arm folds windows of 12 letters")
    out = torch.empty((rows * w, num_limbs(highest_k)), dtype=torch.int32,
                      device=dev)
    step = 3 if one_frame and not protein else 1
    _launch("kasa_encode_windows", "encode", _ptr(byte_mat), _ptr(lut),
            lut.numel(), rows, maxlen, w, int(protein), step, highest_k,
            _ptr(aas_lut), _ptr(out), _stream(dev))
    return out


# ---------------------------------------------------------------------------
# K2 turbo_match (csrc/turbo_match.cu)

def _check_tables(tt, dev) -> None:
    n, nk, L = tt.n, tt.num_k, tt.keys2.shape[1]
    if not 2 <= L <= 5:
        raise ValueError(f"keys2: {L} limbs, the kernels take 2..5")
    _check(tt.keys2, "keys2", torch.int32, (n, L), dev)
    _check(tt.rowdat, "rowdat", torch.int32, (n, L + 2), dev)
    _check(tt.router, "router", torch.int32, (1 << 24, 2), dev)
    _check(tt.sub2, "sub2", torch.int32, (tt.sub2.shape[0], 2), dev)
    _check(tt.grp2, "grp2", torch.int32, (nk * n,), dev)
    _check(tt.d_tax4, "d_tax4", torch.int32, (tt.d_tax4.shape[0], 4), dev)
    _check(tt.weights, "weights", torch.float32, (nk,), dev)
    _check(tt.masks2, "masks2", torch.int32, (nk, L), dev)
    _check(tt.t_hot, "t_hot", torch.int32, (tt.hotmask.shape[0],), dev)


def turbo_match(q: torch.Tensor, tt, num_reads: int, kmers_per_read: int,
                sent: int):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("turbo_match: the kernel takes CUDA tensors")
    R, kpr, nk = num_reads, kmers_per_read, tt.num_k
    M = R * kpr
    _check_tables(tt, dev)
    L = tt.keys2.shape[1]
    _check(q, "q", torch.int32, (M, L), dev)
    skey = torch.empty((R, kpr * nk), dtype=torch.int32, device=dev)
    mpay = torch.empty((R, kpr * nk), dtype=torch.int32, device=dev)
    _launch("kasa_turbo_match", "turbo_match", _ptr(q), _ptr(tt.router),
            _ptr(tt.sub2), _ptr(tt.keys2), _ptr(tt.rowdat), _ptr(tt.masks2),
            M, L, tt.n, nk, tt.min_k, tt.max_k, tt.num_steps, sent,
            _ptr(skey), _ptr(mpay), _stream(dev))
    return skey, mpay


# ---------------------------------------------------------------------------
# K3 turbo_reads (csrc/turbo_reads.cu)

def _pow2(n: int) -> int:
    p = 32
    while p < n:
        p <<= 1
    return p


PRE_MARKS = 2
POST_MARKS = 4


def reads_hist_max(device: torch.device) -> int:
    """The widest key range K3 pre's shared-memory long arm takes on the
    card `device`: int32 counters in one block's opt-in shared memory
    (turbo_reads.cu kasa_turbo_reads_hist_max)."""
    n = _fn("kasa_turbo_reads_hist_max")(_device_index(device))
    if n < 0:
        raise RuntimeError(f"kasa_turbo_reads_hist_max: CUDA error {-n}")
    return n


def reads_pre_arm(SW: int, cw: int, key_range: int | None,
                  hist_max: int) -> str:
    """K3 pre's arm for rows of SW slot keys keeping cw runs: "short"
    (SW and cw at most SW_CAP: every row's keys in shared memory),
    "long_smem" (every real key below key_range, key_range at most
    hist_max: a histogram of the row's keys in shared memory,
    reads_hist_max) or "global" (segmented radix passes in global
    memory).  key_range is only read past SW_CAP, where it must be
    given."""
    from .match.turbo import SW_CAP
    if SW <= SW_CAP and cw <= SW_CAP:
        return "short"
    if key_range is None:
        raise ValueError(f"SW={SW}, cw={cw}: the long arms need the key "
                         "range")
    return "long_smem" if key_range <= hist_max else "global"


def turbo_reads_pre(skey: torch.Tensor, mpay: torch.Tensor | None,
                    sent: int, cw: int, key_range: int | None = None,
                    marks=None):
    """Without mpay (the tiered finish) no multi payloads are compacted:
    mcnt and cp come back None.  A batch with SW or cw above SW_CAP
    takes a long arm, picked from key_range (every real key lies in
    [0, key_range): 8 S for slot keys tax * 8 + k): up to
    reads_hist_max the shared-memory long arm ("turbo_reads.long_smem"),
    else the global arm ("turbo_reads.long"), which sorts the rows in two
    (R, SW) int32 scratch buffers.  marks: None, or PRE_MARKS
    torch.cuda.Events recorded around the arm's launches (chip_smoke.py
    times the stage with them)."""
    dev = skey.device
    if dev.type != "cuda":
        raise ValueError("turbo_reads_pre: the kernel takes CUDA tensors")
    R, SW = skey.shape
    if cw < 1:
        raise ValueError(f"cw={cw}: the kernel keeps at least one run")
    _check(skey, "skey", torch.int32, (R, SW), dev)
    i32 = dict(dtype=torch.int32, device=dev)
    mcnt = cp = None
    if mpay is not None:
        _check(mpay, "mpay", torch.int32, (R, SW), dev)
        mcnt = torch.empty((R,), **i32)
        cp = torch.empty((R, SW), **i32)
    ck = torch.empty((R, cw), **i32)
    cc = torch.empty((R, cw), **i32)
    runs = torch.empty((R,), **i32)
    hist_max = 0
    if reads_pre_arm(SW, cw, key_range, 0) != "short":
        hist_max = reads_hist_max(dev)
    arm = reads_pre_arm(SW, cw, key_range, hist_max)
    ev = _marks(marks, PRE_MARKS)
    if arm == "short":
        _launch("kasa_turbo_reads_pre", "turbo_reads", _ptr(skey),
                _ptr(mpay), R, SW, sent, cw, _ptr(ck), _ptr(cc), _ptr(runs),
                _ptr(mcnt), _ptr(cp), _stream(dev), ev)
    elif arm == "long_smem":
        _launch("kasa_turbo_reads_pre_hist", "turbo_reads.long_smem",
                _ptr(skey), _ptr(mpay), R, SW, key_range, sent, cw, _ptr(ck),
                _ptr(cc), _ptr(runs), _ptr(mcnt), _ptr(cp), _stream(dev), ev)
    else:
        scr = torch.empty((2, R, SW), **i32)
        _launch("kasa_turbo_reads_pre_long", "turbo_reads.long", _ptr(skey),
                _ptr(mpay), R, SW, sent, cw, _ptr(scr[0]), _ptr(scr[1]),
                _ptr(ck), _ptr(cc), _ptr(runs), _ptr(mcnt), _ptr(cp),
                _stream(dev), ev)
    return ck, cc, runs, mcnt, cp


def _check_files(file_of_read, acc_ca, R, nk, S, dev):
    """-> the (F, numK, S) or (numK, S) shape the count accumulators
    must have: F files when a (R,) int32 file_of_read map is given."""
    if file_of_read is None:
        return (nk, S)
    _check(file_of_read, "file_of_read", torch.int32, (R,), dev)
    return (acc_ca.shape[0] if acc_ca.dim() == 3 else -1, nk, S)


def turbo_reads_post(ck, cc, ofc, dm, weights, acc_ca, acc_cu, diag,
                     csr_cap: int, sent: int, wout: int, wm: int,
                     file_of_read=None, mlist=None, additive: bool = False,
                     cadd=None, marks=None):
    """Dense arm: the multi taxa from dm, the (R, S) score rows.  List
    arm (dm None): from mlist = (mk (R, wm) int32, mv (R, wm) f32,
    multi_of (R,) bool), K6's lists; S is the accumulators' last
    dimension in both arms.  Additive arm (the tiered finish): flagged
    reads keep their counts and scores, and cadd, (numK * S,) f32 multi
    counts, is added to acc_ca.  marks: None, or POST_MARKS
    torch.cuda.Events recorded before the post kernel and after it, the
    hit-count scan and the CSR scatter."""
    dev = ck.device
    if dev.type != "cuda":
        raise ValueError("turbo_reads_post: the kernel takes CUDA tensors")
    R, cw = ck.shape
    S = acc_ca.shape[-1]
    nk = weights.shape[0]
    _check(ck, "ck", torch.int32, (R, cw), dev)
    _check(cc, "cc", torch.int32, (R, cw), dev)
    _check(ofc, "ofc", torch.bool, (R,), dev)
    if dm is not None:
        _check(dm, "dm", torch.float32, (R, S), dev)
        mk = mv = mof = None
    else:
        mk, mv, mof = mlist
        _check(mk, "mk", torch.int32, (R, wm), dev)
        _check(mv, "mv", torch.float32, (R, wm), dev)
        _check(mof, "multi_of", torch.bool, (R,), dev)
    _check(weights, "weights", torch.float32, (nk,), dev)
    acc_shape = _check_files(file_of_read, acc_ca, R, nk, S, dev)
    _check(acc_ca, "acc_ca", torch.float32, acc_shape, dev)
    _check(acc_cu, "acc_cu", torch.int32, acc_shape, dev)
    _check(diag, "diag", torch.int32, (2,), dev)
    if cadd is not None:
        if file_of_read is not None:
            raise ValueError("cadd: the additive counts take (numK, S) "
                             "accumulators")
        _check(cadd, "cadd", torch.float32, (nk * S,), dev)
    i32 = dict(dtype=torch.int32, device=dev)
    ht = torch.empty((R, wout), **i32)
    hk = torch.empty((R, wout), dtype=torch.float32, device=dev)
    hc = torch.empty((R,), **i32)
    flags = torch.empty((R,), **i32)
    cum = torch.empty((R,), **i32)
    packed = torch.zeros((2 * R + 2 * csr_cap + 4,), **i32)
    # lists wider than the kernel's shared arrays (256) sit in a scratch
    # row of 2 * (wout + wm) + wm + 1 words per read (turbo_reads.cu
    # post_scratch_words)
    lscr = torch.empty((R, 2 * (wout + wm) + wm + 1), **i32) \
        if max(wout, wm) > 256 else None
    _launch("kasa_turbo_reads_post", "turbo_reads", _ptr(ck), _ptr(cc),
            _ptr(ofc), _ptr(dm), _ptr(mk), _ptr(mv), _ptr(mof), _ptr(weights),
            _ptr(file_of_read), _ptr(acc_ca), _ptr(acc_cu), _ptr(diag),
            _ptr(cadd), R, S, nk, cw, sent, wout, wm, int(additive),
            0 if cadd is None else nk * S, csr_cap, _ptr(lscr), _ptr(ht),
            _ptr(hk), _ptr(hc), _ptr(flags), _ptr(cum), _ptr(packed),
            _stream(dev), _marks(marks, POST_MARKS))
    return packed, ht, hk


# ---------------------------------------------------------------------------
# K4 turbo_multi (csrc/turbo_multi.cu)

MULTI_MARKS = 5


def turbo_multi(cp, mcnt, runs, tt, acc_ca, multi_budget: int,
                exp_budget: int, cw: int, sent: int, file_of_read=None,
                counts_only: bool = False, flag_reduce=None, marks=None):
    """counts_only (the sparse regime): no (R, S) score rows and no hot
    credits are allocated or written; dm, a3w and a3c come back None.
    flag_reduce (the mesh): the cut and the expansion launch apart, and
    the flags between them are replaced by flag_reduce(flags).  marks:
    None, or MULTI_MARKS torch.cuda.Events recorded before the four
    launches (scan, slots, cut, expand) and after each (chip_smoke.py
    times the stages with them; not with flag_reduce)."""
    dev = cp.device
    if dev.type != "cuda":
        raise ValueError("turbo_multi: the kernel takes CUDA tensors")
    R, SW = cp.shape
    S, nk = tt.num_species, tt.num_k
    H = tt.hotmask.shape[0]
    _check(cp, "cp", torch.int32, (R, SW), dev)
    _check(mcnt, "mcnt", torch.int32, (R,), dev)
    _check(runs, "runs", torch.int32, (R,), dev)
    acc_shape = _check_files(file_of_read, acc_ca, R, nk, S, dev)
    _check(acc_ca, "acc_ca", torch.float32, acc_shape, dev)
    _check_tables(tt, dev)
    F = acc_shape[0] if len(acc_shape) == 3 else 1
    B = min(int(multi_budget), R * SW)
    hist_n = S + 2
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    read_base = torch.empty((R,), **i32)
    wl = torch.empty((3, max(B, 1)), **i32)
    hist = torch.zeros((hist_n,), **i32)
    r_stats = torch.empty((4, R), **i32)
    ofc = torch.empty((R,), dtype=torch.bool, device=dev)
    diag = torch.zeros((2,), **i32)
    dm = a3w = a3c = None
    if not counts_only:
        # the expansion writes every score row and credit row whole
        dm = torch.empty((R, S), **f32)
        a3w = torch.empty((R, H), **f32)
        a3c = torch.zeros((F * nk, H), **f32)
    args = (_ptr(cp), _ptr(mcnt), _ptr(runs), _ptr(tt.grp2), _ptr(tt.d_tax4),
            _ptr(tt.t_hot), _ptr(tt.weights), _ptr(file_of_read),
            R, SW, tt.n, nk, S, H, tt.d_tax4.shape[0], B,
            int(exp_budget), cw, hist_n, _ptr(read_base), _ptr(wl[0]),
            _ptr(wl[1]), _ptr(wl[2]), _ptr(hist), _ptr(r_stats), _ptr(ofc),
            _ptr(diag), _ptr(acc_ca), _ptr(dm), _ptr(a3w), _ptr(a3c),
            _stream(dev))
    if flag_reduce is None:
        _launch("kasa_turbo_multi", "turbo_multi", *args,
                _marks(marks, MULTI_MARKS))
        return ofc, dm, a3w, a3c, diag
    if marks is not None:
        raise ValueError("marks: the split entry points are not timed")
    _launch("kasa_turbo_multi_cut", "turbo_multi", *args, None)
    ofc.copy_(flag_reduce(ofc))
    _launch("kasa_turbo_multi_expand", "turbo_multi.split", *args, None)
    return ofc, dm, a3w, a3c, diag


# ---------------------------------------------------------------------------
# K5 dedup (csrc/dedup.cu)

def dedup_long_max(L: int, device: torch.device) -> int:
    """The most windows a read may have for K5's shared-memory arm at L
    limbs on the card `device`: what one block's opt-in shared memory
    holds of rows and indices beside the kernel's fixed part (dedup.cu
    kasa_dedup_long_max_kpr)."""
    n = _fn("kasa_dedup_long_max_kpr")(L, _device_index(device))
    if n < 0:
        raise RuntimeError(f"kasa_dedup_long_max_kpr: CUDA error {-n}")
    return n


def dedup_arm(kpr: int, long_max: int) -> str:
    """K5's arm for reads of kpr windows: "short" (a bitonic sort of up
    to DEDUP_CAP windows in shared memory), "long" (radix passes over the
    read's rows in shared memory, up to long_max windows:
    dedup_long_max) or "global" (segmented radix passes in global
    memory)."""
    from .match.turbo import DEDUP_CAP
    if _pow2(kpr) <= DEDUP_CAP:
        return "short"
    return "long" if kpr <= long_max else "global"


def dedup_windows(q: torch.Tensor, num_reads: int, kmers_per_read: int,
                  poison: int) -> torch.Tensor:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("dedup_windows: the kernel takes CUDA tensors")
    R, kpr, L = num_reads, kmers_per_read, q.shape[1]
    if not 2 <= L <= 5:
        raise ValueError(f"q: {L} limbs, the kernel takes 2..5")
    _check(q, "q", torch.int32, (R * kpr, L), dev)
    out = torch.empty_like(q)
    arm = dedup_arm(kpr, dedup_long_max(L, dev))
    if arm == "short":
        _launch("kasa_dedup_windows", "dedup", _ptr(q), R, kpr, L,
                _pow2(kpr), poison, _ptr(out), _stream(dev))
    elif arm == "long":
        _launch("kasa_dedup_windows_long", "dedup.long", _ptr(q), R, kpr, L,
                poison, _ptr(out), _stream(dev))
    else:
        scratch = torch.empty_like(q)
        _launch("kasa_dedup_windows_global", "dedup.global", _ptr(q), R, kpr,
                L, poison, _ptr(scratch), _ptr(out), _stream(dev))
    return out


# ---------------------------------------------------------------------------
# K6 sparse_fold (csrc/sparse_fold.cu)

def sparse_fold(cp, mcnt, ofc, tt, wm: int, sent: int):
    """-> (mk (R, wm) int32 sent-padded, mv (R, wm) f32, multi_of (R,)
    bool): each unflagged read's first wm multi taxa in taxon order with
    their w(k)/T sums."""
    dev = cp.device
    if dev.type != "cuda":
        raise ValueError("sparse_fold: the kernel takes CUDA tensors")
    R, SW = cp.shape
    _check(cp, "cp", torch.int32, (R, SW), dev)
    _check(mcnt, "mcnt", torch.int32, (R,), dev)
    _check(ofc, "ofc", torch.bool, (R,), dev)
    _check_tables(tt, dev)
    from .match.turbo import SW_CAP
    mk = torch.empty((R, wm), dtype=torch.int32, device=dev)
    mv = torch.empty((R, wm), dtype=torch.float32, device=dev)
    multi_of = torch.empty((R,), dtype=torch.bool, device=dev)
    # a read's slot table, 12 bytes a slot, sits in shared memory up to
    # SW_CAP slots and in a global scratch row above
    tab = (torch.empty((R, 3 * SW + 1), dtype=torch.int32, device=dev)
           if SW > SW_CAP else None)
    _launch("kasa_sparse_fold", "sparse_fold", _ptr(cp), _ptr(mcnt),
            _ptr(ofc), _ptr(tt.grp2), _ptr(tt.d_tax4), _ptr(tt.weights), R,
            SW, tt.n, tt.num_k, wm, sent, _ptr(tab), _ptr(mk), _ptr(mv),
            _ptr(multi_of), _stream(dev))
    return mk, mv, multi_of


# ---------------------------------------------------------------------------
# K7 tiered_route (csrc/tiered_route.cu)

# chunks the shared arm takes.  A segment's running offsets, 4 (C + 1)
# bytes, sit in shared memory: below 8 chunks that is at most 32 bytes,
# far inside the 48 KB any CUDA card gives a block without opting in
# (the offsets could take C < 12,000).  But the arm writes and scans
# (C + 1) counters per 1,024 windows: on the H100 it beats the global arm
# at 4 chunks (0.192 against 0.208 ms on 4.6 M windows) and loses from 64
# (1.114 against 0.250; chip_smoke.py --stages)
ROUTE_SHARED_MAX = 8


def tiered_route_arm(C: int) -> str:
    """K7's arm for C chunks: "shared" (running offsets per segment in
    shared memory, below ROUTE_SHARED_MAX chunks) or "global" (a radix
    sort of the windows by bin, counted as "tiered_route.global")."""
    if C < 1:
        raise ValueError(f"{C} chunks")
    return "shared" if C < ROUTE_SHARED_MAX else "global"


def tiered_route(q: torch.Tensor, chunk_limb0: torch.Tensor, min_k: int,
                 max_k: int):
    """-> (qr (M, 2), vbr (M,), posr (M,), cuts (C,)) int32: the windows
    routed to their chunks (match/tiered.py tiered_route_plain)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("tiered_route: the kernel takes CUDA tensors")
    M = q.shape[0]
    C = chunk_limb0.shape[0]
    _check(q, "q", torch.int32, (M, 2), dev)
    _check(chunk_limb0, "chunk_limb0", torch.int32, (C,), dev)
    if C < 1:
        raise ValueError("chunk_limb0: no chunk")
    if M >= 1 << 31:
        raise ValueError(f"{M} windows: the kernel takes fewer than 2^31")
    i32 = dict(dtype=torch.int32, device=dev)
    qr = torch.empty((M, 2), **i32)
    vbr = torch.empty((M,), **i32)
    posr = torch.empty((M,), **i32)
    cuts = torch.empty((C,), **i32)
    if tiered_route_arm(C) == "shared":
        nseg = max(-(-M // 1024), 1)
        hist = torch.empty(((C + 1) * nseg,), **i32)
        _launch("kasa_tiered_route", "tiered_route", _ptr(q),
                _ptr(chunk_limb0), M, C, nseg, min_k, max_k, _ptr(hist),
                _ptr(qr), _ptr(vbr), _ptr(posr), _ptr(cuts), _stream(dev))
    else:
        words = ctypes.c_longlong(0)
        _fn("kasa_tiered_route_global_plan")(M, C, ctypes.byref(words))
        scratch = torch.empty((words.value,), **i32)
        _launch("kasa_tiered_route_global", "tiered_route.global", _ptr(q),
                _ptr(chunk_limb0), M, C, min_k, max_k, _ptr(scratch),
                _ptr(qr), _ptr(vbr), _ptr(posr), _ptr(cuts), _stream(dev))
    return qr, vbr, posr, cuts


# ---------------------------------------------------------------------------
# K8 tiered_pass (csrc/tiered_pass.cu)

TIERED_PREFIX_ENTRIES = (1 << 20) + 3


def tiered_prefix(rowdat: torch.Tensor) -> torch.Tensor:
    """-> the (2^20 + 3,) int32 prefix table of a chunk's (n, 4) rowdat:
    where each of 2^20 limb-0 buckets over the chunk's own span starts,
    then the span's base and shift (match/tiered.py
    tiered_prefix_plain)."""
    dev = rowdat.device
    if dev.type != "cuda":
        raise ValueError("tiered_prefix: the kernel takes CUDA tensors")
    _check(rowdat, "rowdat", torch.int32, (rowdat.shape[0], 4), dev)
    pfx = torch.empty((TIERED_PREFIX_ENTRIES,), dtype=torch.int32,
                      device=dev)
    _launch("kasa_tiered_prefix", "tiered_pass.prefix", _ptr(rowdat),
            rowdat.shape[0], _ptr(pfx), _stream(dev))
    return pfx


def tiered_pass(tabs, weights, qr, vbr, posr, lo: int, hi: int, skey, sflat,
                cflat, big, num_steps: int, msteps: int, masks, full,
                num_species: int, kmers_per_read: int, tmax: int) -> None:
    """Adds the routed windows [lo, hi) of one chunk to skey, sflat,
    cflat and big in place (match/tiered.py tiered_pass_plain).  tabs:
    the chunk's five tables and its tiered_prefix table.  The search from
    the table gives the fixed bisect's pos only when num_steps reaches
    the chunk's bit length, as kasa_tpu's step count for the padded chunk
    does."""
    rowdat, mstart, mrow, moff, d_tax4, prefix = tabs
    dev = qr.device
    if dev.type != "cuda":
        raise ValueError("tiered_pass: the kernel takes CUDA tensors")
    M = qr.shape[0]
    nk = weights.shape[0]
    S = num_species
    _check(rowdat, "rowdat", torch.int32, (rowdat.shape[0], 4), dev)
    mp = mstart.shape[0]
    _check(mstart, "mstart", torch.int32, (mp,), dev)
    _check(mrow, "mrow", torch.int32, (mp,), dev)
    _check(moff, "moff", torch.int32, (nk + 1,), dev)
    _check(d_tax4, "d_tax4", torch.int32, (d_tax4.shape[0], 4), dev)
    _check(weights, "weights", torch.float32, (nk,), dev)
    _check(masks, "masks", torch.int32, (nk, 2), dev)
    _check(qr, "qr", torch.int32, (M, 2), dev)
    _check(vbr, "vbr", torch.int32, (M,), dev)
    _check(posr, "posr", torch.int32, (M,), dev)
    _check(skey, "skey", torch.int32, (skey.shape[0], nk), dev)
    _check(sflat, "sflat", torch.float32, (sflat.shape[0],), dev)
    _check(cflat, "cflat", torch.float32, (nk * S + 1,), dev)
    _check(big, "big", torch.int32, (big.shape[0],), dev)
    R = big.shape[0] - 1
    if skey.shape[0] != M + 1 or sflat.shape[0] != R * S + 1 \
            or R * kmers_per_read != M:
        raise ValueError(f"skey {tuple(skey.shape)}, sflat "
                         f"{tuple(sflat.shape)} and big {tuple(big.shape)} "
                         f"do not fit {M} windows of {kmers_per_read} per "
                         "read")
    if not 0 <= lo <= hi <= M:
        raise ValueError(f"window range [{lo}, {hi}) outside 0..{M}")
    if nk > 6:
        raise ValueError(f"{nk} k levels: tpack holds six")
    if num_steps < rowdat.shape[0].bit_length():
        raise ValueError(f"{num_steps} bisect steps do not cover a chunk of "
                         f"{rowdat.shape[0]} rows")
    _check(prefix, "prefix", torch.int32, (TIERED_PREFIX_ENTRIES,), dev)
    _launch("kasa_tiered_pass", "tiered_pass", _ptr(rowdat), _ptr(mstart),
            _ptr(mrow), _ptr(moff), _ptr(d_tax4), _ptr(weights),
            _ptr(masks), _ptr(qr), _ptr(vbr), _ptr(posr), _ptr(prefix), lo,
            hi, rowdat.shape[0], mp, d_tax4.shape[0], nk, num_steps,
            msteps, int(full[0]), int(full[1]), S, kmers_per_read, tmax,
            _ptr(skey), _ptr(sflat), _ptr(cflat), _ptr(big), _stream(dev))


# ---------------------------------------------------------------------------
# K9 classic_classify (csrc/classic_classify.cu)

def _check_classic_tables(t, L, dev) -> None:
    n, nk = t.n, t.num_k
    _check(t.idx_limbs, "idx_limbs", torch.int32, (n, L), dev)
    _check(t.grp_id, "grp_id", torch.int32, (nk, n), dev)
    _check(t.grp_start, "grp_start", torch.int32, (nk, t.grp_start.shape[1]),
           dev)
    _check(t.d_tax, "d_tax", torch.int32, (nk, t.d_tax.shape[1]), dev)
    _check(t.masks, "masks", torch.int32, (nk, L), dev)
    _check(t.weights, "weights", torch.float32, (nk,), dev)
    _check(t.run_end, "run_end", torch.int32, (n,), dev)
    _check(t.prefix_tbl, "prefix_tbl", torch.int32, ((1 << 20) + 1,), dev)


def classic_smem_budget(device: torch.device) -> int:
    """The shared memory a block of K9 may fill on the card `device`
    (classic_classify.cu kasa_classic_smem_budget)."""
    n = _fn("kasa_classic_smem_budget")(_device_index(device))
    if n < 0:
        raise RuntimeError(f"kasa_classic_smem_budget: CUDA error {-n}")
    return n


def classic_arm(S: int, ascending: bool, budget: int) -> str:
    """K9's arm for a batch: "local" (one block per read, its float64
    score row of 8 * S bytes in shared memory) where each read's windows
    form one run (the uniform layout, or read ids that ascend: ids_ascend)
    and the row fits the block's shared-memory budget
    (classic_smem_budget); else "global" (one thread per window, the rows
    in device memory)."""
    return "local" if ascending and 8 * S <= budget else "global"


def ids_ascend(read_ids: torch.Tensor) -> bool:
    """The scatter layout's read ids do not decrease, so each read's
    windows form one run (one reduction where the ids lie, then a
    sync)."""
    return bool((read_ids[1:] >= read_ids[:-1]).all())


def classic_classify(t, q, read_ids, q_valid, num_reads: int, cap: int,
                     kmers_per_read: int):
    """-> (scores (R, S) f32, counts_all (numK, S) f32, counts_unique
    (numK, S) int32, tail_pairs 0-d int32) for StackedTables t
    (match/device.py classify_batch_plain).  The arm from classic_arm,
    the scatter layout's ids checked here (ids_ascend), counted as
    "classic_classify" or "classic_classify.global"."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("classic_classify: the kernel takes CUDA tensors")
    M, L = q.shape
    n, nk, S = t.n, t.num_k, t.num_species
    if not 2 <= L <= 5:
        raise ValueError(f"q: {L} limbs, the kernel takes 2..5")
    _check_classic_tables(t, L, dev)
    _check(q, "q", torch.int32, (M, L), dev)
    _check(q_valid, "q_valid", torch.bool, (M,), dev)
    if kmers_per_read == 0:
        _check(read_ids, "read_ids", torch.int32, (M,), dev)
    counts_all = torch.zeros((nk, S), dtype=torch.float32, device=dev)
    counts_unique = torch.zeros((nk, S), dtype=torch.int32, device=dev)
    tail = torch.zeros((), dtype=torch.int32, device=dev)
    if M == 0 or n == 0:
        return (torch.zeros((num_reads, S), dtype=torch.float32, device=dev),
                counts_all, counts_unique, tail)
    local = classic_arm(S, kmers_per_read > 0 or ids_ascend(read_ids),
                        classic_smem_budget(dev)) == "local"
    # the local arm writes every row once; the global arm's rows add in
    # float64 and round to float32 once (csrc/classic_classify.cu)
    scores = (torch.empty((num_reads, S), dtype=torch.float32, device=dev)
              if local else
              torch.zeros((num_reads, S), dtype=torch.float64, device=dev))
    seg = (torch.empty((num_reads + 1,), dtype=torch.int64, device=dev)
           if local and kmers_per_read == 0 else None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _launch("kasa_classic_classify",
            "classic_classify" if local else "classic_classify.global",
            _ptr(t.idx_limbs), _ptr(t.grp_id), _ptr(t.grp_start),
            _ptr(t.d_tax), _ptr(t.masks), _ptr(t.weights), _ptr(t.run_end),
            _ptr(t.prefix_tbl), _ptr(q),
            _ptr(read_ids if kmers_per_read == 0 else None), _ptr(q_valid),
            n, t.grp_start.shape[1], t.d_tax.shape[1], M, L, nk, t.min_k,
            t.max_k, S, cap, kmers_per_read, num_reads, int(local), sms,
            _ptr(seg), _ptr(scores), _ptr(counts_all),
            _ptr(counts_unique), _ptr(tail), _stream(dev))
    return (scores if local else scores.float()), counts_all, \
        counts_unique, tail


# ---------------------------------------------------------------------------
# K10 join_match (csrc/join_match.cu)

def join_match(t, q):
    """-> (matched (numK, M) bool, g, T, start (numK, M) int32, ok
    (numK, M) bool) for StackedTables t (match/join.py
    join_match_plain)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("join_match: the kernel takes CUDA tensors")
    M, L = q.shape
    n, nk = t.n, t.num_k
    if not 2 <= L <= 5:
        raise ValueError(f"q: {L} limbs, the kernel takes 2..5")
    if nk > 25:
        raise ValueError(f"{nk} k levels: the kernel takes at most 25")
    _check_classic_tables(t, L, dev)
    _check(q, "q", torch.int32, (M, L), dev)
    matched = torch.zeros((nk, M), dtype=torch.bool, device=dev)
    g = torch.zeros((nk, M), dtype=torch.int32, device=dev)
    T = torch.zeros_like(g)
    start = torch.zeros_like(g)
    ok = torch.zeros_like(matched)
    if M == 0 or n == 0:
        return matched, g, T, start, ok
    _launch("kasa_join_match", "join_match", _ptr(t.idx_limbs),
            _ptr(t.grp_id), _ptr(t.grp_start), _ptr(t.masks),
            _ptr(t.run_end), _ptr(t.prefix_tbl), _ptr(q), n,
            t.grp_start.shape[1], M, L, nk, t.min_k, t.max_k, _ptr(matched),
            _ptr(g), _ptr(T), _ptr(start), _ptr(ok), _stream(dev))
    return matched, g, T, start, ok


# ---------------------------------------------------------------------------
# K11 join_scatter (csrc/join_scatter.cu)

def join_scatter(t, valid, T, start, read_ids, num_reads: int):
    """-> (num_reads, S) float32 scores: every valid occurrence's w(k)/T
    over its group's taxa (match/join.py join_scatter_plain)."""
    dev = read_ids.device
    if dev.type != "cuda":
        raise ValueError("join_scatter: the kernel takes CUDA tensors")
    M = read_ids.shape[0]
    nk, S = t.num_k, t.num_species
    _check(read_ids, "read_ids", torch.int32, (M,), dev)
    _check(valid, "valid", torch.bool, (nk, M), dev)
    _check(T, "T", torch.int32, (nk, M), dev)
    _check(start, "start", torch.int32, (nk, M), dev)
    _check(t.d_tax, "d_tax", torch.int32, (nk, t.d_tax.shape[1]), dev)
    _check(t.weights, "weights", torch.float32, (nk,), dev)
    # the score cells add in float64 and round to float32 once
    scores = torch.zeros((num_reads, S), dtype=torch.float64, device=dev)
    if M == 0 or num_reads == 0:
        return scores.float()
    _launch("kasa_join_scatter", "join_scatter", _ptr(valid), _ptr(T),
            _ptr(start), _ptr(read_ids), _ptr(t.d_tax), _ptr(t.weights), M,
            t.d_tax.shape[1], nk, S, _ptr(scores), _stream(dev))
    return scores.float()


# ---------------------------------------------------------------------------
# K12 query_sort (csrc/query_sort.cu)

def query_sort_plan(M: int, L: int, rid_bits: int) -> tuple[int, int]:
    """-> (digit passes, int32 scratch words) of K12 on (M, L) rows."""
    return _sort_plan("kasa_query_sort_plan", M, L, rid_bits)


def query_sort(q, read_ids, rid_bits: int, marks=None):
    """-> (q, read_ids) sorted stably by (limbs..., the read ids' low
    rid_bits bits) (match/join.py sort_queries_plain, for ids below
    2^rid_bits): the one-sweep radix passes over the read ids' digits,
    then each 30-bit limb's, from the last limb to the first.  marks:
    None, or passes + 2 torch.cuda.Events, recorded before the histogram
    launch, after the digit starts and after each pass (chip_smoke.py
    times the stages with them)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("query_sort: the kernel takes CUDA tensors")
    M, L = q.shape
    if not 1 <= L <= 5:
        raise ValueError(f"q: {L} limbs, the kernel takes 1..5")
    if not 0 <= rid_bits <= 31:
        raise ValueError(f"rid_bits={rid_bits}: read ids are int32")
    _check(q, "q", torch.int32, (M, L), dev)
    _check(read_ids, "read_ids", torch.int32, (M,), dev)
    if M == 0:
        return q.clone(), read_ids.clone()
    passes, words = query_sort_plan(M, L, rid_bits)
    handles = _marks(marks, passes + 2)
    qa, qb = torch.empty_like(q), torch.empty_like(q)
    ra, rb = torch.empty_like(read_ids), torch.empty_like(read_ids)
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    _launch("kasa_query_sort", "query_sort", _ptr(q), _ptr(read_ids),
            _ptr(qa), _ptr(ra), _ptr(qb), _ptr(rb), _ptr(scratch), M, L,
            rid_bits, _stream(dev), handles)
    # pass p writes buffer a when p is even: the last pass, passes - 1
    return (qa, ra) if passes % 2 else (qb, rb)


# ---------------------------------------------------------------------------
# K13 sort_dedup (csrc/sort_dedup.cu)

def sort_dedup(limbs: torch.Tensor, taxids: torch.Tensor):
    """-> (q_out (N, L), t_out (N,), nu 0-d) int32: the rows sorted by
    (limbs..., taxid as uint32) with exact duplicates dropped in the first
    nu rows of q_out and t_out (index/build.py sort_dedup_plain).  taxids
    carries uint32 values as an int32 bit pattern."""
    dev = limbs.device
    if dev.type != "cuda":
        raise ValueError("sort_dedup: the kernel takes CUDA tensors")
    N, L = limbs.shape
    if not 2 <= L <= 5:
        raise ValueError(f"limbs: {L} limbs, the kernel takes 2..5")
    if N >= 1 << 31:
        raise ValueError(f"{N} rows: the kernel takes fewer than 2^31")
    _check(limbs, "limbs", torch.int32, (N, L), dev)
    _check(taxids, "taxids", torch.int32, (N,), dev)
    nu = torch.zeros((), dtype=torch.int32, device=dev)
    if N == 0:
        return limbs.clone(), taxids.clone(), nu
    _, words = _sort_plan("kasa_sort_dedup_plan", N, L)
    scr_q = torch.empty((2, N, L), dtype=torch.int32, device=dev)
    scr_t = torch.empty((2, N), dtype=torch.int32, device=dev)
    hist = torch.empty((words,), dtype=torch.int32, device=dev)
    q_out = torch.empty_like(limbs)
    t_out = torch.empty_like(taxids)
    _launch("kasa_sort_dedup", "sort_dedup", _ptr(limbs), _ptr(taxids),
            _ptr(scr_q[0]), _ptr(scr_t[0]), _ptr(scr_q[1]), _ptr(scr_t[1]),
            _ptr(hist), N, L, _ptr(q_out), _ptr(t_out), _ptr(nu),
            _stream(dev))
    return q_out, t_out, nu


# ---------------------------------------------------------------------------
# K14 mesh_merge (csrc/mesh_merge.cu)

# pairs per read that K14 sorts in shared memory (64-bit keys, 32 KB); a
# read with more takes the long arm (global scratch, segmented radix)
MERGE_SHORT_CAP = 4096


def mesh_merge(hts: torch.Tensor, hks: torch.Tensor, ofc: torch.Tensor,
               ofl: torch.Tensor, cap: int):
    """-> (packed (2R + 2 cap + 2,) int32, ht_m (R, wout) int32, hk_m
    (R, wout) f32): the (ip, R, wout) shard lists merged per read and
    CSR-packed (parallel/turbo_mesh.py mesh_merge_plain)."""
    dev = hts.device
    if dev.type != "cuda":
        raise ValueError("mesh_merge: the kernel takes CUDA tensors")
    ip, R, wout = hts.shape
    _check(hts, "hts", torch.int32, (ip, R, wout), dev)
    _check(hks, "hks", torch.float32, (ip, R, wout), dev)
    _check(ofc, "ofc", torch.bool, (R,), dev)
    _check(ofl, "ofl", torch.bool, (R,), dev)
    i32 = dict(dtype=torch.int32, device=dev)
    packed = torch.zeros((2 * R + 2 * cap + 2,), **i32)
    ht_m = torch.empty((R, wout), **i32)
    hk_m = torch.empty((R, wout), dtype=torch.float32, device=dev)
    cum = torch.empty((R,), **i32)
    P = _pow2(ip * wout)
    if P <= MERGE_SHORT_CAP:
        _launch("kasa_mesh_merge", "mesh_merge", _ptr(hts), _ptr(hks),
                _ptr(ofc), _ptr(ofl), ip, R, wout, P, cap, None, None,
                _ptr(cum), _ptr(ht_m), _ptr(hk_m), _ptr(packed),
                _stream(dev))
    else:
        scr = torch.empty((2, R * ip * wout * 2), **i32)
        _launch("kasa_mesh_merge", "mesh_merge.long", _ptr(hts), _ptr(hks),
                _ptr(ofc), _ptr(ofl), ip, R, wout, 0, cap, _ptr(scr[0]),
                _ptr(scr[1]), _ptr(cum), _ptr(ht_m), _ptr(hk_m),
                _ptr(packed), _stream(dev))
    return packed, ht_m, hk_m
