"""kasa_tpu_torch: the kASA-compatible classifier on PyTorch and CUDA.

A port of kasa_tpu (JAX) to NVIDIA H100s: one card, or a mesh of cards
with one process each (parallel/).  Every mode keeps kasa_tpu's
artifacts, tables and output bytes; the device work of identify and of
the index build runs in hand-written CUDA kernels (csrc/, bound by
kernels.py), each with a plain PyTorch version that the CPU tests run.

Entry points take ``device=None``, which means ``cuda``: without a CUDA
device they raise instead of dropping to the CPU.  Pass
``device="cpu"`` to run the plain versions on the host.
"""

__version__ = "0.1.0"

import torch

# float32 products stay full float32 (the hot-set folds compare against
# kasa_tpu's f32 dot); TF32 keeps only ~3 decimal digits
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda.  Raises when CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kasa_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
