"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises: the port
    never falls back to the CPU on its own; callers ask for it by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def set_float32_math() -> None:
    """Full float32 on the card: cuDNN convolutions and RNNs default to TF32,
    which keeps about three decimal digits and would cost parity. And a
    bfloat16 GEMM sums in float32 throughout, as JAX's do: cuBLAS's default
    may reduce part of it in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
