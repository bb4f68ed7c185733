"""rvc_tpu_torch: the RVC voice-conversion path in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``rvc_tpu`` (JAX/Flax/Pallas). Module names mirror the JAX
package so each piece has an obvious counterpart; weights use the
reference torch state_dict names, and ``compat.weights`` turns JAX
parameter trees (as nested dicts of numpy arrays) into them.

Conversion computes in float32 by default, or in bfloat16 (``dtype``);
training computes in float32. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without a card they raise instead of
falling back. This package never imports JAX.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
