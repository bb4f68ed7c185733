"""Probe ATen's CPU bfloat16 convolutions against the same sums taken in
float32 over the same bf16 operands, over a grid of shapes.

A shape is listed as faulty where the bf16 output differs from the float32
sums by more than 2e-2 of their largest magnitude (a correct bf16 conv
rounds once: 2^-9 relative). ``models/layers.py::Conv1d`` sums bf16 operands
in float32 on the CPU because of what this finds for conv1d.

    python scripts/probe_torch_cpu_bf16_conv.py
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

BAR = 2e-2


def rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref).abs().max() / ref.abs().max())


def probe(label: str, cases, fn) -> None:
    bad, n = [], 0
    for case in cases:
        n += 1
        x, w, kw = case()
        err = rel(fn(x, w, **kw), fn(x.float(), w.float(), **kw))
        if err > BAR:
            bad.append((tuple(x.shape[1:2]) + tuple(w.shape[2:]), kw, round(err, 3)))
    print(f"{label}: {len(bad)} of {n} shapes faulty" + "".join(f"\n  {b}" for b in bad))


def main() -> None:
    torch.manual_seed(0)
    torch.set_num_threads(1)
    bf = torch.bfloat16

    def conv1d(cin, k, s):
        return lambda: (torch.randn(2, cin, 200).to(bf), torch.randn(16, cin, k).to(bf),
                        {"stride": s})

    def conv2d(cin, k, s):
        return lambda: (torch.randn(1, cin, 64, 20).to(bf), torch.randn(16, cin, k, 1).to(bf),
                        {"stride": (s, 1)})

    def conv_t2d(cin, k, s):
        return lambda: (torch.randn(1, cin, 16, 20).to(bf), torch.randn(cin, 8, k, 1).to(bf),
                        {"stride": (s, 1)})

    probe("conv1d (input channels, k; stride)",
          [conv1d(*c) for c in itertools.product([2, 4, 8, 12, 16, 32, 48],
                                                  [2, 4, 5, 7, 8, 9, 16], [1, 2, 4])],
          F.conv1d)
    probe("conv2d, (k, 1) kernels",
          [conv2d(*c) for c in itertools.product([2, 4, 8, 16, 32], [1, 4, 8, 16], [1, 2, 4])],
          F.conv2d)
    probe("conv_transpose2d, (k, 1) kernels",
          [conv_t2d(*c) for c in itertools.product([4, 8, 16, 32], [1, 4, 8], [1, 2, 4])],
          F.conv_transpose2d)


if __name__ == "__main__":
    main()
