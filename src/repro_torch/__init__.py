"""PyTorch + CUDA port of the GQSA serving system (the JAX package in
``src/repro`` is its reference and stays unchanged).

The layout mirrors the reference package module for module. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; with no card
and no explicit CPU request they raise (:func:`resolve_device`). On a CUDA
tensor every kernel wrapper launches its hand-written kernel or raises;
on a CPU tensor it runs the kernel's plain PyTorch version.

float32 matmuls and convolutions run in full float32 on the card: TF32
is switched off here, where the package starts, so that kernel-vs-plain
comparisons and the CPU conformance tests share one precision.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None``/"cuda" -> the card (raises when there is none); "cpu" only
    when the caller asks for it explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the card unless the caller "
            "asks for the CPU explicitly (device='cpu')")
    return dev
