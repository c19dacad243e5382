"""Weight saliency (paper §3.1). One-shot packing without calibration stats
uses magnitude saliency; the Hessian-based form waits for the compression
pipeline slice (ROADMAP A.6)."""
from __future__ import annotations

import torch


def magnitude_saliency(w: torch.Tensor) -> torch.Tensor:
    """Per-element w^2 (the reference's saliency when no stats are given)."""
    return torch.square(w.float())


def group_saliency(elem_saliency: torch.Tensor,
                   group_size: int) -> torch.Tensor:
    """Average per-element saliency within each 1xG group.

    [out, in] -> [out, in/G].
    """
    n, k = elem_saliency.shape
    if k % group_size != 0:
        raise ValueError(f"in dim {k} not divisible by group {group_size}")
    return elem_saliency.reshape(n, k // group_size, group_size).mean(dim=-1)
