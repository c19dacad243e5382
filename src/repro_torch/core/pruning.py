"""Group pruning: which 1xG groups survive (paper §3.2).

Row-balanced mode (the serving default): every output row keeps exactly
its top-M groups by saliency, so storage is rectangular and every row of
the GEMV does the same work.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    sparsity: float = 0.5          # fraction of groups removed
    group_size: int = 16
    row_balanced: bool = True


def groups_kept_per_row(k: int, cfg: PruneConfig) -> int:
    """M = round(K/G * (1 - sparsity)), >= 1."""
    ngroups = k // cfg.group_size
    return max(1, int(round(ngroups * (1.0 - cfg.sparsity))))


def row_balanced_mask(gsal: torch.Tensor, cfg: PruneConfig) -> torch.Tensor:
    """Per-row top-M group mask. gsal: [N, K/G] -> bool [N, K/G].

    Ties keep the lower group index, as the reference's stable descending
    ``argsort`` does (``torch.topk`` promises no order among ties)."""
    n, ngroups = gsal.shape
    m = groups_kept_per_row(ngroups * cfg.group_size, cfg)
    idx = torch.sort(gsal, dim=-1, descending=True, stable=True) \
        .indices[:, :m]
    mask = torch.zeros_like(gsal, dtype=torch.bool)
    return mask.scatter_(1, idx, True)


def group_mask(gsal: torch.Tensor, cfg: PruneConfig) -> torch.Tensor:
    if not cfg.row_balanced:
        raise NotImplementedError(
            "global-threshold pruning is not yet ported (ROADMAP A.6)")
    return row_balanced_mask(gsal, cfg)
