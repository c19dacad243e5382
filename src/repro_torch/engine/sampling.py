"""Token sampling: greedy / temperature / top-k / top-p (nucleus).

``sample`` runs on the device inside the engine's steps, so sampled tokens
never round-trip to the host. Randomness comes from a ``torch.Generator``
on the logits' device: it gives other numbers than the reference's
``PRNGKey`` streams from the same seed, so sampled (temperature > 0)
outputs are compared by distribution, greedy ones token for token.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 => greedy
    top_k: int = 0               # 0 => disabled
    top_p: float = 1.0           # 1 => disabled

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def filter_logits(logits: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """Temperature + top-k + top-p filtering: [..., V] -> [..., V] f32
    with filtered entries at -inf (the target distribution is softmax of
    this)."""
    logits = logits.float() / sp.temperature
    if 0 < sp.top_k < logits.shape[-1]:
        kth = torch.sort(logits, dim=-1).values[..., -sp.top_k][..., None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if sp.top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p (always
        # keep the first token); cutoff = logit of the last kept entry
        keep = cum - probs < sp.top_p
        cutoff = torch.where(keep, sorted_l, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def sample(logits: torch.Tensor, gen: Optional[torch.Generator],
           sp: SamplingParams) -> torch.Tensor:
    """logits: [B, V] -> tokens [B] int32 (on the logits' device)."""
    if sp.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(filter_logits(logits, sp), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
