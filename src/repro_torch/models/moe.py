"""Mixture-of-Experts block (DeepSeek-style: shared + routed top-k), on
one device.

The reference's dispatch, computed the same way: every token (padding
and idle slots included) is routed; its top-k entries take slots in their
experts' [E, capacity, d] buffers in token-major cumsum order, entries past
the capacity drop; the expert FFNs run on the buffers; the outputs are
gathered back and summed with the renormalised gates. Which entries drop
depends on the whole batch, so callers feed the batch composition that the
reference engine feeds.

Beyond the reference: each expert's row count (``min(count, capacity)``)
is computed on the device and handed to the expert kernel, which skips
the empty buffer rows and never reads an expert that holds none. Those
rows are zeros whose products the keep mask discards, so the skip changes
no number. The router's aux loss is computed for ``forward``; training,
which uses it, and expert parallelism are not ported (ROADMAP A.6, A.9).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.gqs_layer import apply_linear, apply_linear_experts
from repro_torch.models.layers import mlp_block


def capacity(tokens: int, moe) -> int:
    """Buffer rows per expert for ``tokens`` routed rows."""
    return max(1, int(tokens * moe.top_k / moe.n_experts
                      * moe.capacity_factor))


def route(router_p: Dict, x: torch.Tensor, moe, aux: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """x: [T, d] -> (gates [T, K] f32, expert ids [T, K] int64, the
    load-balancing aux loss E * sum_e f_e * mean_t P_e, or None without
    ``aux``), f_e the share of tokens that route to expert e.

    Router logits and softmax in f32; the top k probabilities with ties
    broken toward the lower expert id, as the reference's ``lax.top_k``
    breaks them (``torch.topk`` promises no order for ties, so a stable
    descending sort picks them); gates renormalised over the k with a
    1e-9 floor. The serving steps pass ``aux=False``: eager PyTorch would
    compute the unused loss (XLA drops it from the reference's steps)."""
    logits = apply_linear(router_p, x.float())
    probs = torch.softmax(logits, dim=-1)                   # [T, E]
    top_vals, top_idx = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[:, :moe.top_k], top_idx[:, :moe.top_k]
    gates = top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True), 1e-9)
    loss = None
    if aux:
        f = torch.zeros_like(probs).scatter_(1, top_idx, 1.0).mean(0)
        loss = moe.n_experts * torch.sum(f * probs.mean(0))
    return gates, top_idx, loss


def expert_ffn(experts: Dict, x_buf: torch.Tensor, rows: torch.Tensor,
               plain: bool = False) -> torch.Tensor:
    """x_buf: [E, C, d] -> [E, C, d]: each expert's SwiGLU on its buffer.
    ``rows`` [E]: the buffer rows that hold tokens."""
    g = apply_linear_experts(experts["wg"], x_buf, rows, plain=plain)
    u = apply_linear_experts(experts["wu"], x_buf, rows, plain=plain)
    return apply_linear_experts(experts["wd"], F.silu(g) * u, rows,
                                plain=plain)


def dispatch_compute(x: torch.Tensor, gates: torch.Tensor,
                     top_idx: torch.Tensor, experts: Dict, n_experts: int,
                     cap: int, plain: bool = False) -> torch.Tensor:
    """Scatter the routed entries into the experts' buffers, run the
    experts, gather back. x: [T, d]; gates / top_idx: [T, K]. Returns
    y [T, d] in x's dtype. No value is read on the host."""
    t, d = x.shape
    k = top_idx.shape[1]
    eid = top_idx.reshape(-1)                               # [T*K]
    # position of each entry in its expert's buffer, token-major order
    oh = (eid[:, None] == torch.arange(n_experts, device=x.device)[None, :]
          ).to(torch.int32)                                 # [T*K, E]
    entry_pos = ((torch.cumsum(oh, dim=0) - oh) * oh).sum(-1)
    keep = entry_pos < cap
    # dropped entries add zeros into the expert's last slot
    entry_pos = torch.where(keep, entry_pos, cap - 1)
    rows = torch.clamp(oh.sum(0), max=cap).to(torch.int32)  # [E]
    x_flat = x[torch.arange(t * k, device=x.device) // k]   # [T*K, d]
    x_buf = torch.zeros((n_experts, cap, d), dtype=x.dtype, device=x.device)
    x_buf.index_put_((eid, entry_pos),
                     torch.where(keep[:, None], x_flat, 0), accumulate=True)
    y_buf = expert_ffn(experts, x_buf, rows, plain)         # [E, C, d]
    y_flat = torch.where(keep[:, None], y_buf[eid, entry_pos], 0)
    y = y_flat * gates.reshape(-1, 1).to(y_flat.dtype)
    return y.reshape(t, k, d).sum(1)


def moe_block(p: Dict, x: torch.Tensor, cfg, plain: bool = False,
              aux: bool = True) -> Tuple[torch.Tensor,
                                         Optional[torch.Tensor]]:
    """x: [B, S, d] -> (y [B, S, d], the router's aux loss, or None
    without ``aux``): the routed experts plus the fused shared experts.
    Capacity counts all B * S rows."""
    moe = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gates, top_idx, loss = route(p["router"], xf, moe, aux)
    y = dispatch_compute(xf, gates, top_idx, p["experts"], moe.n_experts,
                         capacity(b * s, moe), plain)
    if "shared" in p:
        y = y + mlp_block(p["shared"], xf, "swiglu", plain)
    return y.reshape(b, s, d), loss
