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


def _at(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B, N], idx [B] -> arr[b, idx[b]] (no host read)."""
    return torch.gather(arr, 1, idx.long()[:, None])[:, 0]


def _draw(weights: torch.Tensor, gen: Optional[torch.Generator]
          ) -> torch.Tensor:
    """One categorical draw per row of [..., V] unnormalized weights (the
    reference draws from log(max(w, 1e-30)): the same floor here)."""
    lead = weights.shape[:-1]
    w = weights.clamp_min(1e-30).reshape(-1, weights.shape[-1])
    return torch.multinomial(w, 1, generator=gen).reshape(lead) \
        .to(torch.int32)


def spec_verify(logits: torch.Tensor, draft: torch.Tensor,
                gen: Optional[torch.Generator], sp: SamplingParams):
    """Speculative-decoding acceptance: lossless rejection sampling of K
    greedy draft tokens against K+1 target distributions.

    logits: [B, K+1, V] target logits at the K+1 fed positions (position
    i is the target distribution after the first i drafts); draft: [B, K]
    greedy draft tokens. Returns ``(n_acc [B] int32, out [B, K+1] int32)``:
    ``out[:, :n_acc]`` are the accepted drafts, ``out[:, n_acc]`` the
    correction or bonus token; later entries are unspecified.

    Greedy: a draft is accepted iff it is the target argmax, and the
    correction is the target argmax, so the output is token for token the
    non-speculative greedy sequence. Temperature > 0: the draft is a point
    mass q = 1{x = draft}, accepted with probability p(draft); on
    rejection the correction is drawn from p with the draft token zeroed.
    Each emitted token is distributed as the target p."""
    b, k1, v = logits.shape
    k = k1 - 1
    tgt = torch.argmax(logits, dim=-1).to(torch.int32)          # [B, K+1]
    if sp.greedy:
        match = (draft.to(torch.int32) == tgt[:, :k]).to(torch.int32)
        n_acc = torch.cumprod(match, dim=-1).sum(dim=-1)
        return n_acc.to(torch.int32), tgt
    probs = torch.softmax(filter_logits(logits, sp), dim=-1)   # [B,K+1,V]
    p_draft = torch.gather(probs[:, :k], 2, draft.long()[..., None])[..., 0]
    u = torch.rand((b, k), generator=gen, device=logits.device)
    accept = (u < p_draft).to(torch.int32)
    n_acc = torch.cumprod(accept, dim=-1).sum(dim=-1).to(torch.int32)
    # residual at each stop index i < K: p with the rejected draft token
    # zeroed; index K (all accepted) keeps p as the bonus distribution
    drafted = torch.cat([draft.to(torch.int32),
                         torch.full((b, 1), -1, dtype=torch.int32,
                                    device=draft.device)], dim=1)
    iota = torch.arange(v, dtype=torch.int32, device=logits.device)
    residual = torch.where(iota == drafted[..., None], 0.0, probs)
    resample = _draw(residual, gen)                            # [B, K+1]
    idx = torch.arange(k1, device=logits.device)[None, :]
    draft_pad = torch.cat([draft.to(torch.int32),
                           torch.zeros((b, 1), dtype=torch.int32,
                                       device=draft.device)], dim=1)
    out = torch.where(idx < n_acc[:, None], draft_pad, resample)
    return n_acc, out


def tree_verify(logits: torch.Tensor, feed: torch.Tensor, fanout,
                child_start, gen: Optional[torch.Generator],
                sp: SamplingParams):
    """Token-TREE speculative verification: walk the draft tree root to
    leaf, rejection-sampling over each node's sibling set, and emit the
    longest accepted path plus one correction/bonus token (lossless for
    any temperature).

    logits: [B, N+1, V] target logits at the fed tree slots (slot i's are
    the target distribution after the root-to-i path); feed: [B, N+1] the
    fed tokens (slot 0 the pending token, 1..N the BFS tree); ``fanout``
    (tuple) and ``child_start`` ([N+1] first-child slot, -1 at leaves; a
    tensor on the logits' device, or anything ``torch.as_tensor`` takes)
    describe the tree. Returns ``(n_acc [B], out [B, D+1], path [B, D])``
    int32, D = len(fanout): ``out[:, :n_acc]`` the accepted path tokens,
    ``out[:, n_acc]`` the correction/bonus, ``path[:, i]`` the tree slot
    of the i-th accepted token (entries at and after n_acc unspecified).

    Greedy: step to the child that is the target argmax, else emit the
    argmax (sequential greedy, token for token). Temperature > 0:
    candidate j is accepted with probability r(d_j) / sum(r), r the
    target with every earlier rejected sibling zeroed; if all are
    rejected, the correction is drawn from the last residual. A chain
    (fanout all 1) reproduces :func:`spec_verify`."""
    b, _, v = logits.shape
    dev = logits.device
    depth = len(fanout)
    cs = torch.as_tensor(child_start, device=dev).long()      # [N+1]
    feed = feed.to(torch.int32)
    cur = torch.zeros((b,), dtype=torch.long, device=dev)
    alive = torch.ones((b,), dtype=torch.bool, device=dev)
    n_acc = torch.zeros((b,), dtype=torch.int32, device=dev)
    out = torch.zeros((b, depth + 1), dtype=torch.int32, device=dev)
    path = torch.zeros((b, depth), dtype=torch.int32, device=dev)

    if sp.greedy:
        tgt = torch.argmax(logits, dim=-1).to(torch.int32)     # [B, N+1]
        for i, f in enumerate(fanout):
            cb = cs[cur]                                        # [B]
            t_cur = _at(tgt, cur)
            cand = torch.stack([_at(feed, cb + j) for j in range(f)], 1)
            match = cand == t_cur[:, None]
            hit = match.any(dim=1)
            jidx = torch.argmax(match.to(torch.int32), dim=1)
            step = alive & hit
            # the accepted child is the target argmax, which is also the
            # correction on a miss: alive rows emit t_cur either way
            out[:, i] = torch.where(alive, t_cur, out[:, i])
            path[:, i] = torch.where(step, cb + jidx, 0).to(torch.int32)
            n_acc += step.to(torch.int32)
            cur = torch.where(step, cb + jidx, cur)
            alive = step
        out[:, depth] = torch.where(alive, _at(tgt, cur), out[:, depth])
        return n_acc, out, path

    probs = torch.softmax(filter_logits(logits, sp), dim=-1)  # [B,N+1,V]
    iota = torch.arange(v, dtype=torch.int32, device=dev)[None, :]
    rows = torch.arange(b, device=dev)
    for i, f in enumerate(fanout):
        r = probs[rows, cur]                                   # residual
        acc = torch.full((b,), -1, dtype=torch.long, device=dev)
        cb = cs[cur]
        cand = []
        for j in range(f):
            tok_j = _at(feed, cb + j)
            cand.append(tok_j)
            rs = r.sum(dim=-1).clamp_min(1e-30)
            pj = _at(r, tok_j) / rs
            u = torch.rand((b,), generator=gen, device=dev)
            acc = torch.where((acc < 0) & (u < pj), j, acc)
            # rows still rejecting zero this sibling's mass
            r = torch.where((acc < 0)[:, None] & (iota == tok_j[:, None]),
                            0.0, r)
        corr = _draw(r, gen)
        step = alive & (acc >= 0)
        jidx = acc.clamp_min(0)
        tok_acc = _at(torch.stack(cand, 1), jidx)
        out[:, i] = torch.where(alive, torch.where(step, tok_acc, corr),
                                out[:, i])
        path[:, i] = torch.where(step, cb + jidx, 0).to(torch.int32)
        n_acc += step.to(torch.int32)
        cur = torch.where(step, cb + jidx, cur)
        alive = step
    bonus = _draw(probs[rows, cur], gen)
    out[:, depth] = torch.where(alive, bonus, out[:, depth])
    return n_acc, out, path
