"""Family dispatch: one API over the ported architectures.

    api = get_model(cfg)
    params = api.init_params(seed, cfg, device)
    cache = api.init_paged_cache(cfg, num_pages, page_size, device=device)
    logits, cache = api.prefill(params, cache, tokens, lengths, tables, cfg)
    logits, cache = api.decode_step(params, cache, tok, pos, cfg, tables)
    logits, aux = api.forward(params, {"tokens": tokens}, cfg)
    cache = api.init_cache(cfg, batch_size, max_seq, device=device)
    logits, cache = api.decode_step(params, cache, tok, pos, cfg)

``batch`` is a dict, as in the reference: ``tokens`` [B, S]. The dense,
MoE (``moe``) and MLA + MoE (``mla_moe``) families are ported, on the
paged pool and on the contiguous cache; the reference's other families
are later slices (ROADMAP A.7.3, A.8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init_params: Callable
    decode_step: Callable
    forward: Callable        # (params, batch, cfg, plain, last_only)
    init_cache: Callable     # (cfg, batch_size, max_seq, dtype, device)
    init_paged_cache: Optional[Callable] = None
    prefill: Optional[Callable] = None

    @property
    def supports_paged_cache(self) -> bool:
        """Continuous-batching capability: the family provides both the
        paged pool layout and the batched prefill."""
        return self.init_paged_cache is not None and self.prefill is not None


def _tf_forward(params, batch: Dict, cfg, plain: bool = False,
                last_only: bool = False):
    return transformer.forward(params, batch["tokens"], cfg, plain,
                               last_only)


_DECODER = ModelAPI(transformer.init_params, transformer.decode_step,
                    _tf_forward, transformer.init_cache,
                    init_paged_cache=transformer.init_paged_cache,
                    prefill=transformer.prefill)
_FAMILIES: Dict[str, ModelAPI] = {"dense": _DECODER, "moe": _DECODER,
                                  "mla_moe": _DECODER}


def paged_families() -> List[str]:
    return sorted(f for f, api in _FAMILIES.items()
                  if api.supports_paged_cache)


def get_model(cfg) -> ModelAPI:
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not yet ported "
            f"(ported: {sorted(_FAMILIES)})") from None
