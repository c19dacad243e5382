"""Self-speculative decoding (DESIGN.md §4, §8).

The engine drafts K tokens per round with a second, more aggressively
compressed parameter set of the same checkpoint (a draft profile,
``core/model_compress.py:compress_draft`` or
``models/transformer.py:init_params_and_draft``), then verifies all K in
one multi-token target step and keeps the longest accepted prefix plus a
correction/bonus token. Greedy speculative output is token for token the
greedy non-speculative output (``engine/sampling.py:spec_verify``),
except on the MoE families at a capacity factor that drops routed
entries: which entries drop depends on the whole block a call routes (a
verify routes K+1 or N+1 rows a slot), as in the reference, whose
speculative tokens the port then gives.

    from repro_torch.engine import EngineConfig, InferenceEngine
    from repro_torch.models.transformer import init_params_and_draft
    params, draft = init_params_and_draft(0, cfg, "w4s75", compress=gqsa)
    eng = InferenceEngine(cfg, params, EngineConfig(num_slots=4, spec_k=4),
                          draft_params=draft)

Token-TREE drafting (``EngineConfig.spec_fanout``, ``spec/tree.py``)
spends the verify budget on top-k branches per draft depth and runs the
tree mode of the paged-attention kernel; ``spec_adaptive`` retunes the
tree from the observed acceptance rate.
"""
from repro_torch.engine.spec.drafter import build_draft_fn, spec_step_fns
from repro_torch.engine.spec.tree import (TreeTemplate, build_tree_draft_fn,
                                          build_tree_verify_fn,
                                          compact_accepted, tree_step_fns)
from repro_torch.engine.spec.verify import build_verify_fn

__all__ = ["build_draft_fn", "build_verify_fn", "spec_step_fns",
           "TreeTemplate", "build_tree_draft_fn", "build_tree_verify_fn",
           "compact_accepted", "tree_step_fns"]
