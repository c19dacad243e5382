"""Port conformance, whole slice: the reduced llama2-7b, initialised and
GQSA-packed (W4 S50 G16) by the JAX reference and carried over through the
bridge, runs batched prefill, teacher-forced decode steps and the serving
engine in both packages on the same inputs.

Tolerances:
  * f32 (the reduced config's compute dtype): logits agree to 1e-4 abs.
    The two sides compute the same f32 math and differ only in summation
    order; logits are O(0.1).
  * bf16 (the full-width compute dtype): logits agree to 2e-2 abs. Both
    sides round activations to bf16 (relative step 2^-8) at every layer
    boundary, but at different points inside attention (the reference's
    decode attention contracts bf16 operands, the port's paged attention
    runs in f32), so single-ulp differences of O(1) activations carry
    through two layers into the logits (measured: 6e-3 on logits of
    magnitude 0.55).
  * engine: greedy tokens identical wherever the reference's top-2 logit
    margin exceeds 1e-3; a flip at a nearer tie is not a fault."""
import dataclasses

import numpy as np
import pytest
import torch

# the suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps these small products from crowding the other files
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.gqs_layer import GQSAConfig as JGQSAConfig  # noqa: E402
from repro.core.model_compress import compress_params as jcompress  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.gqs_layer import GQSAConfig  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

from _torch_utils import (PAGE, assert_greedy_match, engine_prompts,  # noqa: E402
                          jax_tree_to_numpy, serve_all, slice_run)

@pytest.fixture(scope="module")
def packed():
    """(jax cfg, jax params, numpy bridge form) of the reduced model."""
    jcfg = jget_config("llama2_7b", reduced=True)
    jp = jcompress(jtf.init_params(jax.random.PRNGKey(0), jcfg), jcfg,
                   JGQSAConfig())
    return jcfg, jp, jax_tree_to_numpy(jp)


def _slice_run(packed, dtype, steps=8):
    """Prefill 3 slots (one inactive: length 0, sentinel table) and feed
    ``steps`` teacher-forced tokens; returns per-step logits of both."""
    jcfg, jp, npp = packed
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(get_config("llama2_7b", reduced=True),
                               dtype=dtype)
    return slice_run(jcfg, jp, tcfg, params_from_numpy(npp, "cpu"), steps)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 2e-2)])
def test_prefill_and_decode_logits_match_reference(packed, dtype, atol):
    steps, act = _slice_run(packed, dtype)
    for j, t in steps:
        assert t.shape == j.shape and np.isfinite(t[act]).all()
        np.testing.assert_allclose(t[act], j[act], rtol=0, atol=atol)


def test_decode_writes_pool_in_place():
    """A decode step with an inactive slot at a stale position writes only
    the active slots' positions, in place; every other page row keeps its
    bytes (the pool is cloned first)."""
    cfg = get_config("llama2_7b", reduced=True)
    params = ttf.init_params(3, cfg, "cpu")
    cache = ttf.init_paged_cache(cfg, 6, 4, device="cpu")
    g = torch.Generator().manual_seed(0)
    for k in cache:
        cache[k].normal_(generator=g)
    before = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    # slot 0 writes position 5 -> page 4, offset 1; slot 1 is inactive
    # (all-sentinel row) with a stale position past its table
    bt = torch.tensor([[2, 4], [6, 6]], dtype=torch.int32)
    pos = torch.tensor([5, 37], dtype=torch.int32)
    ttf.decode_step(params, cache, torch.tensor([[3], [9]]), pos, cfg, bt)
    for k in cache:
        assert cache[k].data_ptr() == ptrs[k]
        changed = (cache[k] != before[k]).flatten(3).any(-1)  # [L, P, ps]
        expect = torch.zeros_like(changed)
        expect[:, 4, 1] = True
        assert torch.equal(changed, expect), k


def test_prefill_and_decode_never_read_the_device_on_the_host():
    """Neither step reads a tensor's value on the host (``.item()``, a
    0-dim tensor used as an index, ...): each such read is a host-device
    sync per call, and the engine relies on steps that only enqueue. The
    profiler counts the reads on the CPU as it would on the card."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config("llama2_7b", reduced=True)
    params = ttf.init_params(0, cfg, "cpu", compress=GQSAConfig())
    cache = ttf.init_paged_cache(cfg, 8, 4, device="cpu")
    bt = torch.tensor([[0, 1, 2], [8, 8, 8]], dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ttf.prefill(params, cache, torch.tensor([[5, 6, 7, 0], [0] * 4]),
                    torch.tensor([3, 0]), bt, cfg)
        ttf.decode_step(params, cache, torch.tensor([[1], [2]]),
                        torch.tensor([3, 0], dtype=torch.int32), cfg, bt,
                        max_live_pages=2)
    reads = [e.key for e in prof.key_averages()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads


def test_engine_greedy_tokens_match_reference(packed):
    jcfg, jp, npp = packed
    tcfg = get_config("llama2_7b", reduced=True)
    prompts, max_new = engine_prompts(jcfg.vocab), 8
    ref = serve_all(JInferenceEngine(jcfg, jp, JEngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE)), prompts, max_new)
    got = serve_all(InferenceEngine(tcfg, params_from_numpy(npp, "cpu"),
                                    EngineConfig(num_slots=2, max_seq=32,
                                                 page_size=PAGE,
                                                 device="cpu")),
                    prompts, max_new)
    # the reference's own logits along its greedy paths (teacher-forced)
    seqs = [np.concatenate([p, ref[i]]) for i, p in enumerate(prompts)]
    padded = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, s in enumerate(seqs):
        padded[i, :len(s)] = s
    logits, _ = jtf.forward(jp, jnp.asarray(padded), jcfg)
    logits = np.asarray(logits)

    def margins(rid):
        start = len(prompts[rid]) - 1
        rows = np.sort(logits[rid, start:start + max_new], axis=-1)
        return rows[:, -1] - rows[:, -2]

    assert_greedy_match(ref, got, prompts, margins, max_new)
