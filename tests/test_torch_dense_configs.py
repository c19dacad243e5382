"""Port conformance, the reference's other dense configs: the reduced
yi-34b, starcoder2-3b (GELU MLP), qwen3-14b (``qk_norm``, head_dim set)
and mistral-nemo-12b (head_dim set), initialised and GQSA-packed (W4 S50
G16) by the JAX reference and carried over through the bridge, run
batched prefill, teacher-forced decode steps and the serving engine in
both packages on the same inputs.

Tolerances, those of ``tests/test_torch_model.py``:
  * f32 (the reduced configs' compute dtype): logits agree to 1e-4 abs;
  * bf16: logits agree to 2e-2 abs (the reference's decode attention
    contracts bf16 operands, the port's runs in f32: ROADMAP.md C.3);
  * engine: greedy tokens identical wherever the reference's top-2 logit
    margin exceeds 1e-3; a flip at a nearer tie is not a fault."""
import copy
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
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402

from _torch_utils import (PAGE, assert_greedy_match, engine_prompts,  # noqa: E402
                          jax_tree_to_numpy, reference_margins, serve_all,
                          slice_run)

ARCHS = ["yi_34b", "starcoder2_3b", "qwen3_14b", "mistral_nemo_12b"]

_CACHE = {}


def _packed(arch, random_norms=False):
    """(jax cfg, jax GQSA params, numpy bridge form) of the reduced
    ``arch``; with ``random_norms`` qwen3-14b's ``q_norm`` / ``k_norm``
    hold random weights (drawn 1 + N(0, 0.5) with numpy) instead of ones,
    so that the norms are exercised, not only applied."""
    key = (arch, random_norms)
    if key not in _CACHE:
        jcfg = jget_config(arch, reduced=True)
        jp = jcompress(jtf.init_params(jax.random.PRNGKey(0), jcfg), jcfg,
                       JGQSAConfig())
        if random_norms:
            g = np.random.default_rng(7)
            jp = copy.copy(jp)
            jp["layers"] = dict(jp["layers"])
            attn = dict(jp["layers"]["attn"])
            for name in ("q_norm", "k_norm"):
                shape = attn[name].shape
                attn[name] = jnp.asarray(
                    1.0 + 0.5 * g.normal(size=shape).astype(np.float32))
            jp["layers"]["attn"] = attn
        _CACHE[key] = (jcfg, jp, jax_tree_to_numpy(jp))
    return _CACHE[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_port_draws_the_reference_layout(arch):
    """The port's own init draws the reference's tree: the same leaves,
    shapes and dtypes (GELU: no wg; qk_norm: [L, hd] norms of ones; head
    widths from head_dim)."""
    from repro_torch.models import transformer as ttf
    jcfg = jget_config(arch, reduced=True)
    want = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        jtf.init_params(jax.random.PRNGKey(0), jcfg))
    tp = ttf.init_params(0, get_config(arch, reduced=True), "cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    assert shapes(tp) == want
    if jcfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            assert torch.equal(tp["layers"]["attn"][name],
                               torch.ones(jcfg.n_layers, jcfg.hd))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 2e-2)])
def test_prefill_and_decode_logits_match_reference(arch, dtype, atol):
    jcfg, jp, npp = _packed(arch)
    steps, act = slice_run(dataclasses.replace(jcfg, dtype=dtype), jp,
                           dataclasses.replace(get_config(arch, reduced=True),
                                               dtype=dtype),
                           params_from_numpy(npp, "cpu"), steps=4)
    for j, t in steps:
        assert t.shape == j.shape and np.isfinite(t[act]).all()
        np.testing.assert_allclose(t[act], j[act], rtol=0, atol=atol)


def test_qk_norm_with_random_norms_matches_reference():
    """qwen3-14b with random q_norm / k_norm: prefill and decode logits
    (f32) against the reference's, and the norms change the logits."""
    jcfg, jp, npp = _packed("qwen3_14b", random_norms=True)
    tcfg = get_config("qwen3_14b", reduced=True)
    steps, act = slice_run(jcfg, jp, tcfg, params_from_numpy(npp, "cpu"),
                           steps=4)
    ones, _ = slice_run(jcfg, _packed("qwen3_14b")[1], tcfg,
                        params_from_numpy(_packed("qwen3_14b")[2], "cpu"),
                        steps=0)
    for j, t in steps:
        np.testing.assert_allclose(t[act], j[act], rtol=0, atol=1e-4)
    assert np.abs(steps[0][1][act] - ones[0][1][act]).max() > 1e-2


def _engines(jcfg, jp, npp, arch):
    prompts, max_new = engine_prompts(jcfg.vocab), 8
    ref = serve_all(JInferenceEngine(jcfg, jp, JEngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE)), prompts, max_new)
    got = serve_all(InferenceEngine(get_config(arch, reduced=True),
                                    params_from_numpy(npp, "cpu"),
                                    EngineConfig(num_slots=2, max_seq=32,
                                                 page_size=PAGE,
                                                 device="cpu")),
                    prompts, max_new)
    assert_greedy_match(ref, got, prompts,
                        reference_margins(jcfg, jp, prompts, ref, max_new),
                        max_new)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_reference(arch):
    _engines(*_packed(arch), arch)


def test_engine_with_random_qk_norms_matches_reference():
    _engines(*_packed("qwen3_14b", random_norms=True), "qwen3_14b")
