"""Port conformance, the dense-W4 baseline (``--compress w4``): packing,
the ``w4_matmul`` kernel's plain version, the whole reduced llama2-7b
slice and the serving engine against the JAX reference on the same numpy
inputs.

Tolerances:
  * packing: codes bit-identical (same min/max, one division, round half
    to even on identical f32 weights), scale/zero to rtol 1e-6;
  * ``w4_matmul``: 1e-5 abs and rel in f32 (the same dequantized f32
    weights; sums differ only in order over K <= 256 terms of O(1));
  * slice logits: 1e-4 abs in f32, 2e-2 in bf16 (the bars of
    ``tests/test_torch_model.py``, for the same reasons);
  * engine: greedy tokens identical wherever the top-2 margin exceeds
    1e-3."""
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
from repro.core.gqs_layer import pack_w4 as jpack_w4  # noqa: E402
from repro.core.model_compress import compress_params_w4 as jcompress_w4  # noqa: E402
from repro.core.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.gqs_layer import pack_w4  # noqa: E402
from repro_torch.core.model_compress import compress_params_w4  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402

from _torch_utils import (PAGE, assert_greedy_match, engine_prompts,  # noqa: E402
                          jax_tree_to_numpy, port_greedy_margins,
                          serve_all, slice_run)

TOL = dict(rtol=1e-5, atol=1e-5)
W4 = ("wq", "wk", "wv", "wo"), ("wg", "wu", "wd")


def _assert_w4_equal(j, t):
    """A reference W4 node (numpy) and the port's (torch)."""
    np.testing.assert_array_equal(t["qw"].numpy(), np.asarray(j["qw"]))
    for f in ("scale", "zero"):
        np.testing.assert_allclose(t[f].numpy(), np.asarray(j[f]),
                                   rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def w4_model():
    """(jax cfg, jax W4 params, numpy bridge form) of the reduced model."""
    jcfg = jget_config("llama2_7b", reduced=True)
    jp = jcompress_w4(jtf.init_params(jax.random.PRNGKey(0), jcfg), jcfg,
                      JQuantConfig(bits=4, group_size=16))
    return jcfg, jp, jax_tree_to_numpy(jp)


@pytest.mark.parametrize("n,k,g", [(48, 256, 16), (32, 128, 32),
                                   (16, 96, 6)])
def test_pack_w4_matches_reference(n, k, g):
    w = np.random.default_rng(n + g).normal(size=(n, k)).astype(np.float32)
    j = jpack_w4(jnp.asarray(w), JQuantConfig(bits=4, group_size=g))
    t = pack_w4(torch.from_numpy(w), QuantConfig(bits=4, group_size=g))
    assert t["qw"].dtype == torch.uint8 and t["qw"].shape == (n, k // 2)
    assert t["scale"].shape == t["zero"].shape == (n, k // g)
    _assert_w4_equal(j, t)


def test_pack_w4_refuses_more_than_four_bits():
    w = torch.zeros((4, 32))
    with pytest.raises(ValueError, match="bits must be <= 4"):
        pack_w4(w, QuantConfig(bits=8, group_size=16))
    with pytest.raises(ValueError, match="bits must be <= 4"):
        jpack_w4(jnp.zeros((4, 32)), JQuantConfig(bits=8, group_size=16))


def test_compress_params_w4_matches_reference(w4_model):
    """The reference's FP init, packed by both packages: every stacked W4
    leaf identical; embeddings and lm_head stay FP."""
    jcfg, jp, _ = w4_model
    jfp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tfp = params_from_numpy(jax_tree_to_numpy(jfp), "cpu")
    tp = compress_params_w4(tfp, get_config("llama2_7b", reduced=True),
                            QuantConfig(bits=4, group_size=16))
    for blk, names in zip(("attn", "mlp"), W4):
        for name in names:
            t = tp["layers"][blk][name]
            assert set(t) == {"qw", "scale", "zero"}
            assert t["qw"].shape[0] == jcfg.n_layers
            _assert_w4_equal(jp["layers"][blk][name], t)
    assert torch.equal(tp["lm_head"]["w"], tfp["lm_head"]["w"])


def test_init_params_packs_w4_layer_by_layer():
    """init with a QuantConfig (pack each layer as it is drawn) equals
    packing the whole FP tree afterwards."""
    cfg = dataclasses.replace(get_config("llama2_7b", reduced=True),
                              n_layers=3)
    qcfg = QuantConfig(bits=4, group_size=16)
    a = compress_params_w4(init_params(7, cfg, "cpu"), cfg, qcfg)
    b = init_params(7, cfg, "cpu", compress=qcfg)
    assert torch.equal(a["embed"], b["embed"])
    for blk, names in zip(("attn", "mlp"), W4):
        for name in names:
            for f in ("qw", "scale", "zero"):
                assert torch.equal(a["layers"][blk][name][f],
                                   b["layers"][blk][name][f])


@pytest.mark.parametrize("g", [16, 32])
@pytest.mark.parametrize("t", [1, 5, 33])
def test_w4_matmul_plain_matches_reference(t, g):
    n, k = 40, 256
    rng = np.random.default_rng(t + g)
    w = rng.normal(size=(n, k)).astype(np.float32)
    x = rng.normal(size=(t, k)).astype(np.float32)
    jp = jpack_w4(jnp.asarray(w), JQuantConfig(bits=4, group_size=g))
    tp = params_from_numpy(jax_tree_to_numpy(jp), "cpu")
    y = ops.w4_matmul(torch.from_numpy(x), tp["qw"], tp["scale"],
                      tp["zero"], group_size=g).numpy()
    jargs = (jnp.asarray(x), jp["qw"], jp["scale"], jp["zero"])
    y_ker = np.asarray(jops.w4_matmul(*jargs, group_size=g, use_pallas=True,
                                      interpret=True))
    y_ref = np.asarray(jref.w4_matmul_ref(*jargs, g))
    assert y.shape == (t, n) and y.dtype == np.float32
    np.testing.assert_allclose(y, y_ker, **TOL)
    np.testing.assert_allclose(y, y_ref, **TOL)


def test_w4_matmul_plain_bf16_activations():
    """bf16 x is widened to f32 exactly on both sides."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(24, 128)).astype(np.float32)
    x = rng.normal(size=(4, 128)).astype(np.float32)
    jp = jpack_w4(jnp.asarray(w), JQuantConfig(bits=4, group_size=16))
    tp = params_from_numpy(jax_tree_to_numpy(jp), "cpu")
    y = ops.w4_matmul(torch.from_numpy(x).to(torch.bfloat16), tp["qw"],
                      tp["scale"], tp["zero"], group_size=16)
    y_ref = jref.w4_matmul_ref(jnp.asarray(x).astype(jnp.bfloat16),
                               jp["qw"], jp["scale"], jp["zero"], 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 2e-2)])
def test_w4_prefill_and_decode_logits_match_reference(w4_model, dtype,
                                                      atol):
    jcfg, jp, npp = w4_model
    steps, act = slice_run(
        dataclasses.replace(jcfg, dtype=dtype), jp,
        dataclasses.replace(get_config("llama2_7b", reduced=True),
                            dtype=dtype),
        params_from_numpy(npp, "cpu"))
    for j, t in steps:
        assert t.shape == j.shape and np.isfinite(t[act]).all()
        np.testing.assert_allclose(t[act], j[act], rtol=0, atol=atol)


def test_w4_engine_greedy_tokens_match_reference(w4_model):
    jcfg, jp, npp = w4_model
    tcfg = get_config("llama2_7b", reduced=True)
    tp = params_from_numpy(npp, "cpu")
    prompts, max_new = engine_prompts(jcfg.vocab), 8
    ref = serve_all(JInferenceEngine(jcfg, jp, JEngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE)), prompts, max_new)
    got = serve_all(InferenceEngine(tcfg, tp, EngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE, device="cpu")),
        prompts, max_new)
    assert_greedy_match(
        ref, got, prompts,
        lambda rid: port_greedy_margins(tcfg, tp, prompts[rid], ref[rid]),
        max_new)
