"""Port conformance, the int8 paged KV pool (``kv_cache_dtype="int8"``):
quantization, the paged-attention kernel's int8 mode (plain version), the
pool layout and contents, the whole reduced llama2-7b slice and the
serving engine against the JAX reference on the same numpy inputs.

The port computes the kernel's math on every device: each int8 tile is
dequantized (code * scale) and the contractions run in f32. The
reference computes that math in its Pallas kernel (``use_pallas=True``,
interpret mode here), and something else on its jnp path, which
re-quantizes q and the softmax weights for int8 x int8 products
(``decode_attention_int8``). Tolerances:
  * ``quantize_kv``: codes and scales bit-identical (same f32 amax, one
    division, round half to even);
  * attention: 1e-5 abs and rel in f32 (same dequantized f32 operands);
  * slice logits: 1e-4 abs against the reference's kernel path (f32),
    0.05 abs against its jnp path (the bar of the reference's own
    ``test_decode_step_int8_pallas_close_to_fallback``: re-quantization
    noise);
  * engine: greedy tokens identical wherever the top-2 margin exceeds
    1e-3.

The reference's packed-GQSA GEMV cannot run inside its layer scan with
``use_pallas=True`` (its work list needs concrete indices), so the
comparisons against its kernel path run on the FP model; the others run
on the GQSA W4 S50 model."""
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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import quantize_kv as jquantize_kv  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import quantize_kv  # noqa: E402

from _torch_utils import (PAGE, assert_greedy_match,  # noqa: E402
                          engine_prompts, jax_tree_to_numpy, prefill_both,
                          port_greedy_margins, serve_all, slice_inputs,
                          slice_run)

TOL = dict(rtol=1e-5, atol=1e-5)
SCALES = ("k_scale_pages", "v_scale_pages")


def _cfgs(dtype="float32"):
    """(reference, port) reduced llama2-7b configs with the int8 pool."""
    return tuple(dataclasses.replace(get("llama2_7b", reduced=True),
                                     dtype=dtype, kv_cache_dtype="int8")
                 for get in (jget_config, get_config))


@pytest.fixture(scope="module")
def models():
    """(jax FP params, jax GQSA params, and their numpy bridge forms) of
    the reduced model."""
    jcfg = jget_config("llama2_7b", reduced=True)
    jfp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    jgq = jcompress(jfp, jcfg, JGQSAConfig())
    return jfp, jgq, jax_tree_to_numpy(jfp), jax_tree_to_numpy(jgq)


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_kv_matches_reference(dtype):
    x = np.random.default_rng(0).normal(size=(3, 2, 4, 16)) \
        .astype(np.float32) * 3
    x[1, 0, 2] = 0.0                         # amax floor (1e-6)
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jq, js = jquantize_kv(jx)
    tq, ts = quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.shape == x.shape and ts.shape == x.shape[:-1]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert _bits_equal(ts.numpy(), js)


def _int8_case(seed, b, t, kh, r, d, ps, mp, num_pages):
    """Quantized pages over a shuffled pool, sentinel tails, one
    all-sentinel slot (length 0) and staircase lengths [B, T]."""
    g = np.random.default_rng(seed)
    q = g.normal(size=(b, t, kh * r, d)).astype(np.float32)
    kp, ks = jquantize_kv(jnp.asarray(
        g.normal(size=(num_pages, ps, kh, d)).astype(np.float32)))
    vp, vs = jquantize_kv(jnp.asarray(
        g.normal(size=(num_pages, ps, kh, d)).astype(np.float32)))
    pages = g.permutation(num_pages)[:b * mp].reshape(b, mp).astype(np.int32)
    occ = g.integers(1, mp + 1, size=b)
    occ[-1] = 0                                  # all-sentinel slot
    bt = np.where(np.arange(mp)[None, :] < occ[:, None], pages, num_pages)
    lengths = np.zeros((b, t), np.int32)
    for i in range(b - 1):
        lengths[i] = np.sort(g.integers(1, occ[i] * ps + 1, size=t))
    return tuple(np.array(a) for a in (q, kp, vp, lengths,
                                         bt.astype(np.int32), ks, vs))


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("kh,r", [(4, 1), (2, 2)])
def test_paged_attention_int8_plain_matches_reference(t, kh, r):
    case = _int8_case(5 * t + kh, b=4, t=t, kh=kh, r=r, d=32, ps=8, mp=4,
                      num_pages=20)
    q, kp, vp, lengths, bt, ks, vs = map(torch.from_numpy, case)
    assert kp.dtype == torch.int8
    o = ops.paged_decode_attention(q, kp, vp, lengths, bt, ks, vs).numpy()
    jargs = tuple(map(jnp.asarray, case))
    o_ker = np.asarray(jops.paged_decode_attention(
        *jargs, use_pallas=True, interpret=True))
    o_ref = np.asarray(jref.paged_attention_ref(*jargs))
    assert o.shape == (4, t, kh * r, 32)
    # length-0 rows: exact zeros in the port and in the TPU kernel; the
    # reference's oracle returns NaN there
    assert np.all(o[-1] == 0.0) and np.all(o_ker[-1] == 0.0)
    np.testing.assert_allclose(o, o_ker, **TOL)
    np.testing.assert_allclose(o[:-1], o_ref[:-1], **TOL)


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_init_paged_cache_layout_matches_reference(kv):
    """The pool follows ``kv_cache_dtype``: int8 codes beside f32 scale
    pages, or the compute dtype (a bf16 pool under an int8 config was
    the fault this pins)."""
    jcfg, tcfg = (dataclasses.replace(c, kv_cache_dtype=kv)
                  for c in _cfgs("bfloat16"))
    j = jtf.init_paged_cache(jcfg, 6, 4)
    t = ttf.init_paged_cache(tcfg, 6, 4, device="cpu")
    assert sorted(t) == sorted(j)
    for name, leaf in t.items():
        assert tuple(leaf.shape) == j[name].shape
        assert str(leaf.dtype).replace("torch.", "") == str(j[name].dtype)
        assert not leaf.any()
    assert (t["k_pages"].dtype == torch.int8) == (kv == "int8")


def test_int8_pool_after_prefill_matches_reference(models):
    """Batched prefill quantizes every layer's K/V into the pool: scales
    agree to 1e-6 and codes exactly, except where the two packages' f32
    K/V straddle a rounding boundary (one step); rows never written
    (padding, the inactive slot) stay zero in both."""
    _, jgq, _, ngq = models
    jcfg, tcfg = _cfgs()
    tokens, lengths, bt, _ = slice_inputs(jcfg.vocab, 0)
    _, jcache, _, tcache = prefill_both(
        jcfg, jgq, tcfg, params_from_numpy(ngq, "cpu"), tokens, lengths,
        bt)
    for name in SCALES:
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=1e-6,
                                   atol=0)
    written = np.asarray(jcache["k_scale_pages"]) > 0
    assert written.sum() == jcfg.n_layers * lengths.sum() * jcfg.n_kv_heads
    for name in ("k_pages", "v_pages"):
        t = tcache[name].numpy().astype(np.int32)
        j = np.asarray(jcache[name]).astype(np.int32)
        assert tcache[name].dtype == torch.int8
        assert np.abs(t - j).max() <= 1
        assert (t == j).mean() > 0.999
        assert not t[~written].any() and not j[~written].any()


def test_int8_decode_logits_match_reference_kernel_path(models):
    jfp, _, nfp, _ = models
    jcfg, tcfg = _cfgs()
    steps, act = slice_run(jcfg, jfp, tcfg, params_from_numpy(nfp, "cpu"),
                           steps=4, use_pallas=True)
    for j, t in steps:
        assert t.shape == j.shape and np.isfinite(t[act]).all()
        np.testing.assert_allclose(t[act], j[act], rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_decode_logits_close_to_reference_jnp_path(models, dtype):
    _, jgq, _, ngq = models
    jcfg, tcfg = _cfgs(dtype)
    steps, act = slice_run(jcfg, jgq, tcfg, params_from_numpy(ngq, "cpu"))
    for j, t in steps:
        assert t.shape == j.shape and np.isfinite(t[act]).all()
        np.testing.assert_allclose(t[act], j[act], rtol=0, atol=0.05)


def test_int8_engine_greedy_tokens_match_reference(models):
    jfp, _, nfp, _ = models
    jcfg, tcfg = _cfgs()
    tp = params_from_numpy(nfp, "cpu")
    prompts, max_new = engine_prompts(jcfg.vocab), 8
    ref = serve_all(JInferenceEngine(jcfg, jfp, JEngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE, use_pallas=True)),
        prompts, max_new)
    eng = InferenceEngine(tcfg, tp, EngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE, device="cpu"))
    assert eng.kv.data["k_pages"].dtype == torch.int8
    assert set(SCALES) <= set(eng.kv.data)
    got = serve_all(eng, prompts, max_new)
    assert_greedy_match(
        ref, got, prompts,
        lambda rid: port_greedy_margins(tcfg, tp, prompts[rid], ref[rid]),
        max_new)
