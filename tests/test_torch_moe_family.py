"""Port conformance, the MoE family (``moe``, deepseek-moe-16b) and the
dense-W4 expert axis on both MoE families: the reduced
``deepseek_moe_16b``, initialised (and packed: GQSA W4 S50 G16, or dense
W4 G16) by the JAX reference and carried over through the bridge, on the
same numpy inputs in both packages: the config, W4 packing of the expert
stacks, the experts' plain version against the reference's Pallas kernel
in interpret mode, the MoE block, the whole slice, the engine and the
serve CLI; and the reduced ``deepseek_v2_236b`` under dense W4.

Tolerances (f32, the reduced configs' compute dtype):
  * packing: codes bit-identical, scale/zero to rtol 1e-6 (same min/max,
    one division, round half to even on identical f32 weights);
  * expert products and the MoE block: 1e-5 abs and rel on O(1) values
    (the same dequantized f32 weights; sums differ only in order over
    K <= 96 terms);
  * whole-slice logits: |port - ref| <= 1e-5 x max |ref| per step (two
    layers of order differences of ~1e-7, well inside it);
  * engine: greedy tokens identical wherever the reference's top-2 logit
    margin exceeds 1e-3 (a flip at a nearer tie is not a fault)."""
import dataclasses
import re

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
from repro.core.model_compress import compress_params_w4 as jcompress_w4  # noqa: E402
from repro.core.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core.model_compress import compress_params_w4  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.w4_matmul import w4_matmul_experts_cuda  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

from _torch_utils import (PAGE, assert_greedy_match, engine_prompts,  # noqa: E402
                          jax_tree_to_numpy, reference_margins, serve_all,
                          slice_run)

ARCH = "deepseek_moe_16b"
TOL = dict(rtol=1e-5, atol=1e-5)
W4 = JQuantConfig(bits=4, group_size=16)


def _jw4(jfp, jcfg):
    return jcompress_w4(jfp, jcfg, W4)


@pytest.fixture(scope="module")
def model():
    """{"fp" / "gqsa" / "w4": (jax params, numpy bridge form)} of the
    reduced deepseek-moe-16b, with its jax config under "cfg"."""
    jcfg = jget_config(ARCH, reduced=True)
    jfp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    out = {"cfg": jcfg}
    for name, jp in (("fp", jfp),
                     ("gqsa", jcompress(jfp, jcfg,
                                        JGQSAConfig(saliency="magnitude"))),
                     ("w4", _jw4(jfp, jcfg))):
        out[name] = (jp, jax_tree_to_numpy(jp))
    return out


@pytest.fixture(scope="module")
def v2_w4():
    """(jax config, jax dense-W4 params, numpy bridge form) of the reduced
    DeepSeek-V2."""
    jcfg = jget_config("deepseek_v2_236b", reduced=True)
    jp = _jw4(jtf.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    return jcfg, jp, jax_tree_to_numpy(jp)


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def test_config_matches_reference():
    assert "deepseek_moe_16b" in ARCH_IDS
    for reduced in (False, True):
        j = dataclasses.asdict(jget_config(ARCH, reduced=reduced))
        t = dataclasses.asdict(get_config(ARCH, reduced=reduced))
        assert t == j
    assert "moe" in tregistry.paged_families()


# ---------------------------------------------------------------------------
# packing and the bridge
# ---------------------------------------------------------------------------

def _assert_w4_equal(j, t):
    np.testing.assert_array_equal(t["qw"].numpy(), np.asarray(j["qw"]))
    for f in ("scale", "zero"):
        np.testing.assert_allclose(t[f].numpy(), np.asarray(j[f]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", [ARCH, "deepseek_v2_236b"])
def test_bridge_carries_w4_expert_stacks(model, v2_w4, arch):
    """The reference's dense-W4 tree of an MoE family crosses the bridge
    with its expert stacks intact: qw [L, E, N, K/2] uint8, scale and zero
    [L, E, N, K/G] f32, values unchanged."""
    if arch == ARCH:
        jcfg, (jp, npp) = model["cfg"], model["w4"]
    else:
        jcfg, jp, npp = v2_w4
    tp = params_from_numpy(npp, "cpu")
    moe = jcfg.moe
    for name, (n, k) in (("wg", (moe.d_expert, jcfg.d_model)),
                         ("wd", (jcfg.d_model, moe.d_expert))):
        t = tp["layers"]["moe"]["experts"][name]
        lead = (jcfg.n_layers, moe.n_experts, n)
        assert t["qw"].dtype == torch.uint8
        assert tuple(t["qw"].shape) == lead + (k // 2,)
        for f in ("scale", "zero"):
            assert t[f].dtype == torch.float32
            assert tuple(t[f].shape) == lead + (k // 16,)
        j = jp["layers"]["moe"]["experts"][name]
        for f in ("qw", "scale", "zero"):
            np.testing.assert_array_equal(t[f].numpy(), np.asarray(j[f]))


def test_compress_params_w4_matches_reference(model):
    """The reference's FP tree packed to dense W4 by both packages: the
    [L, E, N, K] expert stacks, the attention and the shared experts
    identical; the router stays FP."""
    jw4 = model["w4"][0]
    tfp = params_from_numpy(model["fp"][1], "cpu")
    tp = compress_params_w4(tfp, get_config(ARCH, reduced=True),
                            QuantConfig(bits=4, group_size=16))["layers"]
    jl = jw4["layers"]
    for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                        ("moe.experts", ("wg", "wu", "wd")),
                        ("moe.shared", ("wg", "wu", "wd"))):
        t, j = tp, jl
        for key in part.split("."):
            t, j = t[key], j[key]
        for name in names:
            assert set(t[name]) == {"qw", "scale", "zero"}
            _assert_w4_equal(j[name], t[name])
    assert tp["moe"]["experts"]["wd"]["qw"].shape == (2, 8, 64, 48)
    assert set(tp["moe"]["router"]) == {"w"}


def test_init_params_packs_w4_experts_as_drawn():
    """init with a QuantConfig (each (layer, expert) slice packed as it is
    drawn) equals packing the FP tree afterwards, on the moe family."""
    cfg = get_config(ARCH, reduced=True)
    qcfg = QuantConfig(bits=4, group_size=16)
    a = compress_params_w4(ttf.init_params(5, cfg, "cpu"), cfg, qcfg)
    b = ttf.init_params(5, cfg, "cpu", compress=qcfg)
    assert torch.equal(a["embed"], b["embed"])
    assert torch.equal(a["lm_head"]["w"], b["lm_head"]["w"])
    for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                        ("moe.experts", ("wg", "wu", "wd")),
                        ("moe.shared", ("wg", "wu", "wd"))):
        na, nb = a["layers"], b["layers"]
        for key in part.split("."):
            na, nb = na[key], nb[key]
        for name in names:
            for f in ("qw", "scale", "zero"):
                assert torch.equal(na[name][f], nb[name][f])
    assert torch.equal(a["layers"]["moe"]["router"]["w"],
                       b["layers"]["moe"]["router"]["w"])


# ---------------------------------------------------------------------------
# the expert axis and the MoE block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("name", ["wg", "wd"])
def test_w4_matmul_experts_ref_matches_reference_kernel(model, name, c):
    """The experts' plain version against ``jax.vmap`` of the reference's
    W4 Pallas kernel (interpret mode) over the stacked experts, rows at
    or past rows[e] masked (and exact zeros in the port)."""
    jw, tw = (_layer(model["w4"][0]["layers"]["moe"]["experts"][name], 1),
              params_from_numpy(model["w4"][1], "cpu")
              ["layers"]["moe"]["experts"][name])
    tw = {f: v[1] for f, v in tw.items()}
    e, n, half = tw["qw"].shape
    k = 2 * half
    x = np.random.default_rng(c).normal(size=(e, c, k)).astype(np.float32)
    rows = np.random.default_rng(9 + c).integers(0, c + 1, e) \
        .astype(np.int32)
    rows[0], rows[1] = 0, c

    def one(xe, qw, s, z):
        return jops.w4_matmul(xe, qw, s, z, group_size=16, use_pallas=True,
                              interpret=True)

    want = np.array(jax.vmap(one)(jnp.asarray(x), jw["qw"], jw["scale"],
                                  jw["zero"]))
    want[np.arange(c)[None, :] >= rows[:, None]] = 0.0
    got = ops.w4_matmul_experts(torch.from_numpy(x), tw["qw"], tw["scale"],
                                tw["zero"], torch.from_numpy(rows),
                                group_size=16)
    assert got.shape == (e, c, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got.numpy()[np.arange(c)[None, :] >= rows[:, None]] == 0).all()
    direct = tref.w4_matmul_experts_ref(torch.from_numpy(x), tw["qw"],
                                        tw["scale"], tw["zero"], None, 16)
    np.testing.assert_allclose(direct.numpy()[rows == c],
                               want[rows == c], **TOL)


@pytest.mark.parametrize("packed", ["w4", "gqsa"])
@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
def test_moe_block_matches_reference(model, packed, capacity_factor):
    """The block (route, dispatch with drops, the expert axis, the fused
    shared SwiGLU) with dense-W4 and GQSA experts, padding rows
    included."""
    def with_cf(cfg):
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    jcfg, tcfg = with_cf(model["cfg"]), with_cf(get_config(ARCH,
                                                           reduced=True))
    jp, npp = model[packed]
    jl = _layer(jp["layers"]["moe"], 1)
    tl = params_from_numpy(npp, "cpu")["layers"]["moe"]
    tl = ttf.layer_params(tl, 1)
    x = np.random.default_rng(2).normal(size=(3, 5, 64)).astype(np.float32)
    x[1, 3:] = 0.0
    want, jaux = jmoe.moe_block(jl, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_block(tl, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_w4_experts_wrapper_never_falls_back(model):
    """The CUDA wrapper refuses a CPU tensor; the dispatcher raises for a
    device with no kernel; nothing was launched."""
    tw = params_from_numpy(model["w4"][1], "cpu")["layers"]["moe"][
        "experts"]["wg"]
    tw = {f: v[0] for f, v in tw.items()}
    x = torch.zeros((8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        w4_matmul_experts_cuda(x, tw["qw"], tw["scale"], tw["zero"], None,
                               16)
    with pytest.raises(ValueError, match="no kernel"):
        ops.w4_matmul_experts(x.to("meta"), tw["qw"], tw["scale"],
                              tw["zero"], group_size=16)
    assert w4_matmul_experts_cuda.launches == 0
    assert w4_matmul_experts_cuda.tc_launches == 0


# ---------------------------------------------------------------------------
# the whole slice, the engine and the CLI
# ---------------------------------------------------------------------------

def _assert_slice_close(steps, act):
    for j, t in steps:
        assert t.shape == j.shape and np.isfinite(t[act]).all()
        bar = 1e-5 * np.abs(j[act]).max()
        np.testing.assert_allclose(t[act], j[act], rtol=0, atol=bar)


@pytest.mark.parametrize("packed", ["fp", "gqsa", "w4"])
def test_prefill_and_decode_logits_match_reference(model, packed):
    """Paged prefill and 6 teacher-forced decode steps of the K/V pool
    (attention is the dense family's GQA path)."""
    jp, npp = model[packed]
    _assert_slice_close(*slice_run(model["cfg"], jp,
                                   get_config(ARCH, reduced=True),
                                   params_from_numpy(npp, "cpu"), steps=6))


def test_deepseek_v2_w4_logits_match_reference(v2_w4):
    """DeepSeek-V2 (``mla_moe``) under dense W4: its routed experts run
    the W4 expert axis, its MLA projections ``w4_matmul``."""
    jcfg, jp, npp = v2_w4
    _assert_slice_close(*slice_run(
        jcfg, jp, get_config("deepseek_v2_236b", reduced=True),
        params_from_numpy(npp, "cpu"), steps=6))


@pytest.mark.parametrize("packed,kv", [("gqsa", "bfloat16"),
                                       ("w4", "bfloat16"),
                                       ("fp", "int8")])
def test_engine_greedy_tokens_match_reference(model, packed, kv):
    """Greedy engine tokens under GQSA and dense W4, and with the int8
    pool (against the reference's int8 kernel path, FP weights so that
    only its attention runs in interpret mode)."""
    jp, npp = model[packed]
    jcfg = dataclasses.replace(model["cfg"], kv_cache_dtype=kv)
    tcfg = dataclasses.replace(get_config(ARCH, reduced=True),
                               kv_cache_dtype=kv)
    prompts, max_new = engine_prompts(jcfg.vocab), 8
    ref = serve_all(JInferenceEngine(jcfg, jp, JEngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE, use_pallas=kv == "int8")),
        prompts, max_new)
    eng = InferenceEngine(tcfg, params_from_numpy(npp, "cpu"), EngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE, device="cpu"))
    if kv == "int8":
        assert eng.kv.data["k_pages"].dtype == torch.int8
    got = serve_all(eng, prompts, max_new)
    assert_greedy_match(ref, got, prompts,
                        reference_margins(jcfg, jp, prompts, ref, max_new),
                        max_new)


@pytest.mark.parametrize("compress,banner", [("w4", "packed W4"),
                                             ("gqsa", "packed GQSA")])
def test_serve_cli_serves_deepseek_moe_on_cpu(capsys, compress, banner):
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--compress", compress, "--requests", "3",
                      "--max-new", "4", "--slots", "2"])
    out = capsys.readouterr().out
    assert re.search(r"^\[digest\] [0-9a-f]{64}$", out, re.M)
    assert banner in out
    assert len(res["results"]) == 3
    assert all(len(r["tokens"]) == 4 for r in res["results"])


def test_engine_serves_speculation_on_moe():
    """The engine builds and serves chain speculation (K = 2) on the
    port's own drawn weights and the w4l50 draft packed from the same
    draws (the conformance against the reference is
    ``tests/test_torch_spec_moe.py``)."""
    from repro_torch.core.model_compress import draft_layers
    cfg = get_config(ARCH, reduced=True)
    params, draft = ttf.init_params_and_draft(0, cfg, "w4l50", "cpu")
    eng = InferenceEngine(cfg, params, EngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE, device="cpu", spec_k=2,
        spec_draft_layers=draft_layers(cfg, "w4l50")), draft_params=draft)
    got = serve_all(eng, engine_prompts(cfg.vocab), 6)
    assert len(got) == 5 and all(len(t) == 6 for t in got.values())
    assert eng.metrics.summary()["spec_rounds"] > 0
    assert eng.kv.allocator.num_free == eng.kv.num_pages
