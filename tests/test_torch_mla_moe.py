"""Port conformance, MLA + MoE (``mla_moe``, DeepSeek-V2): the reduced
``deepseek_v2_236b``, initialised (and GQSA-packed, W4 S50 G16) by the JAX
reference and carried over through the bridge, on the same numpy inputs
in both packages: routing and dispatch, the MoE block, MLA prefill and
absorbed decode on the latent pool, the latent attention oracle against
the reference's oracle and its Pallas kernel in interpret mode, the whole
slice, the engine and the serve CLI.

Tolerances (f32, the reduced config's compute dtype):
  * expert ids and drops: exact (routing is the same f32 math; the test
    inputs have no router near-ties except the exact ties they pin);
  * MoE, MLA and attention outputs: 1e-5 abs on O(1) values: the two sides
    run the same f32 products and differ only in summation order;
  * whole-slice logits: |port - ref| <= 2e-4 x max |ref| per step: the
    order differences pass through two layers of attention, routing and
    the unembedding;
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
from repro.engine.spec import TreeTemplate as JTreeTemplate  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.gqs_layer import GQSAConfig, apply_linear_experts  # noqa: E402
from repro_torch.core.model_compress import compress_params  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.engine.spec import TreeTemplate  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.gqsa_gemv import gqsa_gemv_experts_cuda  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_cuda  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

from _torch_utils import (PAGE, assert_greedy_match, engine_prompts,  # noqa: E402
                          jax_tree_to_numpy, reference_margins, serve_all,
                          slice_run)

ARCH = "deepseek_v2_236b"
ATOL = 1e-5


def _np_layer(tree, i):
    """Layer ``i`` of a bridge-form stacked tree (BSR dicts included)."""
    if isinstance(tree, dict) and "idx" in tree and "shape" in tree:
        return {k: (v[i] if k in ("idx", "vals", "scale", "zero") else v)
                for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: _np_layer(v, i) for k, v in tree.items()}
    return tree[i]


@pytest.fixture(scope="module")
def model():
    """(jax cfg, FP jax params, packed jax params, bridge forms)."""
    jcfg = jget_config(ARCH, reduced=True)
    jfp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    jpk = jcompress(jfp, jcfg, JGQSAConfig(saliency="magnitude"))
    return jcfg, jfp, jpk, jax_tree_to_numpy(jfp), jax_tree_to_numpy(jpk)


def _layer(model, packed, part, i=0):
    """(jax params, port params) of one layer's ``part`` ("attn"/"moe")."""
    _, jfp, jpk, nfp, npk = model
    jp = jpk if packed else jfp
    jl = jax.tree_util.tree_map(lambda a: a[i], jp["layers"][part])
    tl = params_from_numpy(_np_layer((npk if packed else nfp)["layers"][part],
                                     i), "cpu")
    return jl, tl


def _close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def test_config_matches_reference():
    for reduced in (False, True):
        j = dataclasses.asdict(jget_config(ARCH, reduced=reduced))
        t = dataclasses.asdict(get_config(ARCH, reduced=reduced))
        assert t == j


# ---------------------------------------------------------------------------
# routing and dispatch
# ---------------------------------------------------------------------------

def _router_inputs(d=64, e=8, t=12, seed=0, ties=False):
    g = np.random.default_rng(seed)
    w = (g.normal(size=(e, d)) / np.sqrt(d)).astype(np.float32)
    x = g.normal(size=(t, d)).astype(np.float32)
    if ties:
        # experts 5 and 2 (and 7 and 1) have identical router rows: their
        # probabilities tie exactly for every token
        w[5], w[7] = w[2], w[1]
    return w, x


@pytest.mark.parametrize("ties", [False, True])
def test_route_matches_reference(ties):
    cfg = get_config(ARCH, reduced=True)
    w, x = _router_inputs(ties=ties)
    jg, ji, jaux = jmoe._route({"w": jnp.asarray(w)}, jnp.asarray(x),
                               cfg.moe)
    tg, ti, taux = tmoe.route({"w": torch.from_numpy(w)},
                              torch.from_numpy(x), cfg.moe)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg, 1e-6)
    _close(taux, jaux, 1e-6)


def test_route_breaks_ties_toward_the_lower_expert_id():
    """Two experts with one router row: the lower id is taken first, as
    ``jax.lax.top_k`` takes it; with top-k = 1 only it is picked."""
    moe = dataclasses.replace(get_config(ARCH, reduced=True).moe, top_k=1)
    w, x = _router_inputs(ties=True)
    w[:] = w[2]                                  # every expert ties
    _, ti, _ = tmoe.route({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                          moe)
    _, ji, _ = jmoe._route({"w": jnp.asarray(w)}, jnp.asarray(x), moe)
    assert (ti == 0).all() and (np.asarray(ji) == 0).all()


def _dispatch_case(kind, t=10, d=64, e=8, seed=1):
    """(x, gates, ids) for dispatch: ``drops`` routes every token to the
    same two experts (capacity 1 drops most entries); ``idle`` zeroes
    half the rows (padding and idle slots route too); ``ties`` uses tied
    router rows."""
    cfg = get_config(ARCH, reduced=True)
    w, x = _router_inputs(d, e, t, seed, ties=kind == "ties")
    if kind == "idle":
        x[::2] = 0.0
    if kind == "drops":
        w[:] = 0.0
        w[3, 0], w[6, 0] = 5.0, 4.0
        x[:, 0] = np.abs(x[:, 0]) + 1.0
    gates, ids, _ = jmoe._route({"w": jnp.asarray(w)}, jnp.asarray(x),
                                cfg.moe)
    return x, np.array(gates), np.array(ids)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("kind,cap", [("drops", 1), ("idle", 2),
                                      ("ties", 3), ("idle", 16)])
def test_dispatch_compute_matches_reference(model, packed, kind, cap):
    jl, tl = _layer(model, packed, "moe")
    x, gates, ids = _dispatch_case(kind)
    want = jmoe._dispatch_compute(jnp.asarray(x), jnp.asarray(gates),
                                  jnp.asarray(ids), jl["experts"], 0, 8,
                                  cap)
    got = tmoe.dispatch_compute(torch.from_numpy(x), torch.from_numpy(gates),
                                torch.from_numpy(ids).long(), tl["experts"],
                                8, cap)
    _close(got, want)


def test_dispatch_rows_count_the_occupied_buffer_rows(model):
    """The experts see rows[e] = min(count_e, capacity) on the device; an
    empty buffer row's output is zero, so the skip changes nothing."""
    _, tl = _layer(model, True, "moe")
    x, gates, ids = _dispatch_case("drops")
    seen = {}

    def spy(p, xb, rows=None, plain=False):
        seen.setdefault("rows", rows)
        return apply_linear_experts(p, xb, rows, plain=plain)

    mp = pytest.MonkeyPatch()
    mp.setattr(tmoe, "apply_linear_experts", spy)
    try:
        tmoe.dispatch_compute(torch.from_numpy(x), torch.from_numpy(gates),
                              torch.from_numpy(ids).long(), tl["experts"], 8,
                              1)
    finally:
        mp.undo()
    counts = np.bincount(ids.reshape(-1), minlength=8)
    np.testing.assert_array_equal(seen["rows"].numpy(),
                                  np.minimum(counts, 1))


@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
def test_moe_block_matches_reference(model, capacity_factor):
    jcfg = model[0]
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity_factor))
    tcfg = dataclasses.replace(get_config(ARCH, reduced=True),
                               moe=dataclasses.replace(
                                   get_config(ARCH, reduced=True).moe,
                                   capacity_factor=capacity_factor))
    jl, tl = _layer(model, True, "moe", 1)
    x = np.random.default_rng(2).normal(size=(3, 5, 64)).astype(np.float32)
    x[1, 3:] = 0.0                                      # padding rows
    want, jaux = jmoe.moe_block(jl, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_block(tl, torch.from_numpy(x), tcfg)
    _close(got, want)
    _close(aux, jaux, 1e-6)


def test_gqsa_gemv_experts_ref_matches_reference_per_expert(model):
    """The experts' plain version is the reference's GEMV oracle per
    expert; rows past ``rows[e]`` are zeros."""
    jl, tl = _layer(model, True, "moe")
    jb, tb = jl["experts"]["wd"]["bsr"], tl["experts"]["wd"]["bsr"]
    x = np.random.default_rng(3).normal(size=(8, 3, 96)).astype(np.float32)
    rows = np.array([0, 1, 3, 2, 0, 3, 1, 0], np.int32)
    got = tref.gqsa_gemv_experts_ref(torch.from_numpy(x), tb,
                                     torch.from_numpy(rows))
    for e in range(8):
        be = jax.tree_util.tree_map(lambda a: a[e], jb)
        want = np.array(jref.gqsa_gemv_ref(jnp.asarray(x[e]), be))
        want[rows[e]:] = 0.0
        _close(got[e], want)
        assert (got[e, rows[e]:] == 0).all()


def test_expert_stacked_linear_refuses_w4_experts(model):
    """Dense-W4 routed experts (``{"qw"}`` stacks) run through
    ``apply_linear_experts`` and match the reference's ``_expert_ffn``
    (a vmap of its W4 linear) per expert, rows past ``rows[e]`` zeros;
    fake-quant experts are still refused."""
    jcfg, jfp = model[0], model[1]
    jp = jcompress_w4({"experts": jfp["layers"]["moe"]["experts"]}, jcfg,
                      JQuantConfig(bits=4, group_size=16))["experts"]
    jl = jax.tree_util.tree_map(lambda a: a[1], jp)
    tl = {name: {f: v[1] for f, v in node.items()} for name, node in
          params_from_numpy(jax_tree_to_numpy(jp), "cpu").items()}
    x = np.random.default_rng(8).normal(size=(8, 3, 64)).astype(np.float32)
    rows = np.array([0, 3, 1, 2, 3, 0, 1, 3], np.int32)
    want = np.array(jmoe._expert_ffn(jl, jnp.asarray(x)))
    got = tmoe.expert_ffn(tl, torch.from_numpy(x), torch.from_numpy(rows))
    for e in range(8):
        _close(got[e, :rows[e]], want[e, :rows[e]])
        assert (got[e, rows[e]:] == 0).all()
    with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
        apply_linear_experts({"gmask": None}, torch.from_numpy(x))


# ---------------------------------------------------------------------------
# MLA on the latent pool
# ---------------------------------------------------------------------------

def _rope(cfg, positions):
    return L.rope_table(positions, L.rope_dim(cfg), cfg.rope_theta)


@pytest.mark.parametrize("packed", [False, True])
def test_mla_prefill_paged_matches_reference(model, packed):
    jcfg = model[0]
    cfg = get_config(ARCH, reduced=True)
    jl, tl = _layer(model, packed, "attn")
    b, s = 2, 7
    x = np.random.default_rng(4).normal(size=(b, s, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    jo, jlat = jmla.mla_prefill_paged(jl, jnp.asarray(x), jnp.asarray(pos),
                                      jcfg)
    to, tlat = tmla.mla_prefill_paged(tl, torch.from_numpy(x), cfg,
                                      _rope(cfg, torch.from_numpy(pos)))
    _close(to, jo)
    _close(tlat, jlat)


def _latent_pool(seed, num_pages=10, ps=4, dl=40):
    g = np.random.default_rng(seed)
    return g.normal(size=(num_pages, ps, dl)).astype(np.float32)


DECODE_CASES = [
    # (T, tree fanout or None, use the reference's Pallas kernel)
    (1, None, False), (3, None, False), (1, None, True), (3, None, True),
    (None, (2, 1), False), (None, (2, 1), True)]


@pytest.mark.parametrize("t,fanout,pallas", DECODE_CASES)
def test_mla_decode_paged_matches_reference(model, t, fanout, pallas):
    """One layer's absorbed decode: T = 1, the T = 3 staircase and a
    token tree, against the reference's jnp path and its latent Pallas
    kernel (interpret mode). Slot 1 is idle: an all-sentinel table, its
    writes dropped. Output and the written pool both compared."""
    jcfg = model[0]
    cfg = get_config(ARCH, reduced=True)
    jl, tl = _layer(model, not pallas, "attn")
    ps, num_pages = 4, 10
    bt = np.array([[3, 7, 1], [10, 10, 10], [0, 5, 9]], np.int32)
    pos = np.array([5, 2, 2], np.int32)
    jtree = ttree = None
    if fanout is not None:
        jtpl, ttpl = JTreeTemplate(fanout), TreeTemplate(fanout)
        jtree, ttree = jtpl.verify_tree(), ttpl.verify_tree("cpu")
        t = int(ttree["anc"].shape[0])
    lat = _latent_pool(5)
    x = np.random.default_rng(6).normal(size=(3, t, 64)).astype(np.float32)
    jo, jnew = jmla.mla_decode_paged(
        jl, jnp.asarray(x), {"lat_pages": jnp.asarray(lat)},
        jnp.asarray(bt), jnp.asarray(pos), jcfg, use_pallas=pallas,
        tree=jtree)
    tpool = torch.from_numpy(lat.copy())
    step = L.paged_step(torch.from_numpy(bt), torch.from_numpy(pos), t, ps,
                        num_pages, cfg, ttree)
    to = tmla.mla_decode_paged(tl, torch.from_numpy(x),
                               {"lat_pages": tpool}, cfg, step)
    _close(tpool, jnew["lat_pages"])
    _close(to[[0, 2]], np.asarray(jo)[[0, 2]])


def _latent_case(seed, b=3, t=1, h=4, dl=40, ps=4, mp=4, num_pages=14):
    """Random latent pool and queries, shuffled tables with sentinel
    tails, staircase lengths; slot 1's table is all sentinels."""
    g = np.random.default_rng(seed)
    q = g.normal(size=(b, t, h, dl)).astype(np.float32)
    lat = g.normal(size=(num_pages, ps, dl)).astype(np.float32)
    pages = g.permutation(num_pages)[:b * mp].reshape(b, mp)
    occ = g.integers(1, mp + 1, size=b)
    bt = np.where(np.arange(mp)[None, :] < occ[:, None], pages,
                  num_pages).astype(np.int32)
    lengths = np.sort(np.stack([g.integers(1, occ[i] * ps + 1, size=t)
                                for i in range(b)]), axis=1)
    bt[1] = num_pages
    return q, lat, lengths.astype(np.int32), bt


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("dl,v_rank", [(40, 32), (160, 140)])
def test_paged_latent_attention_ref_matches_reference(t, dl, v_rank):
    """Against the reference's oracle and its latent kernel (interpret
    mode), with the staircase and an all-sentinel slot."""
    q, lat, lengths, bt = _latent_case(7 + t + dl, t=t, dl=dl)
    args = (jnp.asarray(q), jnp.asarray(lat), jnp.asarray(lengths),
            jnp.asarray(bt))
    want_ref = jref.paged_latent_attention_ref(*args, v_rank)
    want_ker = jops.paged_latent_attention(*args, v_rank=v_rank,
                                           use_pallas=True, interpret=True)
    got = ops.paged_latent_attention(
        *map(torch.from_numpy, (q, lat, lengths, bt)), v_rank=v_rank)
    assert got.shape == (3, t, 4, v_rank) and got.dtype == torch.float32
    _close(got, want_ref)
    _close(got, want_ker)


def test_paged_latent_attention_ref_tree_and_zero_length():
    """Tree ancestor bitmaps match the reference's oracle and kernel; a
    row of length 0 is exact zeros (the reference's kernel gives zeros,
    its oracle NaN)."""
    ttpl = TreeTemplate((2, 2))
    spec = ttpl.verify_tree("cpu")
    w = int(spec["anc"].shape[0])
    q, lat, _, bt = _latent_case(31, t=w, mp=5, num_pages=20)
    bt[1] = bt[0]
    base = np.array([3, 0, 6], np.int32)
    lengths = np.broadcast_to((base + w)[:, None], (3, w)).copy()
    lengths[1] = 0
    anc = np.broadcast_to(spec["anc"].numpy()[None], (3, w)).copy()
    targs = (*map(torch.from_numpy, (q, lat, lengths, bt)),)
    got = ops.paged_latent_attention(
        *targs, v_rank=32, anc=torch.from_numpy(anc),
        anc_base=torch.from_numpy(base), anc_window=w)
    assert (got[1] == 0).all()
    jargs = (jnp.asarray(q), jnp.asarray(lat), jnp.asarray(lengths),
             jnp.asarray(bt))
    jkw = dict(anc=jnp.asarray(anc), anc_base=jnp.asarray(base),
               anc_window=w)
    want_ref = np.asarray(jref.paged_latent_attention_ref(*jargs, 32, **jkw))
    want_ker = np.asarray(jops.paged_latent_attention(
        *jargs, v_rank=32, use_pallas=True, interpret=True, **jkw))
    assert (want_ker[1] == 0).all()
    _close(got, want_ker)
    _close(got[[0, 2]], want_ref[[0, 2]])


def test_latent_and_expert_wrappers_never_fall_back():
    """A CUDA wrapper refuses a CPU tensor; a dispatcher raises for a
    device with no kernel; int8 latent pages are refused as the reference
    refuses them."""
    q, lat, lengths, bt = map(torch.from_numpy, _latent_case(3))
    live = torch.ones(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(q.reshape(3, 1, 4, 40), lat[:, :, None], None,
                             lengths, bt, live, 1, v_rank=32)
    with pytest.raises(NotImplementedError, match="int8"):
        paged_attention_cuda(q.reshape(3, 1, 4, 40),
                             lat[:, :, None].to(torch.int8), None, lengths,
                             bt, live, 1, v_rank=32)
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_latent_attention(q.to("meta"), lat, lengths, bt,
                                   v_rank=32)
    cfg = get_config(ARCH, reduced=True)
    tp = ttf.init_params(0, cfg, "cpu", compress=GQSAConfig())
    bsr = ttf.layer_params(tp["layers"], 0)["moe"]["experts"]["wg"]["bsr"]
    with pytest.raises(ValueError, match="CUDA"):
        gqsa_gemv_experts_cuda(torch.zeros(8, 2, 64), bsr)
    with pytest.raises(ValueError, match="no kernel"):
        ops.gqsa_gemv_experts(torch.zeros(8, 2, 64, device="meta"), bsr)
    assert paged_attention_cuda.latent_launches == 0
    assert gqsa_gemv_experts_cuda.launches == 0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _bsr_equal(a, b):
    for f in ("idx", "vals", "scale", "zero"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      np.asarray(getattr(b, f)))
    assert tuple(a.shape) == tuple(b.shape)


def test_compress_params_packs_experts_and_keeps_the_router_fp(model):
    """The walk packs the [L, E, N, K] expert stacks (one [N, K] slice at
    a time, leaves [L, E, N, M]), the shared experts and MLA's four
    linears exactly as the reference does; the router and w_uk / w_uv stay
    FP."""
    _, jfp, jpk, nfp, _ = model
    cfg = get_config(ARCH, reduced=True)
    tfp = params_from_numpy(nfp, "cpu")
    tpk = compress_params(tfp, cfg, GQSAConfig())["layers"]
    jl = jpk["layers"]
    for name in ("wg", "wu", "wd"):
        assert tpk["moe"]["experts"][name]["bsr"].idx.shape[:2] == (2, 8)
        _bsr_equal(tpk["moe"]["experts"][name]["bsr"],
                   jl["moe"]["experts"][name]["bsr"])
        _bsr_equal(tpk["moe"]["shared"][name]["bsr"],
                   jl["moe"]["shared"][name]["bsr"])
    for name in ("w_qa", "w_qb", "w_kva", "wo"):
        _bsr_equal(tpk["attn"][name]["bsr"], jl["attn"][name]["bsr"])
    assert set(tpk["moe"]["router"]) == {"w"}
    assert torch.equal(tpk["moe"]["router"]["w"],
                       tfp["layers"]["moe"]["router"]["w"])
    assert torch.equal(tpk["attn"]["w_uk"], tfp["layers"]["attn"]["w_uk"])


def test_init_params_packs_each_expert_as_drawn():
    """init with a compression (each (layer, expert) slice packed as it is
    drawn) equals packing the FP tree afterwards; the scales are the
    reference's."""
    cfg = get_config(ARCH, reduced=True)
    fp = ttf.init_params(3, cfg, "cpu")
    a = compress_params(fp, cfg, GQSAConfig())["layers"]
    b = ttf.init_params(3, cfg, "cpu", compress=GQSAConfig())["layers"]
    for part, names in (("attn", ("w_qa", "w_qb", "w_kva", "wo")),
                        ("moe.experts", ("wg", "wu", "wd")),
                        ("moe.shared", ("wg", "wu", "wd"))):
        na, nb = a, b
        for k in part.split("."):
            na, nb = na[k], nb[k]
        for name in names:
            for f in ("idx", "vals", "scale", "zero"):
                assert torch.equal(getattr(na[name]["bsr"], f),
                                   getattr(nb[name]["bsr"], f))
    ex = fp["layers"]["moe"]["experts"]
    assert ex["wd"]["w"].shape == (2, 8, 64, 96)
    # every expert stack, wd included, at 1/sqrt(d_model); w_uk 1/sqrt(R)
    assert abs(ex["wd"]["w"].std().item() * 8.0 - 1.0) < 0.05
    assert abs(fp["layers"]["attn"]["w_uk"].std().item()
               * np.sqrt(32) - 1.0) < 0.1
    assert fp["layers"]["attn"]["q_norm"].shape == (2, 48)


def test_init_paged_cache_is_one_latent_pool():
    cfg = get_config(ARCH, reduced=True)
    jc = jtf.init_paged_cache(jget_config(ARCH, reduced=True), 6, 4)
    tc = ttf.init_paged_cache(dataclasses.replace(cfg,
                                                  kv_cache_dtype="int8"),
                              6, 4, device="cpu")
    assert set(tc) == set(jc) == {"lat_pages"}
    assert tuple(tc["lat_pages"].shape) == jc["lat_pages"].shape \
        == (2, 6, 4, 40)
    assert tc["lat_pages"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the whole slice, the engine and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
def test_prefill_and_decode_logits_match_reference(model, packed):
    jcfg, jfp, jpk, nfp, npk = model
    tcfg = get_config(ARCH, reduced=True)
    steps, act = slice_run(jcfg, jpk if packed else jfp, tcfg,
                           params_from_numpy(npk if packed else nfp, "cpu"),
                           steps=6)
    for j, t in steps:
        assert t.shape == j.shape and np.isfinite(t[act]).all()
        bar = 2e-4 * np.abs(j[act]).max()
        np.testing.assert_allclose(t[act], j[act], rtol=0, atol=bar)


def test_engine_greedy_tokens_match_reference(model):
    jcfg, _, jpk, _, npk = model
    tcfg = get_config(ARCH, reduced=True)
    prompts, max_new = engine_prompts(jcfg.vocab), 8
    ref = serve_all(JInferenceEngine(jcfg, jpk, JEngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE)), prompts, max_new)
    got = serve_all(InferenceEngine(tcfg, params_from_numpy(npk, "cpu"),
                                    EngineConfig(num_slots=2, max_seq=32,
                                                 page_size=PAGE,
                                                 device="cpu")),
                    prompts, max_new)
    assert_greedy_match(ref, got, prompts,
                        reference_margins(jcfg, jpk, prompts, ref, max_new),
                        max_new)


def test_engine_serves_speculation_on_mla_moe():
    """The engine builds and serves chain speculation (K = 2) on the
    latent pool, on the port's own drawn weights and the w4l50 draft
    packed from the same draws (the conformance against the reference is
    ``tests/test_torch_spec_mla_moe.py``)."""
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


def test_serve_cli_serves_deepseek_on_cpu(capsys):
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-new", "4", "--slots", "2"])
    out = capsys.readouterr().out
    assert re.search(r"^\[digest\] [0-9a-f]{64}$", out, re.M)
    assert "packed GQSA W4 S50% G16" in out
    assert len(res["results"]) == 3
    assert all(len(r["tokens"]) == 4 for r in res["results"])
