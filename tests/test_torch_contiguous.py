"""Port conformance, the static-batch contiguous-cache path: the int8
decode attention over a contiguous cache (``kv_decode_attention``: its
plain version and the card kernel's split walk, ``kv_decode_split_ref``),
``attention_decode`` on the bf16/f32 and the int8 cache, ``init_cache``,
``forward`` (logits and the router's aux loss), the contiguous
``decode_step`` and the serve and prefill steps, against the JAX
reference on the same numpy inputs (parameters initialised, and packed,
by the reference and carried over through the bridge).

Tolerances (f32, the reduced configs' compute dtype):
  * int8 attention: 1e-4 abs and rel against the reference's Pallas
    kernel (interpret mode) and its oracle, the bar of the reference's
    own kernel test, for the plain version and for the card kernel's
    split walk alike;
  * ``attention_decode``: 1e-5 abs on the f32 cache (the same math; a
    bf16 cache rounds q and p to bf16 where an f32 order difference can
    flip one rounding: 2e-3); the int8 cache 1e-4 against the
    reference's kernel path, and within 1e-2 of max |output| of its jnp
    path, which re-quantizes q and p to int8 (ROADMAP C.4; the
    reference's own two paths differ by 7.6e-3 of it at the shared
    ``pos`` of these inputs);
  * model logits: |port - ref| <= 1e-4 x max |ref| (two layers of f32
    order differences), the aux loss to 1e-5;
  * greedy tokens: equal wherever the port's top-2 margin exceeds 1e-3
    (a flip at a nearer tie is not a fault; both continue on the
    reference's token)."""
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
from repro.core.model_compress import compress_params_w4 as jcompress_w4  # noqa: E402
from repro.core.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import kv_decode_attention as kvd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

from _torch_utils import jax_tree_to_numpy  # noqa: E402

ARCHS = ["llama2_7b", "deepseek_moe_16b", "deepseek_v2_236b"]


def _cfgs(arch, **kw):
    """(reference, port) reduced configs of ``arch`` with ``kw`` set; the
    MoE capacity at 16 (no drops) when ``kw`` holds ``capacity``."""
    cf = kw.pop("capacity", None)
    out = []
    for get in (jget_config, get_config):
        c = dataclasses.replace(get(arch, reduced=True), **kw)
        if cf is not None and c.moe is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=cf))
        out.append(c)
    return tuple(out)


@pytest.fixture(scope="module")
def models():
    """{(arch, packing): (jax params, port params)} of the reduced configs,
    initialised (and packed) by the reference: FP and GQSA W4 S50 G16 of
    every arch, dense W4 G16 of llama2-7b."""
    out = {}
    for arch in ARCHS:
        jcfg = jget_config(arch, reduced=True)
        jfp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
        trees = {"fp": jfp,
                 "gqsa": jcompress(jfp, jcfg,
                                   JGQSAConfig(saliency="magnitude"))}
        if arch == "llama2_7b":
            trees["w4"] = jcompress_w4(jfp, jcfg, JQuantConfig(
                bits=4, group_size=16))
        for name, jp in trees.items():
            out[arch, name] = (jp, params_from_numpy(jax_tree_to_numpy(jp),
                                                     "cpu"))
    return out


def _rel_close(got, want, rel):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# the kernel: int8 decode attention over a contiguous cache
# ---------------------------------------------------------------------------

def _kv_case(b, s, kh, r, d, seed=0):
    """q [B, KH, R, D] f32 and a quantized [B, S, KH, D] cache (numpy)."""
    g = np.random.default_rng(seed)
    q = g.normal(size=(b, kh, r, d)).astype(np.float32)
    k8, ks = jlayers.quantize_kv(jnp.asarray(
        g.normal(size=(b, s, kh, d)).astype(np.float32)))
    v8, vs = jlayers.quantize_kv(jnp.asarray(
        g.normal(size=(b, s, kh, d)).astype(np.float32)))
    return tuple(np.array(a) for a in (q, k8, ks, v8, vs))


@pytest.mark.parametrize("b,s,kh,r,d,bs", [(2, 128, 2, 4, 64, 32),
                                           (1, 256, 4, 2, 128, 64),
                                           (2, 96, 1, 8, 32, 32)])
@pytest.mark.parametrize("per_slot", [False, True])
def test_kv_decode_attention_ref_matches_reference(b, s, kh, r, d, bs,
                                                   per_slot):
    """The plain version against the reference's kernel (interpret mode)
    and its oracle, at the shapes of the reference's kernel test, with a
    scalar and a [B] length."""
    case = _kv_case(b, s, kh, r, d)
    ln = np.array([s - 17, 5][:b], np.int32) if per_slot \
        else np.int32(s - 17)
    got = tref.kv_decode_attention_ref(*map(torch.from_numpy, case),
                                       torch.as_tensor(ln))
    jargs = tuple(map(jnp.asarray, case)) + (jnp.asarray(ln),)
    o_ker = jops.kv_decode_attention(*jargs, block_s=bs, interpret=True)
    o_ref = jref.kv_decode_attention_ref(*jargs)
    assert got.shape == (b, kh, r, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(o_ker), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(o_ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("s,r,d", [(37, 1, 16), (37, 4, 64), (100, 1, 64),
                                   (100, 4, 16)])
@pytest.mark.parametrize("per_slot", [False, True])
def test_kv_decode_split_ref_matches_reference(s, r, d, per_slot):
    """The card kernel's order of arithmetic (its chunks of 32 positions
    shared out over 1, 2, 3 and more splits than positions, partials and
    combine) against the reference's kernel (interpret mode) and its
    oracle, at odd S, R in {1, 4}, D in {16, 64}, with shared lengths
    (S - 3, 1 and 0) and per-slot ones (S, 0, 1); a row of length 0 is
    exact zeros (the reference's oracle gives NaN there)."""
    b, kh = 3, 2
    case = _kv_case(b, s, kh, r, d, seed=s + r + d)
    tcase = tuple(map(torch.from_numpy, case))
    lens = [np.array([s, 0, 1], np.int32)] if per_slot \
        else [np.int32(s - 3), np.int32(1), np.int32(0)]
    for ln in lens:
        live = np.broadcast_to(ln, (b,)) > 0
        want = None
        if live.any():
            jargs = tuple(map(jnp.asarray, case)) + (jnp.asarray(ln),)
            want = [np.asarray(jops.kv_decode_attention(*jargs,
                                                        interpret=True)),
                    np.asarray(jref.kv_decode_attention_ref(*jargs))]
        for n_split in (1, 2, 3, s + 13):
            got = tref.kv_decode_split_ref(*tcase, torch.as_tensor(ln),
                                           n_split).numpy()
            assert got.shape == (b, kh, r, d) and np.isfinite(got).all()
            assert (got[~live] == 0).all()
            for w in want or ():
                np.testing.assert_allclose(got[live], w[live], rtol=1e-4,
                                           atol=1e-4)


def test_kv_decode_plan_from_shapes():
    """Heads a block, ring stages, split count and shared memory come
    from shapes and the SM count alone: the static int8 cell's (4 slots x
    32 KV heads of 128 at 32768 and 4096 positions, 132 SMs; 114 SMs; 4
    heads a block; a ring too deep to fit) and a reduced config's (2
    slots x 4 heads of 16 over 64 positions: two chunks, two splits)."""
    plan = kvd.plan
    assert plan(4, 32, 32768, 1, 128, 132) == kvd.Plan(8, 3, 16, 210944)
    assert plan(4, 32, 4096, 1, 128, 132) == kvd.Plan(8, 3, 16, 210944)
    assert plan(4, 32, 32768, 1, 128, 114).n_split == 14
    assert plan(4, 32, 32768, 1, 128, 132, heads=4) == kvd.Plan(4, 3, 16,
                                                                107008)
    assert plan(4, 32, 32768, 1, 128, 132, stages=4).stages == 3
    assert plan(2, 4, 64, 1, 16, 132) == kvd.Plan(4, 3, 2, 19200)
    assert plan(2, 6, 64, 4, 64, 132).heads == 2
    assert kvd.smem_bytes(4, 3, 64, 2) == kvd.smem_bytes(4, 3, 64, 3) \
        - 2 * 32 * (4 * 64 + 16) - 2 * 32 * 4 * 4


def test_kv_decode_kernel_wrapper_takes_only_the_card():
    """The kernel's wrapper raises on a CPU tensor: it never computes on
    the CPU (the dispatcher sends CPU tensors to the plain version)."""
    case = tuple(map(torch.from_numpy, _kv_case(2, 64, 2, 1, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        kvd.kv_decode_attention_cuda(*case, torch.tensor([7, 64]))
    assert kvd.kv_decode_attention_cuda.launches == 0


def test_kv_decode_attention_dispatch():
    """On the CPU the dispatcher runs the plain version; a device with no
    kernel raises rather than falling back."""
    case = tuple(map(torch.from_numpy, _kv_case(2, 64, 2, 1, 16)))
    ln = torch.tensor([7, 64])
    np.testing.assert_array_equal(
        ops.kv_decode_attention(*case, ln).numpy(),
        tref.kv_decode_attention_ref(*case, ln).numpy())
    with pytest.raises(ValueError, match="no kernel"):
        ops.kv_decode_attention(case[0].to("meta"), *case[1:], ln)


# ---------------------------------------------------------------------------
# the layer: attention_decode on the contiguous cache
# ---------------------------------------------------------------------------

B, S = 3, 16
POS = {"shared": np.int32(9), "per_slot": np.array([9, 0, 15], np.int32)}


def _layer_case(models, kv, dtype=np.float32, seed=3):
    """(jax layer params, port layer params, x [B, 1, d], jax cache, port
    cache) of the reduced llama2-7b's first layer: a cache holding random
    history (quantized for ``kv == "int8"``) in both packages."""
    jcfg = jget_config("llama2_7b", reduced=True)
    jp, tp = models["llama2_7b", "fp"]
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["attn"])
    tl = ttf.layer_params(tp["layers"]["attn"], 0)
    g = np.random.default_rng(seed)
    shape = (B, S, jcfg.n_kv_heads, jcfg.hd)
    hist = [g.normal(size=shape).astype(np.float32) for _ in range(2)]
    if kv == "int8":
        (k, ks), (v, vs) = (map(np.array, jlayers.quantize_kv(jnp.asarray(h)))
                            for h in hist)
        cache = {"k": k, "v": v, "k_scale": ks, "v_scale": vs}
        jcache = {n: jnp.asarray(a) for n, a in cache.items()}
        tcache = {n: torch.from_numpy(a) for n, a in cache.items()}
    else:
        bf16 = dtype == jnp.bfloat16
        jcache = {n: jnp.asarray(h).astype(dtype)
                  for n, h in zip("kv", hist)}
        tcache = {n: torch.from_numpy(h).to(torch.bfloat16 if bf16
                                            else torch.float32)
                  for n, h in zip("kv", hist)}
    x = g.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    return jl, tl, x, jcache, tcache


def _port_decode(tl, x, tcache, pos):
    tcfg = get_config("llama2_7b", reduced=True)
    return L.attention_decode(tl, torch.from_numpy(x), tcache,
                              torch.as_tensor(pos), tcfg)


@pytest.mark.parametrize("pos", list(POS))
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (jnp.bfloat16, 2e-3)])
def test_attention_decode_matches_reference(models, pos, dtype, tol):
    """The bf16/f32 cache: the reference's math (q and p in the cache's
    dtype, f32 sums); the token's K/V written in place at ``pos``."""
    jl, tl, x, jcache, tcache = _layer_case(models, "fp", dtype)
    jcfg = jget_config("llama2_7b", reduced=True)
    want, jnew = jlayers.attention_decode(jl, jnp.asarray(x), jcache,
                                          jnp.asarray(POS[pos]), jcfg)
    got = _port_decode(tl, x, tcache, POS[pos])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache[n].float().numpy(),
                                   np.asarray(jnew[n], np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("pos", list(POS))
def test_attention_decode_int8_matches_reference(models, pos):
    """The int8 cache always takes the kernel's math: 1e-4 from the
    reference's kernel path (which it takes for a shared ``pos`` under
    ``use_pallas``), within 1e-2 of max |output| of its jnp path (which
    it takes for a per-slot ``pos``, re-quantizing q and p: ROADMAP
    C.4); the codes and
    scales written in place equal the reference's."""
    jl, tl, x, jcache, tcache = _layer_case(models, "int8")
    jcfg = jget_config("llama2_7b", reduced=True)
    jpos = jnp.asarray(POS[pos])
    got = _port_decode(tl, x, tcache, POS[pos]).numpy()
    jnp_path, jnew = jlayers.attention_decode(jl, jnp.asarray(x), jcache,
                                              jpos, jcfg, use_pallas=False)
    _rel_close(got, jnp_path, 1e-2)
    assert not np.array_equal(got, np.asarray(jnp_path))
    if pos == "shared":
        kern, _ = jlayers.attention_decode(jl, jnp.asarray(x), jcache, jpos,
                                           jcfg, use_pallas=True)
        np.testing.assert_allclose(got, np.asarray(kern), rtol=1e-4,
                                   atol=1e-4)
    for n in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jnew[n]),
                                   rtol=1e-6, atol=0)
    for n in ("k", "v"):
        diff = np.abs(tcache[n].numpy().astype(np.int32)
                      - np.asarray(jnew[n]).astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_attention_decode_drops_a_write_past_max_seq(models, kv):
    """A write at ``pos >= max_seq`` is dropped, shared or per slot, with
    no host read (ROADMAP C.12): the cache keeps its history, and the
    token attends over all of it, as the reference's per-slot update
    does; its shared-``pos`` update clamps the write into the last
    position instead."""
    jl, tl, x, jcache, tcache = _layer_case(models, kv)
    before = {n: t.clone() for n, t in tcache.items()}
    pos = np.array([S, S + 3, S], np.int32)
    shared = _port_decode(tl, x, tcache, np.int32(S))
    got = _port_decode(tl, x, tcache, pos)
    for n, t in tcache.items():
        assert torch.equal(t, before[n]), n
    # slots at the same position as the shared one give its output
    np.testing.assert_array_equal(got.numpy()[[0, 2]],
                                  shared.numpy()[[0, 2]])
    if kv == "fp":
        jcfg = jget_config("llama2_7b", reduced=True)
        want, jnew = jlayers.attention_decode(jl, jnp.asarray(x), jcache,
                                              jnp.asarray(pos), jcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(np.asarray(jnew["k"]),
                                      before["k"].numpy())


# ---------------------------------------------------------------------------
# the model: init_cache, forward, contiguous decode_step, the steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kv", [("llama2_7b", "bf16"),
                                     ("llama2_7b", "int8"),
                                     ("deepseek_moe_16b", "int8"),
                                     ("deepseek_v2_236b", "int8")])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_init_cache_layout_matches_reference(arch, kv, dtype):
    """Keys, shapes and dtypes of the reference's contiguous cache; the
    int8 layout follows ``kv_cache_dtype`` except on the MLA latent."""
    jcfg, tcfg = _cfgs(arch, kv_cache_dtype=kv)
    j = jtf.init_cache(jcfg, 3, 5, None if dtype is None
                       else jnp.bfloat16)
    t = ttf.init_cache(tcfg, 3, 5, None if dtype is None
                       else torch.bfloat16, device="cpu")
    assert sorted(t) == sorted(j)
    for name, leaf in t.items():
        assert tuple(leaf.shape) == j[name].shape
        assert str(leaf.dtype).replace("torch.", "") == str(j[name].dtype)
        assert not leaf.any()
    api = tregistry.get_model(tcfg)
    assert api.init_cache is ttf.init_cache


FORWARD_CASES = [(a, "fp") for a in ARCHS] + [(a, "gqsa") for a in ARCHS] \
    + [("llama2_7b", "w4")]


@pytest.mark.parametrize("arch,packing", FORWARD_CASES)
def test_forward_matches_reference(models, arch, packing):
    """Logits at every position (and ``last_only``) and the router's aux
    loss, through the API's batch dict."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = models[arch, packing]
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 7)) \
        .astype(np.int32)
    want, jaux = jtf.forward(jp, jnp.asarray(toks), jcfg)
    api = tregistry.get_model(tcfg)
    got, aux = api.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    _rel_close(got, want, 1e-4)
    last, _ = api.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                          last_only=True)
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(),
                               rtol=1e-6, atol=1e-6)
    assert aux.shape == () and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-6)
    assert (float(aux) > 0) == (jcfg.moe is not None)


def _decode_both(jcfg, jp, tcfg, tp, toks, pos_of, use_pallas=False):
    """Teacher-forced contiguous decode of ``toks`` [B, N] from position 0
    in both packages; ``pos_of(i)``: the step's pos (numpy). Returns
    [(ref logits, port logits)] per step."""
    b, n = toks.shape
    jcache = jtf.init_cache(jcfg, b, n + 2)
    tcache = ttf.init_cache(tcfg, b, n + 2, device="cpu")
    out = []
    for i in range(n):
        pos = pos_of(i)
        jl, jcache = jtf.decode_step(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                                     jnp.asarray(pos), jcfg,
                                     use_pallas=use_pallas)
        tl, _ = ttf.decode_step(tp, tcache, torch.from_numpy(toks[:, i:i + 1]),
                                torch.from_numpy(np.asarray(pos)), tcfg)
        out.append((np.asarray(jl, np.float32), tl.float().numpy()))
    return out


@pytest.mark.parametrize("arch,packing,kv", [
    ("llama2_7b", "gqsa", "bf16"), ("llama2_7b", "fp", "int8"),
    ("deepseek_moe_16b", "fp", "int8"), ("deepseek_v2_236b", "gqsa", "bf16")])
def test_contiguous_decode_step_matches_reference(models, arch, packing, kv):
    """4 teacher-forced steps at a shared scalar ``pos``; the int8 cache
    against the reference's kernel path (``use_pallas=True``, interpret
    mode; FP weights, since its packed GEMV cannot run in its layer scan
    under ``use_pallas``)."""
    jcfg, tcfg = _cfgs(arch, kv_cache_dtype=kv)
    jp, tp = models[arch, packing]
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 4)) \
        .astype(np.int32)
    for j, t in _decode_both(jcfg, jp, tcfg, tp, toks, np.int32,
                             use_pallas=kv == "int8"):
        _rel_close(t, j, 1e-4)


def test_contiguous_decode_step_per_slot_pos_matches_reference(models):
    """Per-slot [B] positions (each slot at its own depth): the bf16/f32
    cache takes the same math as the reference's."""
    jcfg, tcfg = _cfgs("llama2_7b")
    jp, tp = models["llama2_7b", "gqsa"]
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (3, 4)) \
        .astype(np.int32)
    for j, t in _decode_both(jcfg, jp, tcfg, tp, toks,
                             lambda i: np.array([i, 0, min(i, 2)],
                                                np.int32)):
        _rel_close(t, j, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_by_step_equals_forward(models, arch, kv):
    """The reference's invariant (``tests/test_models.py``): decoding a
    sequence token by token gives the full forward's logits, MoE capacity
    at 16 (no drops). The f32 cache to 1e-4 of max |logit|; the int8
    cache within its quantization noise (5e-2, the reference's bar)."""
    _, tcfg = _cfgs(arch, kv_cache_dtype=kv, capacity=16.0)
    _, tp = models[arch, "gqsa"]
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tcfg.vocab, (2, 8)).astype(np.int32))
    full, _ = ttf.forward(tp, toks, tcfg)
    cache = ttf.init_cache(tcfg, 2, 9, device="cpu")
    dec = torch.cat([ttf.decode_step(tp, cache, toks[:, i:i + 1],
                                     torch.tensor(i), tcfg)[0]
                     for i in range(8)], dim=1)
    rel = 5e-2 if kv == "int8" and arch != "deepseek_v2_236b" else 1e-4
    _rel_close(dec, full.numpy(), rel)


def test_contiguous_decode_step_refuses_what_it_does_not_take(models):
    _, tcfg = _cfgs("llama2_7b")
    _, tp = models["llama2_7b", "fp"]
    cache = ttf.init_cache(tcfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="token-tree"):
        ttf.decode_step(tp, cache, torch.zeros((1, 2), dtype=torch.int32),
                        torch.tensor(0), tcfg, tree={})
    with pytest.raises(ValueError, match="one token"):
        ttf.decode_step(tp, cache, torch.zeros((1, 2), dtype=torch.int32),
                        torch.tensor(0), tcfg)
    pool = ttf.init_paged_cache(tcfg, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="block_tables"):
        ttf.decode_step(tp, pool, torch.zeros((1, 1), dtype=torch.int32),
                        torch.tensor([0]), tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_prefill_steps_match_reference(models, arch):
    """Greedy tokens of ``build_prefill_step`` on the prompts and of
    ``build_serve_step`` over 2 teacher-forced prompt tokens and 3 greedy
    steps at a shared ``pos``, against the reference's steps (GQSA
    weights); both continue on the reference's tokens."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = models[arch, "gqsa"]
    prompt = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 2)) \
        .astype(np.int32)
    want = np.asarray(jsteps.build_prefill_step(jcfg, None)(
        jp, {"tokens": jnp.asarray(prompt)}))
    got, logits = tsteps.build_prefill_step(tcfg, with_logits=True)(
        tp, {"tokens": torch.from_numpy(prompt)})
    assert got.shape == (2,) and logits.shape == (2, tcfg.vocab)
    _match_where_clear(got, logits, want)

    jserve = jsteps.build_serve_step(jcfg, None)
    tserve = tsteps.build_serve_step(tcfg, with_logits=True)
    jcache = jtf.init_cache(jcfg, 2, 6)
    tcache = ttf.init_cache(tcfg, 2, 6, device="cpu")
    tok = prompt[:, :1]
    for i in range(5):
        jtok, jcache = jserve(jp, jcache, jnp.asarray(tok), jnp.int32(i))
        ttok, tcache, logits = tserve(tp, tcache, torch.from_numpy(tok),
                                      torch.tensor(i, dtype=torch.int32))
        assert ttok.shape == (2, 1) and ttok.dtype == torch.int32
        _match_where_clear(ttok[:, 0], logits, np.asarray(jtok)[:, 0])
        tok = prompt[:, i + 1:i + 2] if i + 1 < 2 else np.array(jtok)


def _match_where_clear(got, logits, want):
    top2 = logits.float().topk(2, dim=-1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 1e-3).numpy()
    np.testing.assert_array_equal(got.numpy()[clear], np.asarray(want)[clear])


def test_serve_step_never_reads_the_device_on_the_host():
    """The contiguous serve step (int8 cache, shared and per-slot ``pos``;
    the MLA latent cache) reads no tensor value on the host: no
    ``aten::_local_scalar_dense`` or ``aten::item`` in the profile. The
    profiler counts the reads on the CPU as it would on the card."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.gqs_layer import GQSAConfig
    runs = []
    for arch, kv in (("llama2_7b", "int8"), ("deepseek_v2_236b", "bf16")):
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  kv_cache_dtype=kv)
        params = ttf.init_params(0, cfg, "cpu", compress=GQSAConfig())
        runs.append((cfg, params, ttf.init_cache(cfg, 2, 6, device="cpu")))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for cfg, params, cache in runs:
            serve = tsteps.build_serve_step(cfg)
            tok, _ = serve(params, cache, torch.tensor([[1], [2]]),
                           torch.tensor(3, dtype=torch.int32))
            serve(params, cache, tok, torch.tensor([4, 6], dtype=torch.int32))
    reads = [e.key for e in prof.key_averages()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads
