"""Port conformance, chain self-speculative decoding: ``spec_verify``,
the draft profiles, one draft/verify round on the pool and the serving
engine against the JAX reference on the same numpy inputs.

Tolerances:
  * ``spec_verify`` greedy: accepted lengths and emitted tokens equal;
  * sampled (temperature 1): the first emitted token's frequencies over
    4000 rounds within 0.05 of the target distribution (about 3 sigma of
    the largest bin), as the reference's own test bounds it; the two
    packages draw other random numbers, so only distributions compare;
  * draft packing: codes and indices bit-identical, scale/zero to rtol
    1e-6 (the bars of ``tests/test_torch_w4.py``);
  * one round from the same prefilled pool: emitted tokens equal, the
    pool's committed rows to 1e-5 abs (f32; the two sides differ only in
    summation order);
  * engine: speculative greedy tokens equal to the port's own
    non-speculative tokens, and to the reference engine's wherever the
    top-2 margin exceeds 1e-3 (``tests/_torch_utils.py``)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

# the suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps these small products from crowding the other files
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import \
    list_draft_profiles as jlist_draft_profiles  # noqa: E402
from repro.core.gqs_layer import GQSAConfig as JGQSAConfig  # noqa: E402
from repro.core.model_compress import compress_draft as jcompress_draft  # noqa: E402
from repro.core.model_compress import compress_params as jcompress  # noqa: E402
from repro.core.model_compress import draft_layers as jdraft_layers  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.engine.sampling import SamplingParams as JSamplingParams  # noqa: E402
from repro.engine.sampling import spec_verify as jspec_verify  # noqa: E402
from repro.engine.spec import spec_step_fns as jspec_step_fns  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config, list_draft_profiles  # noqa: E402
from repro_torch.core.bsr import BSRMatrix  # noqa: E402
from repro_torch.core.gqs_layer import GQSAConfig  # noqa: E402
from repro_torch.core.model_compress import (compress_draft,  # noqa: E402
                                             compress_params, draft_layers)
from repro_torch.engine import (EngineConfig, InferenceEngine,  # noqa: E402
                                SamplingParams)
from repro_torch.engine.sampling import spec_verify  # noqa: E402
from repro_torch.engine.spec import spec_step_fns  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

from _torch_utils import (PAGE, assert_greedy_match, engine_prompts,  # noqa: E402
                          jax_tree_to_numpy, port_greedy_margins,
                          prefill_both, serve_all, slice_inputs)

GREEDY = SamplingParams()
PROFILES = ["w4", "w4s50", "w4s75", "w2s50", "w4l50"]


@pytest.fixture(scope="module")
def models():
    """The reduced llama2-7b in both packages: the reference's FP init,
    its GQSA target packing, both bridged; drafts built per profile."""
    jcfg = jget_config("llama2_7b", reduced=True)
    jfp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    jtarget = jcompress(jfp, jcfg, JGQSAConfig())
    return dict(jcfg=jcfg, jfp=jfp, jtarget=jtarget,
                cfg=get_config("llama2_7b", reduced=True),
                fp=params_from_numpy(jax_tree_to_numpy(jfp), "cpu"),
                target=params_from_numpy(jax_tree_to_numpy(jtarget), "cpu"))


def _leaves(tree, path=""):
    if isinstance(tree, BSRMatrix):
        for f in ("idx", "vals", "scale", "zero"):
            yield f"{path}.{f}", getattr(tree, f)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    else:
        yield path, tree


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for name in w:
        assert g[name].shape == w[name].shape, name
        if g[name].dtype in (torch.float32, torch.bfloat16):
            torch.testing.assert_close(g[name].float(), w[name].float(),
                                       rtol=1e-6, atol=0, msg=name)
        else:
            assert torch.equal(g[name], w[name]), name


# ---------------------------------------------------------------------------
# spec_verify
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_verify_greedy_matches_reference(seed):
    """Rows: every draft accepted, rejected at 0, rejected midway, a
    random draft; both packages on the same logits."""
    g = np.random.default_rng(seed)
    b, k, v = 4, 4, 16
    logits = g.normal(size=(b, k + 1, v)).astype(np.float32)
    tgt = logits.argmax(-1)
    draft = np.stack([tgt[0, :k], (tgt[1, :k] + 1) % v,
                      np.concatenate([tgt[2, :2], (tgt[2, 2:k] + 1) % v]),
                      g.integers(0, v, size=k)]).astype(np.int32)
    jn, jout = jspec_verify(jnp.asarray(logits), jnp.asarray(draft),
                            jax.random.PRNGKey(0), JSamplingParams())
    jn, jout = np.asarray(jn), np.asarray(jout)
    tn, tout = spec_verify(torch.from_numpy(logits), torch.from_numpy(draft),
                           None, GREEDY)
    assert tn.dtype == tout.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), jn)
    assert list(jn[:3]) == [k, 0, 2]
    for i in range(b):
        np.testing.assert_array_equal(tout[i, :jn[i] + 1].numpy(),
                                      jout[i, :jn[i] + 1])


@pytest.mark.parametrize("draft_tok", [0, 4])
def test_spec_verify_first_token_distribution_preserved(draft_tok):
    """Temperature 1: the first emitted token follows the target p(.)
    whatever the draft proposed (a likely and an unlikely proposal)."""
    v, k, n = 5, 3, 4000
    logits0 = np.array([2.0, 1.0, 0.5, 0.0, -1.0], np.float32)
    target = np.exp(logits0) / np.exp(logits0).sum()
    logits = torch.from_numpy(np.tile(logits0, (n, k + 1, 1)))
    gen = torch.Generator().manual_seed(0)
    _, out = spec_verify(logits, torch.full((n, k), draft_tok,
                                            dtype=torch.int32),
                         gen, SamplingParams(temperature=1.0))
    freq = np.bincount(out[:, 0].numpy(), minlength=v) / n
    np.testing.assert_allclose(freq, target, atol=0.05)


def test_spec_verify_rejection_resample_excludes_draft_token():
    """A draft of target probability ~0 is always rejected and never
    emitted at its own position (the residual zeroes it)."""
    logits0 = np.array([10.0, 0.0, 0.0, -30.0], np.float32)
    logits = torch.from_numpy(np.tile(logits0, (500, 3, 1)))
    gen = torch.Generator().manual_seed(1)
    n_acc, out = spec_verify(logits, torch.full((500, 2), 3,
                                                dtype=torch.int32),
                             gen, SamplingParams(temperature=1.0))
    assert (n_acc == 0).all() and (out[:, 0] != 3).all()


# ---------------------------------------------------------------------------
# draft profiles
# ---------------------------------------------------------------------------

def test_draft_profile_names_and_depths_match_reference():
    jcfg = jget_config("llama2_7b")
    assert list_draft_profiles() == jlist_draft_profiles()
    for name in list_draft_profiles():
        assert draft_layers(get_config("llama2_7b"), name) \
            == jdraft_layers(jcfg, name)
    with pytest.raises(ValueError, match="unknown draft profile"):
        draft_layers(get_config("llama2_7b"), "w9")


def _draft_cases(llama_profiles):
    """(arch, profile) cases: ``llama_profiles`` on llama2-7b (their ids
    stay the profile names), and one GQSA, one dense-W4 and one depth
    profile on each MoE family."""
    return [pytest.param("llama2_7b", p, id=p) for p in llama_profiles] + [
        pytest.param(arch, p, id=f"{arch}-{p}")
        for arch in ("deepseek_moe_16b", "deepseek_v2_236b")
        for p in ("w4s50", "w4", "w4l50")]


@functools.lru_cache(maxsize=2)
def _moe_fp(arch):
    """(jax config, the reference's FP init, its bridged form) of a
    reduced MoE family."""
    jcfg = jget_config(arch, reduced=True)
    jfp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jfp, params_from_numpy(jax_tree_to_numpy(jfp), "cpu")


def _first_linear(cfg, layers):
    """The first attention projection's node (``wq``, MLA's ``w_qa``)."""
    return layers["attn"]["w_qa" if cfg.family == "mla_moe" else "wq"]


@pytest.mark.parametrize("arch,profile", _draft_cases(PROFILES))
def test_compress_draft_matches_reference_through_the_bridge(models, arch,
                                                             profile):
    """The reference's draft tree carried over by the bridge ({"bsr"}
    leaves for a GQSA profile, {"qw", "scale", "zero"} for a dense one,
    stacks cut to the draft's depth; on the MoE families the routed
    expert stacks packed expert by expert and the router FP) equals the
    port's own compress_draft of the bridged FP tree."""
    if arch == "llama2_7b":
        jcfg, jfp, fp = models["jcfg"], models["jfp"], models["fp"]
    else:
        jcfg, jfp, fp = _moe_fp(arch)
    cfg = get_config(arch, reduced=True)
    jd = jcompress_draft(jfp, jcfg, profile=profile)
    bridged = params_from_numpy(jax_tree_to_numpy(jd), "cpu")
    got = compress_draft(fp, cfg, profile)
    dl = draft_layers(cfg, profile)
    nodes = [_first_linear(cfg, got["layers"])]
    if cfg.moe is not None:
        nodes.append(got["layers"]["moe"]["experts"]["wg"])
        assert set(got["layers"]["moe"]["router"]) == {"w"}
        assert got["layers"]["moe"]["router"]["w"].dtype == torch.float32
    for node in nodes:
        if "s" in profile:
            assert isinstance(node["bsr"], BSRMatrix)
            assert node["bsr"].idx.shape[0] == dl
        else:
            assert set(node) == {"qw", "scale", "zero"}
            assert node["qw"].shape[0] == dl
    assert got["layers"]["ln1"].shape[0] == dl
    _assert_trees_equal(got, bridged)


@pytest.mark.parametrize("arch,profile",
                         _draft_cases(["w4s50", "w4l50", "w2s75"]))
def test_init_params_and_draft_packs_the_same_draws(arch, profile):
    """The draft packed as the weights are drawn equals compress_draft of
    the FP draw; embed, final norm and lm_head are the target's own
    tensors; the draft runs a decode step at its depth."""
    cfg = get_config(arch, reduced=True)
    params, draft = ttf.init_params_and_draft(4, cfg, profile, "cpu",
                                              compress=GQSAConfig())
    fp = ttf.init_params(4, cfg, "cpu")
    _assert_trees_equal(params, compress_params(fp, cfg, GQSAConfig()))
    _assert_trees_equal(draft, compress_draft(fp, cfg, profile))
    for key in ("embed", "final_norm"):
        assert draft[key] is params[key]
    assert draft["lm_head"] is params["lm_head"]
    dcfg = dataclasses.replace(cfg, n_layers=draft_layers(cfg, profile))
    cache = ttf.init_paged_cache(cfg, 4, 4, device="cpu")
    logits, _ = ttf.decode_step(draft, cache, torch.tensor([[3]]),
                                torch.tensor([0], dtype=torch.int32), dcfg,
                                torch.tensor([[0, 1]], dtype=torch.int32))
    assert logits.shape == (1, 1, cfg.vocab)
    assert torch.isfinite(logits).all()


def test_init_params_and_drafts_packs_every_profile_from_one_draw():
    """Several draft profiles from one draw equal one draw each, and
    share the target's embed and lm_head."""
    cfg = get_config("deepseek_moe_16b", reduced=True)
    params, drafts = ttf.init_params_and_drafts(
        4, cfg, ("w4s50", "w4l25"), "cpu", compress=GQSAConfig())
    assert sorted(drafts) == ["w4l25", "w4s50"]
    for profile, draft in drafts.items():
        want_params, want = ttf.init_params_and_draft(
            4, cfg, profile, "cpu", compress=GQSAConfig())
        _assert_trees_equal(params, want_params)
        _assert_trees_equal(draft, want)
        assert draft["lm_head"] is params["lm_head"]


# ---------------------------------------------------------------------------
# one round on the pool
# ---------------------------------------------------------------------------

def test_chain_round_matches_reference_on_the_pool(models):
    """From the same prefilled pool, one draft + verify round in both
    packages emits the same tokens, and the pool's committed rows (every
    position below each active slot's new position, every layer) agree:
    the port's drafter writes the pool in place, the reference's a copy
    it drops, and the verify rewrites every position either wrote."""
    profile, k = "w4s75", 3
    jcfg, cfg = models["jcfg"], models["cfg"]
    dl = draft_layers(cfg, profile)
    jd = jcompress_draft(models["jfp"], jcfg, profile=profile)
    td = params_from_numpy(jax_tree_to_numpy(jd), "cpu")
    tokens, lengths, bt, _ = slice_inputs(jcfg.vocab, 1)
    jl, jcache, tl, tcache = prefill_both(jcfg, models["jtarget"], cfg,
                                          models["target"], tokens, lengths,
                                          bt)
    first = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    active = (lengths > 0).astype(np.int32)
    remaining = active * 8
    mp = bt.shape[1]
    jdraft_fn, jverify_fn = jspec_step_fns(jcfg, JSamplingParams(), False, k,
                                           dl)
    jdraft = jdraft_fn(jd, jcache, jnp.asarray(first), jnp.asarray(lengths),
                       jnp.asarray(bt), mp)
    jout, jn, _, jpos, _, jcache, _ = jverify_fn(
        models["jtarget"], jcache, jnp.asarray(first), jdraft,
        jnp.asarray(lengths), jnp.asarray(bt), jnp.asarray(active),
        jnp.asarray(remaining), jax.random.PRNGKey(0), mp)
    draft_fn, verify_fn = spec_step_fns(cfg, GREEDY, k, dl)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    tdraft = draft_fn(td, tcache, t(first), t(lengths), t(bt), mp)
    np.testing.assert_array_equal(tdraft.numpy(), np.asarray(jdraft))
    tout, tn, _, tpos, _ = verify_fn(models["target"], tcache, t(first),
                                     tdraft, t(lengths), t(bt), t(active),
                                     t(remaining), None, mp)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for i in np.flatnonzero(active):
        n = int(np.asarray(jn)[i])
        np.testing.assert_array_equal(tout[i, :n].numpy(),
                                      np.asarray(jout)[i, :n])
        rows = [(bt[i, p // PAGE], p % PAGE)
                for p in range(int(np.asarray(jpos)[i]))]
        for name in ("k_pages", "v_pages"):
            want = np.stack([np.asarray(jcache[name])[:, pg, off]
                             for pg, off in rows], 1)
            got = np.stack([tcache[name][:, pg, off].numpy()
                            for pg, off in rows], 1)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _engine(cfg, params, draft=None, **spec):
    return InferenceEngine(cfg, params, EngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE, device="cpu", **spec),
        GREEDY, draft_params=draft)


def test_chain_spec_greedy_equals_plain_and_reference(models):
    """Chain speculation (K = 3, draft w4s75) serves greedy tokens equal
    to the port's non-speculative engine and to the reference's
    speculative engine on the same weights."""
    profile, k = "w4s75", 3
    jcfg, cfg = models["jcfg"], models["cfg"]
    dl = draft_layers(cfg, profile)
    jd = jcompress_draft(models["jfp"], jcfg, profile=profile)
    prompts, max_new = engine_prompts(jcfg.vocab), 8
    ref = serve_all(JInferenceEngine(
        jcfg, models["jtarget"], JEngineConfig(
            num_slots=2, max_seq=32, page_size=PAGE, spec_k=k,
            spec_draft_layers=dl), draft_params=jd), prompts, max_new)
    plain = serve_all(_engine(cfg, models["target"]), prompts, max_new)
    eng = _engine(cfg, models["target"],
                  params_from_numpy(jax_tree_to_numpy(jd), "cpu"),
                  spec_k=k, spec_draft_layers=dl)
    got = serve_all(eng, prompts, max_new)
    assert {r: list(t) for r, t in got.items()} \
        == {r: list(t) for r, t in plain.items()}
    m = eng.metrics.summary()
    assert m["spec_rounds"] > 0 and m["draft_proposed"] > 0
    assert eng.kv.allocator.num_free == eng.kv.num_pages
    assert_greedy_match(ref, got, prompts, lambda rid: port_greedy_margins(
        cfg, models["target"], prompts[rid], ref[rid]), max_new)


@pytest.mark.parametrize("arch", ["llama2_7b", "deepseek_moe_16b",
                                  "deepseek_v2_236b"])
def test_engine_refuses_spec_without_draft_params(arch):
    cfg = get_config(arch, reduced=True)
    with pytest.raises(ValueError, match="draft_params"):
        _engine(cfg, ttf.init_params(0, cfg, "cpu"), spec_k=2)


@pytest.mark.parametrize("slots", [2, 5])
def test_engine_counts_batched_prefills(models, slots):
    """The metrics' ``prefills`` counts the engine's batched prefill calls
    (one an admission group): one for 5 prompts on 5 slots, one a
    prefill-function call on 2 slots."""
    cfg = models["cfg"]
    eng = InferenceEngine(cfg, models["target"], EngineConfig(
        num_slots=slots, max_seq=32, page_size=PAGE, device="cpu"), GREEDY)
    calls, inner = [], eng._prefill_fn

    def counted(*args):
        calls.append(1)
        return inner(*args)
    eng._prefill_fn = counted
    serve_all(eng, engine_prompts(cfg.vocab), 4)
    assert eng.metrics.summary()["prefills"] == len(calls)
    assert len(calls) == 1 if slots == 5 else len(calls) >= 3


def test_chain_spec_sampled_runs(models):
    """Temperature 0.8, top-k 16: budgets exact, tokens in range, the
    accounting sane and the pool drained."""
    cfg = models["cfg"]
    draft = compress_draft(models["fp"], cfg, "w4")
    eng = InferenceEngine(cfg, models["target"], EngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE, device="cpu", spec_k=3),
        SamplingParams(temperature=0.8, top_k=16), draft_params=draft)
    res = serve_all(eng, engine_prompts(cfg.vocab), 5)
    assert all(t.shape == (5,) and (t >= 0).all() and (t < cfg.vocab).all()
               for t in res.values())
    m = eng.metrics.summary()
    assert m["draft_accepted"] <= m["draft_proposed"]
    assert eng.kv.allocator.num_free == eng.kv.num_pages
