"""Shared cases of the MoE families' speculation conformance
(``tests/test_torch_spec_moe.py`` for ``moe``, deepseek-moe-16b, on the
K/V pool; ``tests/test_torch_spec_mla_moe.py`` for ``mla_moe``,
DeepSeek-V2, on the latent pool): each function takes the arch id and
checks one behaviour in both packages on the same numpy inputs.

Capacity. Which routed entries drop depends on the whole block, so at
the configs' default ``capacity_factor`` (1.25) speculative greedy tokens
are not the non-speculative ones, in the reference either. At that
capacity the port must give the reference's speculative tokens, drops
included (it feeds the reference's batch composition, idle slots too);
dropless (``capacity_factor`` 16, the reference tests' convention) it
must give its own non-speculative tokens.

Tolerances (f32, the reduced configs' compute dtype):
  * engine tokens: equal to the reference's wherever its top-2 margin
    exceeds 1e-3 (``_torch_utils.assert_greedy_match``); dropless,
    equal to the port's own non-speculative tokens; a fanout-1 tree
    equal to the chain bit for bit, tokens and pool;
  * one round from the same prefilled pool: draft, emitted tokens and
    positions equal, committed pool rows to 1e-5 abs (the sides differ
    only in summation order);
  * the MoE block over a verify block's rows: 1e-5 abs and rel."""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as jget_config
from repro.core.gqs_layer import GQSAConfig as JGQSAConfig
from repro.core.model_compress import compress_draft as jcompress_draft
from repro.core.model_compress import compress_params as jcompress
from repro.core.model_compress import compress_params_w4 as jcompress_w4
from repro.core.quant import QuantConfig as JQuantConfig
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import InferenceEngine as JInferenceEngine
from repro.engine.sampling import SamplingParams as JSamplingParams
from repro.engine.spec import spec_step_fns as jspec_step_fns
from repro.engine.spec import tree_step_fns as jtree_step_fns
from repro.models import moe as jmoe
from repro.models import transformer as jtf

from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_config
from repro_torch.core.model_compress import draft_layers
from repro_torch.engine import EngineConfig, InferenceEngine, SamplingParams
from repro_torch.engine.spec import (TreeTemplate, spec_step_fns,
                                     tree_step_fns)
from repro_torch.launch import serve
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

from _torch_utils import (PAGE, assert_greedy_match, engine_prompts,
                          jax_tree_to_numpy, prefill_both, reference_margins,
                          serve_all, slice_inputs)

GREEDY = SamplingParams()
DROPLESS = 16.0
# (draft profile, engine spec) of the engine cases: chain K = 1 and 3,
# tree (2, 2) and (4, 2, 2)
ENGINE_CASES = {"chain1-w4s50": ("w4s50", dict(spec_k=1)),
                "chain3-w4l50": ("w4l50", dict(spec_k=3)),
                "tree22-w4s75": ("w4s75", dict(spec_fanout=(2, 2))),
                "tree422-w4l50": ("w4l50", dict(spec_fanout=(4, 2, 2)))}
# one round on the pool: chain K = 3, tree (4, 2, 2)
ROUND_CASES = {"chain": ("w4s75", 3), "tree": ("w4l50", (4, 2, 2))}


def _bridge(tree):
    return params_from_numpy(jax_tree_to_numpy(tree), "cpu")


def with_capacity(cfg, capacity_factor):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


@functools.lru_cache(maxsize=2)
def models(arch):
    """The reduced ``arch`` in both packages: the reference's FP init,
    its GQSA (W4 S50 G16) and dense-W4 (G16) targets, all bridged."""
    jcfg = jget_config(arch, reduced=True)
    jfp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    targets = {
        "gqsa": jcompress(jfp, jcfg, JGQSAConfig(saliency="magnitude")),
        "w4": jcompress_w4(jfp, jcfg, JQuantConfig(bits=4, group_size=16))}
    return dict(jcfg=jcfg, jfp=jfp, cfg=get_config(arch, reduced=True),
                targets={k: (v, _bridge(v)) for k, v in targets.items()})


@functools.lru_cache(maxsize=8)
def draft(arch, profile):
    """(reference draft tree, its bridged form) of ``profile``."""
    m = models(arch)
    jd = jcompress_draft(m["jfp"], m["jcfg"], profile=profile)
    return jd, _bridge(jd)


def _engine(cfg, params, draft_params=None, profile=None, **spec):
    return InferenceEngine(cfg, params, EngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE, device="cpu",
        spec_draft_layers=draft_layers(cfg, profile) if profile else None,
        **spec), GREEDY, draft_params=draft_params)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def check_engine_matches_reference(arch, target, case):
    """At the default capacity the port's speculative engine serves the
    reference engine's speculative greedy tokens, drops included, and
    drains its pool."""
    profile, spec = ENGINE_CASES[case]
    m = models(arch)
    jcfg, cfg = m["jcfg"], m["cfg"]
    jp, tp = m["targets"][target]
    jd, td = draft(arch, profile)
    prompts, max_new = engine_prompts(jcfg.vocab), 8
    ref = serve_all(JInferenceEngine(jcfg, jp, JEngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE,
        spec_draft_layers=draft_layers(cfg, profile), **spec),
        draft_params=jd), prompts, max_new)
    eng = _engine(cfg, tp, td, profile, **spec)
    got = serve_all(eng, prompts, max_new)
    summary = eng.metrics.summary()
    assert summary["spec_rounds"] > 0 and summary["verify_tokens"] > 0
    assert eng.kv.allocator.num_free == eng.kv.num_pages
    assert_greedy_match(ref, got, prompts,
                        reference_margins(jcfg, jp, prompts, ref, max_new),
                        max_new)


def check_dropless_equals_plain(arch, mode):
    """Dropless, chain, tree and adaptive-tree speculation serve the
    port's own non-speculative greedy tokens."""
    m = models(arch)
    cfg = with_capacity(m["cfg"], DROPLESS)
    tp = m["targets"]["gqsa"][1]
    spec, profile = {"chain": (dict(spec_k=3), "w4s50"),
                     "tree": (dict(spec_fanout=(4, 2, 2)), "w4l50"),
                     "adaptive": (dict(spec_fanout=(2, 2),
                                       spec_adaptive=True), "w4s75")}[mode]
    prompts = engine_prompts(cfg.vocab)
    want = serve_all(_engine(cfg, tp), prompts, 8)
    eng = _engine(cfg, tp, draft(arch, profile)[1], profile, **spec)
    got = serve_all(eng, prompts, 8)
    assert {r: list(t) for r, t in got.items()} \
        == {r: list(t) for r, t in want.items()}
    summary = eng.metrics.summary()
    assert summary["spec_rounds"] > 0
    assert np.isfinite(summary["accepted_len_mean"])
    assert eng.kv.allocator.num_free == eng.kv.num_pages


def check_fanout1_tree_equals_chain(arch, k):
    """Dropless, a fanout-1 tree is the chain: tokens, the whole pool
    and the positions end bit-identical."""
    m = models(arch)
    cfg = with_capacity(m["cfg"], DROPLESS)
    tp = m["targets"]["gqsa"][1]
    td = draft(arch, "w4l50")[1]
    chain = _engine(cfg, tp, td, "w4l50", spec_k=k)
    tree = _engine(cfg, tp, td, "w4l50", spec_fanout=(1,) * k)
    prompts = engine_prompts(cfg.vocab)
    got_c, got_t = serve_all(chain, prompts, 6), serve_all(tree, prompts, 6)
    assert {r: list(t) for r, t in got_c.items()} \
        == {r: list(t) for r, t in got_t.items()}
    for name in chain.kv.data:
        assert torch.equal(chain.kv.data[name], tree.kv.data[name]), name
    assert torch.equal(chain._positions, tree._positions)


def check_leak_free(arch, seed, mode):
    """Pages never leak: random admission and eviction interleaved with
    speculative rounds (the chain rewinds by position, the tree also
    compacts the accepted path) give every page back; the pool holds
    about one resident request, so requests stream through the slots."""
    m = models(arch)
    cfg = m["cfg"]
    kind, spec = mode
    if kind == "chain":
        lookahead, ecfg = spec, dict(spec_k=spec)
    else:
        lookahead, ecfg = TreeTemplate(spec).n_nodes, dict(spec_fanout=spec)
    eng = InferenceEngine(cfg, m["targets"]["gqsa"][1], EngineConfig(
        num_slots=2, max_seq=16, page_size=4, device="cpu",
        num_pages=-(-(16 + lookahead) // 4) + 1,
        spec_draft_layers=draft_layers(cfg, "w4l50"), **ecfg), GREEDY,
        draft_params=draft(arch, "w4l50")[1])
    initial = eng.kv.allocator.num_free
    g = np.random.default_rng(seed)
    prompts = [g.integers(0, cfg.vocab, n).astype(np.int32)
               for n in g.integers(3, 8, size=4)]
    got = serve_all(eng, prompts, 4)
    assert len(got) == 4 and all(len(t) == 4 for t in got.values())
    assert eng.metrics.summary()["spec_rounds"] > 0
    assert eng.kv.allocator.num_free == initial


def check_serve_cli(arch, flags, out_of):
    """The serve CLI answers every request with speculative rounds; its
    weights are the port's own draws (``out_of()`` returns the captured
    stdout)."""
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--requests", "3", "--max-new", "6", "--slots", "2"]
                     + flags)
    out = out_of()
    assert re.search(r"^\[digest\] [0-9a-f]{64}$", out, re.M)
    assert "packed draft profile" in out
    assert len(res["results"]) == 3
    assert all(len(r["tokens"]) == 6 for r in res["results"])
    assert res["spec_rounds"] > 0


# ---------------------------------------------------------------------------
# one round on the pool
# ---------------------------------------------------------------------------

def _round_inputs(arch):
    m = models(arch)
    jp, tp = m["targets"]["gqsa"]
    tokens, lengths, bt, _ = slice_inputs(m["jcfg"].vocab, 1)
    jl, jcache, _, tcache = prefill_both(m["jcfg"], jp, m["cfg"], tp, tokens,
                                         lengths, bt)
    first = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    active = (lengths > 0).astype(np.int32)
    return jcache, tcache, first, lengths, bt, active, active * 8


def _t(a):
    return torch.from_numpy(np.asarray(a))


def check_round_matches_reference(arch, kind):
    """At the default capacity, from the same prefilled pool (three
    slots, one idle), one chain or tree draft + verify round in both
    packages: the same draft, emitted tokens and positions, and the same
    committed rows in every layer of every pool leaf (K/V pages, or the
    latent pages) after the verify, and the tree's compaction."""
    m = models(arch)
    jcfg, cfg = m["jcfg"], m["cfg"]
    profile, shape = ROUND_CASES[kind]
    dl = draft_layers(cfg, profile)
    jd, td = draft(arch, profile)
    jp, tp = m["targets"]["gqsa"]
    jcache, tcache, first, lengths, bt, active, rem = _round_inputs(arch)
    mp = bt.shape[1]
    if kind == "chain":
        jdraft_fn, jverify_fn = jspec_step_fns(jcfg, JSamplingParams(),
                                               False, shape, dl)
        draft_fn, verify_fn = spec_step_fns(cfg, GREEDY, shape, dl)
    else:
        jdraft_fn, jverify_fn, _ = jtree_step_fns(jcfg, JSamplingParams(),
                                                  False, shape, dl)
        draft_fn, verify_fn, _ = tree_step_fns(cfg, GREEDY, shape, dl)
    jdraft = jdraft_fn(jd, jcache, jnp.asarray(first), jnp.asarray(lengths),
                       jnp.asarray(bt), mp)
    jout, jn, _, jpos, _, jcache, _ = jverify_fn(
        jp, jcache, jnp.asarray(first), jdraft, jnp.asarray(lengths),
        jnp.asarray(bt), jnp.asarray(active), jnp.asarray(rem),
        jax.random.PRNGKey(0), mp)
    tdraft = draft_fn(td, tcache, _t(first), _t(lengths), _t(bt), mp)
    np.testing.assert_array_equal(tdraft.numpy(), np.asarray(jdraft))
    tout, tn, _, tpos, _ = verify_fn(tp, tcache, _t(first), tdraft,
                                     _t(lengths), _t(bt), _t(active),
                                     _t(rem), None, mp)
    jn, jpos = np.asarray(jn), np.asarray(jpos)
    np.testing.assert_array_equal(tn.numpy(), jn)
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    assert sorted(tcache) == sorted(jcache)
    for i in np.flatnonzero(active):
        np.testing.assert_array_equal(tout[i, :jn[i]].numpy(),
                                      np.asarray(jout)[i, :jn[i]])
        rows = [(bt[i, p // PAGE], p % PAGE) for p in range(int(jpos[i]))]
        for name in tcache:
            want = np.stack([np.asarray(jcache[name])[:, pg, off]
                             for pg, off in rows], 1)
            got = np.stack([tcache[name][:, pg, off].numpy()
                            for pg, off in rows], 1)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                       err_msg=name)


def check_round_reads_nothing_on_the_host(arch, tree):
    """A whole draft + verify round (routing and dispatch of every
    call, the tree's compaction) only enqueues: nothing read on the
    host."""
    from torch.profiler import ProfilerActivity, profile
    m = models(arch)
    cfg = m["cfg"]
    _, tcache, first, lengths, bt, active, rem = _round_inputs(arch)
    dl = draft_layers(cfg, "w4l50")
    if tree:
        draft_fn, verify_fn, _ = tree_step_fns(cfg, GREEDY, (2, 2), dl)
    else:
        draft_fn, verify_fn = spec_step_fns(cfg, GREEDY, 3, dl)
    td, tp = draft(arch, "w4l50")[1], m["targets"]["w4"][1]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        d = draft_fn(td, tcache, _t(first), _t(lengths), _t(bt), 4)
        verify_fn(tp, tcache, _t(first), d, _t(lengths), _t(bt),
                  _t(active), _t(rem), None, 4)
    reads = [e.key for e in prof.key_averages()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads


# ---------------------------------------------------------------------------
# the MoE block over a round's rows
# ---------------------------------------------------------------------------

def check_moe_block_over_block(arch, t, capacity_factor):
    """The MoE block (GQSA experts) on a 4-slot block of ``t`` rows a
    slot (a chain verify, a tree level, a tree verify), one slot's rows
    those of an idle slot: capacity from all 4 x t rows, drops in
    token-major order, as the reference's ``moe_block``."""
    m = models(arch)
    jcfg = with_capacity(m["jcfg"], capacity_factor)
    cfg = with_capacity(m["cfg"], capacity_factor)
    jp, tp = m["targets"]["gqsa"]
    jl = jax.tree_util.tree_map(lambda a: a[1], jp["layers"]["moe"])
    tl = ttf.layer_params(tp["layers"]["moe"], 1)
    g = np.random.default_rng(t)
    x = g.normal(size=(4, t, cfg.d_model)).astype(np.float32)
    x[2] = x[2, :1]                         # an idle slot repeats one row
    want, _ = jmoe.moe_block(jl, jnp.asarray(x), jcfg)
    got, _ = tmoe.moe_block(tl, torch.from_numpy(x), cfg, aux=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    return tmoe.capacity(4 * t, cfg.moe)
