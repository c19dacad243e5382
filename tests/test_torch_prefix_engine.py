"""Port conformance, the serving engine with the shared-prefix KV cache
(``EngineConfig(prefix_cache=True)``, ``--prefix-cache``): greedy tokens
with the cache on against the port's own run with it off and against the
reference engine with it on, on the reduced llama2-7b (GQSA W4 S50 G16,
packed by the reference and carried over through the bridge); the
``prefix.*`` counters against the reference's; eviction under a small
pool; chain and tree speculation, the int8 pool and the latent pool with
the cache on; chunked prefill with the cache on; and the serve CLI.

Tolerances: tokens with the cache on equal the port's own tokens with
it off (the tail dispatch and the batched prefill compute the same f32
values in another order; on these seeds no greedy step is near a tie);
against the reference engine, equal wherever the top-2 margin exceeds
1e-3 (``tests/_torch_utils.py:assert_greedy_match``); counters exactly
equal (the same admission order and bookkeeping)."""
import dataclasses
import re

import numpy as np
import pytest
import torch

# the suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps these small products from crowding the other files
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.gqs_layer import GQSAConfig as JGQSAConfig  # noqa: E402
from repro.core.model_compress import compress_params as jcompress  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.gqs_layer import GQSAConfig  # noqa: E402
from repro_torch.core.model_compress import draft_layers  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

from _engine_utils import make_prompts, shared_prompts  # noqa: E402
from _torch_utils import (assert_greedy_match, jax_tree_to_numpy,  # noqa: E402
                          port_greedy_margins)

COUNTERS = ("prefix.hits", "prefix.misses", "prefix.hit_tokens",
            "prefix.cow_copies", "prefix.evicted_pages",
            "prefix.inserted_pages", "kv.page_allocs", "kv.page_frees")


@pytest.fixture(scope="module")
def packed():
    """(jax cfg, jax GQSA params, port cfg, port params) of the reduced
    llama2-7b."""
    jcfg = jget_config("llama2_7b", reduced=True)
    jp = jcompress(jtf.init_params(jax.random.PRNGKey(0), jcfg), jcfg,
                   JGQSAConfig())
    return (jcfg, jp, get_config("llama2_7b", reduced=True),
            params_from_numpy(jax_tree_to_numpy(jp), "cpu"))


def _serve(eng, prompts, max_new):
    rids = [eng.submit(p.copy(), max_new) for p in prompts]
    by = {r["rid"]: np.asarray(r["tokens"]) for r in eng.run()["results"]}
    alc = eng.kv.allocator
    assert alc.num_free + alc.num_outstanding == eng.kv.num_pages
    return {i: by[r] for i, r in enumerate(rids)}


def _port(cfg, params, prefix, draft=None, **kw):
    kw = dict(dict(num_slots=2, max_seq=32, page_size=4), **kw)
    return InferenceEngine(cfg, params, EngineConfig(
        prefix_cache=prefix, device="cpu", **kw), draft_params=draft)


def _counters(reg):
    return ({c: reg.counter(c).value for c in COUNTERS},
            reg.gauge("prefix.cached_pages").value)


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def test_prefix_engine_matches_reference_and_the_cache_off(packed):
    """Short and long tails fill the first (cold) admission wave; the
    bare prefix arrives warm, so its page-aligned hit copies on write.
    Tokens equal the cache-off run's and the reference's; the counters
    are the reference's, with fewer page allocations than off."""
    jcfg, jp, cfg, params = packed
    prompts = shared_prompts(cfg.vocab, 8, [3, 9, 0], seed=4) \
        + make_prompts(cfg.vocab, (6,), seed=5) \
        + shared_prompts(cfg.vocab, 8, [5, 0], seed=4)
    max_new = 6
    ref_eng = JInferenceEngine(jcfg, jp, JEngineConfig(
        num_slots=2, max_seq=32, page_size=4, prefix_cache=True))
    ref = _serve(ref_eng, prompts, max_new)
    off_eng = _port(cfg, params, False)
    off = _serve(off_eng, prompts, max_new)
    eng = _port(cfg, params, True)
    got = _serve(eng, prompts, max_new)
    _equal(got, off)
    assert_greedy_match(ref, got, prompts, lambda rid: port_greedy_margins(
        cfg, params, prompts[rid], ref[rid]), max_new)
    mine = _counters(eng.tel.registry)
    assert mine == _counters(ref_eng.tel.registry)
    assert mine[0]["prefix.hits"] > 0 and mine[0]["prefix.cow_copies"] > 0
    assert mine[0]["kv.page_allocs"] \
        < off_eng.tel.registry.counter("kv.page_allocs").value
    m = eng.metrics.summary()
    assert m["prefill_tails"] > 0 and m["prefills"] > 0
    assert eng.kv.allocator.num_outstanding == eng.kv.prefix.cached_pages


def test_cached_prefixes_evicted_under_pool_pressure(packed):
    """A pool of about one resident request: distinct prompts stream
    through, so admission evicts stale cached prefixes instead of
    deadlocking on them. Counters equal the reference's, tokens the
    cache-off run's, and the run drains."""
    jcfg, jp, cfg, params = packed
    prompts = make_prompts(cfg.vocab, (9, 10, 11, 9), seed=8)
    kw = dict(num_slots=2, max_seq=16, page_size=4, num_pages=4)
    ref_eng = JInferenceEngine(jcfg, jp, JEngineConfig(prefix_cache=True,
                                                       **kw))
    _serve(ref_eng, prompts, 4)
    off = _serve(_port(cfg, params, False, **kw), prompts, 4)
    eng = _port(cfg, params, True, **kw)
    got = _serve(eng, prompts, 4)
    _equal(got, off)
    mine = _counters(eng.tel.registry)
    assert mine == _counters(ref_eng.tel.registry)
    assert mine[0]["prefix.evicted_pages"] > 0
    assert eng.kv.allocator.num_outstanding == eng.kv.prefix.cached_pages


@pytest.mark.parametrize("mode", ["chain", "tree"])
def test_prefix_cache_with_speculation_equals_the_cache_off(mode):
    """Chain (K = 2) and tree ((2, 2)) speculation with the cache on: the
    tail prefill's first token enters the spec log as a prefill's does,
    and the verify reads the same K/V, so tokens equal the cache-off run's
    on the same weights."""
    cfg = get_config("llama2_7b", reduced=True)
    params, draft = ttf.init_params_and_draft(0, cfg, "w4s75", "cpu",
                                              compress=GQSAConfig())
    spec = dict(spec_k=2) if mode == "chain" else dict(spec_fanout=(2, 2))
    spec["spec_draft_layers"] = draft_layers(cfg, "w4s75")
    prompts = shared_prompts(cfg.vocab, 8, [0, 5, 2], seed=6) \
        + shared_prompts(cfg.vocab, 8, [3], seed=6)
    off = _serve(_port(cfg, params, False, draft, **spec), prompts, 6)
    eng = _port(cfg, params, True, draft, **spec)
    got = _serve(eng, prompts, 6)
    _equal(got, off)
    m = eng.metrics.summary()
    assert m["prefill_tails"] > 0 and m["spec_rounds"] > 0
    assert eng.tel.registry.counter("prefix.hits").value > 0


@pytest.mark.parametrize("arch,kv", [("llama2_7b", "int8"),
                                     ("deepseek_v2_236b", None)])
def test_prefix_cache_on_other_pools_equals_the_cache_off(arch, kv):
    """The int8 pool (codes and scale pages copied on write) and
    DeepSeek-V2's latent pool, dropless so that routing does not depend
    on which rows a dispatch carries: tokens equal the cache-off run's."""
    cfg = get_config(arch, reduced=True)
    if kv is not None:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    params = ttf.init_params(0, cfg, "cpu", compress=GQSAConfig())
    prompts = shared_prompts(cfg.vocab, 8, [3, 6, 0, 1], seed=2)
    off = _serve(_port(cfg, params, False), prompts, 5)
    eng = _port(cfg, params, True)
    got = _serve(eng, prompts, 5)
    _equal(got, off)
    reg = eng.tel.registry
    assert reg.counter("prefix.hits").value > 0
    assert reg.counter("prefix.cow_copies").value > 0


def test_engine_counts_tail_dispatches(packed):
    """``prefill_tails`` counts the tail dispatches (one an admission
    group with a hit) and ``prefills`` the batched prefill calls only."""
    _, _, cfg, params = packed
    eng = _port(cfg, params, True)
    calls = {"prefill": 0, "tail": 0}
    for name in ("prefill", "tail"):
        inner = getattr(eng, f"_{name}_fn")

        def counted(*args, _inner=inner, _name=name):
            calls[_name] += 1
            return _inner(*args)
        setattr(eng, f"_{name}_fn", counted)
    _serve(eng, shared_prompts(cfg.vocab, 8, [1, 2, 3, 4, 0], seed=1), 3)
    m = eng.metrics.summary()
    assert (m["prefills"], m["prefill_tails"]) \
        == (calls["prefill"], calls["tail"])
    assert calls["tail"] > 0


def test_serve_cli_prints_the_prefix_line(capsys):
    """``--prefix-cache`` on the CPU: the CLI's prompts (4-15 tokens) fill
    no page of 16, so every admission misses, as in the reference."""
    res = serve.main(["--device", "cpu", "--reduced", "--requests", "3",
                      "--max-new", "4", "--slots", "2", "--prefix-cache"])
    out = capsys.readouterr().out
    assert re.search(r"^\[prefix\] hits=0 misses=3 hit_tokens=0 cow=0 "
                     r"evicted=0 cached=0$", out, re.M)
    assert len(res["results"]) == 3


def test_chunked_prefill_with_the_prefix_cache_equals_the_cache_off(
        packed, capsys):
    """Chunked prefill with the prefix cache on: the hits' tails (longer
    than the budget) chunk from the shared boundary, and tokens equal the
    chunked run's with the cache off. The CLI takes ``--chunked-prefill``
    beside ``--prefix-cache``."""
    _, _, cfg, params = packed
    prompts = shared_prompts(cfg.vocab, 8, [9, 6, 13, 0], seed=3)
    off = _serve(_port(cfg, params, False, prefill_chunk_tokens=4),
                 prompts, 5)
    eng = _port(cfg, params, True, prefill_chunk_tokens=4)
    got = _serve(eng, prompts, 5)
    _equal(got, off)
    reg = eng.tel.registry
    assert reg.counter("prefix.hits").value > 0
    assert reg.counter("engine.prefill_chunks").value > 0
    res = serve.main(["--device", "cpu", "--reduced", "--requests", "3",
                      "--max-new", "4", "--slots", "2", "--prefix-cache",
                      "--chunked-prefill", "4"])
    out = capsys.readouterr().out
    assert re.search(r"^\[prefix\] hits=0 misses=3 ", out, re.M)
    assert re.search(r"^\[digest\] [0-9a-f]{64}$", out, re.M)
    assert len(res["results"]) == 3
