"""Port conformance, chunked prefill beside speculation and on the MoE
families: chain (``spec_k=2``) and tree (``spec_fanout=(2, 2)``)
speculation on the reduced llama2-7b, and plain chunking on the reduced
deepseek-moe-16b (K/V pool) and DeepSeek-V2 (latent pool), both
dropless. Each case serves the same prompts three ways: the reference
engine chunked, the port chunked and the port unchunked (GQSA W4 S50 G16
targets and w4s75 drafts packed by the reference, carried over through
the bridge).

While a slot is mid-prompt a speculative engine runs one-step plain
segments that log into the spec log at width 1; without that, the tokens
of those steps would be lost. Dropless (``capacity_factor`` 16) because a
chunk routes another token count than a monolithic prefill, so at the
configs' 1.25 which routed entries drop differs with chunking on and off,
in the reference too.

Tolerances: chunked tokens equal the port's own unchunked tokens;
against the reference's chunked run, equal wherever its top-2 margin
exceeds 1e-3 (``tests/_torch_utils.py:assert_greedy_match``); the chunk
counters exactly the reference's, whose ``preemptions`` stays 0 (the
port does not preempt yet, ROADMAP A.5)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

# the suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps these small products from crowding the other files
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.gqs_layer import GQSAConfig as JGQSAConfig  # noqa: E402
from repro.core.model_compress import compress_draft as jcompress_draft  # noqa: E402
from repro.core.model_compress import compress_params as jcompress  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.model_compress import draft_layers  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402

from _engine_utils import make_prompts  # noqa: E402
from _torch_utils import (assert_greedy_match, jax_tree_to_numpy,  # noqa: E402
                          reference_margins)

GRID = dict(num_slots=2, max_seq=32, page_size=4)
BUDGET, MAX_NEW, PROFILE = 5, 6, "w4s75"
COUNTERS = ("engine.prefill_chunks", "engine.prefill_chunk_tokens",
            "kv.page_allocs", "kv.page_frees")


def _serve(eng, prompts):
    rids = [eng.submit(p.copy(), MAX_NEW) for p in prompts]
    by = {r["rid"]: np.asarray(r["tokens"]) for r in eng.run()["results"]}
    alc = eng.kv.allocator
    assert alc.num_free + alc.num_outstanding == eng.kv.num_pages
    return {i: by[r] for i, r in enumerate(rids)}


def _counters(eng):
    reg = eng.tel.registry
    return {c: reg.counter(c).value for c in COUNTERS}


def _dropless(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0))


@functools.lru_cache(maxsize=None)
def _fp(arch):
    jcfg = _dropless(jget_config(arch, reduced=True))
    return jcfg, jtf.init_params(jax.random.PRNGKey(0), jcfg)


@functools.lru_cache(maxsize=None)
def _packed(arch, profile=None):
    """(reference tree, its bridged form): the GQSA target, or the draft
    of ``profile``."""
    jcfg, jfp = _fp(arch)
    tree = jcompress(jfp, jcfg, JGQSAConfig(saliency="magnitude")) \
        if profile is None else jcompress_draft(jfp, jcfg, profile=profile)
    return tree, params_from_numpy(jax_tree_to_numpy(tree), "cpu")


def _three_ways(arch, spec, prompts):
    """(reference chunked, port chunked, port unchunked, port chunked
    engine, reference engine)."""
    jcfg = _fp(arch)[0]
    cfg = _dropless(get_config(arch, reduced=True))
    jp, tp = _packed(arch)
    jd = td = None
    if spec:
        jd, td = _packed(arch, PROFILE)
        spec = dict(spec, spec_draft_layers=draft_layers(cfg, PROFILE))
    ref_eng = JInferenceEngine(jcfg, jp, JEngineConfig(
        prefill_chunk_tokens=BUDGET, **GRID, **spec), draft_params=jd)
    ref = _serve(ref_eng, prompts)
    assert ref_eng.metrics.summary()["preemptions"] == 0

    def port(chunk):
        return InferenceEngine(cfg, tp, EngineConfig(
            device="cpu", prefill_chunk_tokens=chunk, **GRID, **spec),
            draft_params=td)
    eng = port(BUDGET)
    got = _serve(eng, prompts)
    off = _serve(port(0), prompts)
    return ref, got, off, eng, ref_eng


def _check(arch, spec, prompts):
    ref, got, off, eng, ref_eng = _three_ways(arch, spec, prompts)
    assert sorted(got) == sorted(off)
    for k in got:
        np.testing.assert_array_equal(got[k], off[k], err_msg=str(k))

    def margins(rid):
        # the reference's full forward, only where tokens differ
        return reference_margins(_fp(arch)[0], _packed(arch)[0], prompts,
                                 ref, MAX_NEW)(rid)
    assert_greedy_match(ref, got, prompts, margins, MAX_NEW)
    mine = _counters(eng)
    assert mine == _counters(ref_eng)
    long = [p for p in prompts if len(p) > BUDGET]
    assert mine["engine.prefill_chunk_tokens"] == sum(map(len, long)) > 0
    return eng


@pytest.mark.parametrize("mode", ["chain", "tree"])
def test_chunked_speculation_matches_reference_and_unchunked(mode):
    """Speculation pauses while a prompt is chunking: the plain steps'
    tokens land in the spec log, and tokens equal the unchunked run's."""
    spec = dict(spec_k=2) if mode == "chain" else dict(spec_fanout=(2, 2))
    vocab = get_config("llama2_7b", reduced=True).vocab
    eng = _check("llama2_7b", spec,
                 make_prompts(vocab, (9, 3, 13, 6, 11), seed=21))
    m = eng.metrics.summary()
    assert m["spec_rounds"] > 0


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "deepseek_v2_236b"])
def test_chunked_moe_dropless_matches_reference_and_unchunked(arch):
    vocab = get_config(arch, reduced=True).vocab
    _check(arch, {}, make_prompts(vocab, (9, 3, 13, 6), seed=21))
