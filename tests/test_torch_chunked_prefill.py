"""Port conformance, chunked prefill (``EngineConfig(prefill_chunk_tokens=N)``,
``--chunked-prefill N``) on the reduced llama2-7b (GQSA W4 S50 G16, packed
by the reference and carried over through the bridge): the chunk planner
against the reference's; greedy tokens with chunking on against the
port's own run with it off and against the reference engine's chunked
run, in plain mode, on the int8 pool, with the prefix cache and at a
budget of one token; the chunk counters against the reference's;
leak-free paging; the ``prefill_chunk`` spans; the host syncs of a
chunked run; the decode-side masking of a slot mid-prompt; the serve CLI.

Tolerances: tokens with chunking on equal the port's own tokens with it
off (a chunk and the batched prefill compute the same f32 values in
another order; on these seeds no greedy step is near a tie); against the
reference engine, equal wherever the top-2 margin exceeds 1e-3
(``tests/_torch_utils.py:assert_greedy_match``); counters and plans
exactly equal; the pages of a slot mid-prompt bit-unchanged by a decode
step. The reference engine preempts under KV pressure by default and the
port does not (ROADMAP A.5): every pool here is large enough that the
reference's ``preemptions`` stays 0, and the tests assert it."""
import dataclasses
import re

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # pragma: no cover
    from _hyp import given, settings, st

# the suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps these small products from crowding the other files
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.gqs_layer import GQSAConfig as JGQSAConfig  # noqa: E402
from repro.core.model_compress import compress_params as jcompress  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.engine import plan_chunks as jplan_chunks  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.engine import (EngineConfig, InferenceEngine,  # noqa: E402
                                Telemetry, plan_chunks)
from repro_torch.engine.scheduler import PREFILLING  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

from _engine_utils import make_prompts, shared_prompts  # noqa: E402
from _torch_utils import (assert_greedy_match, jax_tree_to_numpy,  # noqa: E402
                          port_greedy_margins)

GRID = dict(num_slots=2, max_seq=32, page_size=4)
COUNTERS = ("engine.prefill_chunks", "engine.prefill_chunk_tokens",
            "kv.page_allocs", "kv.page_frees")
MAX_NEW = 6


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
    """Tokens by submission index; page conservation checked."""
    rids = [eng.submit(p.copy(), max_new) for p in prompts]
    by = {r["rid"]: np.asarray(r["tokens"]) for r in eng.run()["results"]}
    alc = eng.kv.allocator
    assert alc.num_free + alc.num_outstanding == eng.kv.num_pages
    return {i: by[r] for i, r in enumerate(rids)}


def _port(cfg, params, chunk, telemetry=None, **kw):
    return InferenceEngine(cfg, params, EngineConfig(
        device="cpu", prefill_chunk_tokens=chunk, **dict(GRID, **kw)),
        telemetry=telemetry)


def _counters(reg):
    return {c: reg.counter(c).value for c in COUNTERS}


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(st.integers(1, 256), st.integers(0, 255), st.integers(-1, 64))
def test_plan_chunks_matches_reference(prompt_len, start, budget):
    start = start % prompt_len
    got = plan_chunks(start, prompt_len, budget)
    assert got == [tuple(c) for c in jplan_chunks(start, prompt_len, budget)]
    assert sum(n for _, n in got) == prompt_len - start
    assert got[-1][0] + got[-1][1] == prompt_len


# ---------------------------------------------------------------------------
# the engine against the reference's chunked run and its own unchunked run
# ---------------------------------------------------------------------------

# mode -> (budget, extra engine options, int8 pool, prompts(vocab))
MODES = {
    "plain": (5, {}, False,
              lambda v: make_prompts(v, (9, 3, 13, 6, 11), seed=21)),
    "int8": (5, {}, True,
             lambda v: make_prompts(v, (9, 3, 13, 6, 11), seed=21)),
    # tails longer than the budget: the hits chunk their tails from the
    # shared boundary
    "prefix": (5, dict(prefix_cache=True), False,
               lambda v: shared_prompts(v, 8, [7, 0, 11], seed=22)
               + make_prompts(v, (6,), seed=23)),
    "budget1": (1, {}, False,
                lambda v: make_prompts(v, (9, 3, 13, 6, 11), seed=21)),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_chunked_engine_matches_reference_and_unchunked(packed, mode):
    jcfg, jp, cfg, params = packed
    budget, kw, int8, make = MODES[mode]
    if int8:
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    prompts = make(cfg.vocab)
    ref_eng = JInferenceEngine(jcfg, jp, JEngineConfig(
        prefill_chunk_tokens=budget, **dict(GRID, **kw)))
    ref = _serve(ref_eng, prompts, MAX_NEW)
    assert ref_eng.metrics.summary()["preemptions"] == 0
    off = _serve(_port(cfg, params, 0, **kw), prompts, MAX_NEW)
    eng = _port(cfg, params, budget, **kw)
    got = _serve(eng, prompts, MAX_NEW)
    _equal(got, off)
    assert_greedy_match(ref, got, prompts, lambda rid: port_greedy_margins(
        cfg, params, prompts[rid], ref[rid]), MAX_NEW)
    mine = _counters(eng.tel.registry)
    assert mine == _counters(ref_eng.tel.registry)
    long = [p for p in prompts if len(p) > budget]
    assert mine["engine.prefill_chunks"] > len(long) > 0
    if not kw:
        assert mine["engine.prefill_chunk_tokens"] == sum(map(len, long))
    else:
        assert eng.tel.registry.counter("prefix.hits").value > 0


@settings(max_examples=4, deadline=None, derandomize=True, database=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 6))
def test_chunked_admission_leak_free(packed, seed, budget):
    """Mixed-length prompts churn through a pool of about two resident
    requests with chunking on: every request drains with its budget and
    no page leaks."""
    _, _, cfg, params = packed
    rng = np.random.default_rng(seed)
    prompts = make_prompts(cfg.vocab, rng.integers(2, 14, size=8),
                           seed=seed % 997)
    eng = _port(cfg, params, budget, num_pages=12)
    got = _serve(eng, prompts, 4)
    assert len(got) == len(prompts)
    assert all(len(t) == 4 for t in got.values())
    assert eng.kv.allocator.num_outstanding == 0


# ---------------------------------------------------------------------------
# spans, host syncs and the decode-side mask
# ---------------------------------------------------------------------------

def _chunk_spans(tel):
    return [e for e in tel.tracer.events
            if e.get("ph") == "X" and e.get("name") == "prefill_chunk"]


def test_chunk_spans_in_trace(packed):
    """11 tokens at budget 3 take 4 chunks and 8 take 3, the two slots fed
    in shared dispatches: at least 4 spans, each prompt completed once."""
    _, _, cfg, params = packed
    tel = Telemetry(trace=True)
    eng = _port(cfg, params, 3, telemetry=tel)
    _serve(eng, make_prompts(cfg.vocab, (11, 8), seed=51), 4)
    spans = _chunk_spans(tel)
    assert len(spans) >= 4
    assert sum(e["args"]["completed"] for e in spans) == 2
    assert sum(e["args"]["chunk_tokens"] for e in spans) == 19
    assert all(e["args"]["bucket"] == 8 for e in spans)


def test_host_waits_only_at_dispatches_that_complete_a_prompt(packed):
    """``_wait_all`` runs once after every dispatch that completes a
    prompt (a chunk dispatch with a final chunk, or a batched prefill) and
    never after an intermediate chunk."""
    _, _, cfg, params = packed
    tel = Telemetry(trace=True)
    eng = _port(cfg, params, 3, telemetry=tel)
    events = []
    for attr, name in (("_tail_fn", "chunk"), ("_prefill_fn", "prefill"),
                       ("_wait_all", "wait")):
        inner = getattr(eng, attr)

        def wrapped(*args, _inner=inner, _name=name):
            events.append(_name)
            return _inner(*args)
        setattr(eng, attr, wrapped)
    _serve(eng, make_prompts(cfg.vocab, (11, 2, 8, 13, 3), seed=52), 4)
    completed = [e["args"]["completed"] for e in _chunk_spans(tel)]
    waits, chunk_i = [], 0
    for ev in events:
        if ev == "wait":
            waits[-1][1] += 1
        else:
            waits.append([ev, 0])
    got = []
    for kind, n in waits:
        if kind == "chunk":
            assert n == (1 if completed[chunk_i] else 0), (chunk_i, n)
            chunk_i += 1
        else:
            assert n == 1
        got.append(kind)
    assert chunk_i == len(completed) and 0 in completed
    assert "prefill" in got and sum(completed) == 3


def test_chunked_run_never_reads_the_device_on_the_host(packed):
    """A whole chunked run, admission to materialization, reads no device
    value on the host (no ``aten::item`` / ``_local_scalar_dense``)."""
    _, _, cfg, params = packed
    eng = _port(cfg, params, 4)
    for p in make_prompts(cfg.vocab, (13, 2, 9), seed=53):
        eng.submit(p, 3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = eng.run()
    assert len(out["results"]) == 3
    assert eng.tel.registry.counter("engine.prefill_chunks").value > 0
    reads = [e.key for e in prof.key_averages()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads


def test_prefilling_slot_masked_and_its_pages_unchanged_by_decode(packed):
    """While a slot is mid-prompt, every decode step that runs beside it
    gives it an all-sentinel table row and leaves every page of its
    reservation bit-unchanged, in every leaf of every layer."""
    _, _, cfg, params = packed
    eng = _port(cfg, params, 4)
    checked = []
    inner = eng._decode_fn

    def wrapped(*args):
        bt = args[4]
        snaps = []
        for s in eng.scheduler.slots:
            r = s.request
            if r is None or r.state != PREFILLING:
                continue
            assert bool((bt[r.slot] == eng.kv.sentinel).all())
            row = eng.kv.block_tables[r.slot]
            pages = torch.from_numpy(row[row != eng.kv.sentinel]).long()
            snaps.append((pages, {k: v[:, pages].clone()
                                  for k, v in eng.kv.data.items()}))
        out = inner(*args)
        for pages, snap in snaps:
            for k, v in eng.kv.data.items():
                assert torch.equal(v[:, pages], snap[k]), k
        checked.append(len(snaps))
        return out
    eng._decode_fn = wrapped
    short, long = make_prompts(cfg.vocab, (3, 17), seed=54)
    eng.submit(short, 10)
    eng.submit(long, 4)
    eng.run()
    assert sum(checked) >= 4


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def test_serve_cli_chunked_prints_the_unchunked_digest(capsys):
    """``--chunked-prefill 4`` on the CPU: the CLI's 4-15-token prompts
    chunk, and the greedy ``[digest]`` is the run's without the flag."""
    digests = []
    for flags in ([], ["--chunked-prefill", "4"]):
        res = serve.main(["--device", "cpu", "--reduced", "--requests", "3",
                          "--max-new", "4", "--slots", "2"] + flags)
        out = capsys.readouterr().out
        digests += re.findall(r"^\[digest\] ([0-9a-f]{64})$", out, re.M)
        assert len(res["results"]) == 3
    assert len(digests) == 2 and digests[0] == digests[1]
