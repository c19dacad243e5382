"""Port conformance, the prefix cache's ragged tail prefill:
``decode_step(..., feed_len=)`` on a pool whose prefix pages a batched
prefill wrote, one of them shared by two slots, against the JAX
reference on the same inputs, for the dense (llama2-7b), MoE
(deepseek-moe-16b) and MLA + MoE (DeepSeek-V2) families, packed GQSA W4
S50 G16 by the reference and carried over through the bridge.

Three slots feed T = 8 rows: slot 0 a 5-token tail after 16 cached
positions, slot 1 nothing (all-sentinel table, feed 0), slot 2 a 7-token
tail after 8 positions whose page is slot 0's first page.

Tolerances:
  * logits of the real rows (t < feed_len): f32 1e-4 abs, bf16 2e-2 abs
    (``tests/test_torch_model.py``'s bars); padding rows are discarded
    and only required finite;
  * the pool: every row the tail writes equals the reference's (f32 1e-5
    abs, bf16 3e-2 abs; int8 codes within one step, scales rtol 1e-5,
    ``tests/test_torch_int8_kv.py``), and every other row of every leaf
    (the padding positions, the shared page, other slots' pages) is
    bit-unchanged.

The int8 pool runs on FP weights against the reference's kernel path
(interpret mode): its packed GEMV cannot run inside a layer scan with
``use_pallas=True``, and its jnp path re-quantizes q and p (ROADMAP
C.4)."""
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
from repro.core.gqs_layer import GQSAConfig as JGQSAConfig  # noqa: E402
from repro.core.model_compress import compress_params as jcompress  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.gqs_layer import GQSAConfig  # noqa: E402
from repro_torch.engine.engine import _step_fns  # noqa: E402
from repro_torch.engine.sampling import SamplingParams  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

from _torch_utils import NUM_PAGES, PAGE, jax_tree_to_numpy, prefill_both  # noqa: E402

T = 8
STARTS = np.array([16, 0, 8], np.int32)
FEED = np.array([5, 0, 7], np.int32)
S = NUM_PAGES
# slot 0's prefix on pages 3, 11; slot 2 shares page 3 and writes page 17
PREFILL_BT = np.array([[3, 11, 5, 20], [S] * 4, [S] * 4], np.int32)
TAIL_BT = np.array([[3, 11, 5, 20], [S] * 4, [3, 17, 9, S]], np.int32)
WRITTEN = {(5, o) for o in range(5)} | {(17, o) for o in range(7)}

CASES = [("llama2_7b", "float32", None), ("llama2_7b", "bfloat16", None),
         ("llama2_7b", "float32", "int8"),
         ("deepseek_moe_16b", "float32", None),
         ("deepseek_moe_16b", "float32", "int8"),
         ("deepseek_v2_236b", "float32", None)]


@functools.lru_cache(maxsize=None)
def _weights(arch, packed):
    """(jax params, port params) of the reduced ``arch``: the reference's
    init, GQSA-packed by it when ``packed``, carried over."""
    jcfg = jget_config(arch, reduced=True)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    if packed:
        jp = jcompress(jp, jcfg, JGQSAConfig())
    return jp, params_from_numpy(jax_tree_to_numpy(jp), "cpu")


def _cfgs(arch, dtype, kv):
    out = []
    for get in (jget_config, get_config):
        cfg = dataclasses.replace(get(arch, reduced=True), dtype=dtype)
        if kv is not None:
            cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
        out.append(cfg)
    return out


def _inputs(vocab):
    g = np.random.default_rng(3)
    prefix = np.zeros((3, 16), np.int32)
    prefix[0] = g.integers(0, vocab, 16)
    tail = g.integers(0, vocab, (3, T)).astype(np.int32)
    return prefix, tail


@pytest.mark.parametrize("arch,dtype,kv", CASES)
def test_ragged_tail_matches_reference(arch, dtype, kv):
    jcfg, tcfg = _cfgs(arch, dtype, kv)
    jp, tp = _weights(arch, kv is None)
    use_pallas = kv == "int8"
    prefix, tail = _inputs(jcfg.vocab)
    lengths = np.array([16, 0, 0], np.int32)
    _, jcache, _, tcache = prefill_both(jcfg, jp, tcfg, tp, prefix, lengths,
                                        PREFILL_BT, use_pallas)
    before = {k: v.clone() for k, v in tcache.items()}
    jl, jcache = jtf.decode_step(
        jp, jcache, jnp.asarray(tail), jnp.asarray(STARTS), jcfg,
        use_pallas=use_pallas, block_tables=jnp.asarray(TAIL_BT),
        max_live_pages=4, feed_len=jnp.asarray(FEED))
    tl, _ = ttf.decode_step(tp, tcache, torch.from_numpy(tail),
                            torch.from_numpy(STARTS), tcfg,
                            torch.from_numpy(TAIL_BT), max_live_pages=4,
                            feed_len=torch.from_numpy(FEED))
    jl, tl = np.asarray(jl, np.float32), tl.float().numpy()
    assert tl.shape == jl.shape and np.isfinite(tl).all()
    real = np.arange(T)[None, :] < FEED[:, None]
    atol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(tl[real], jl[real], rtol=0, atol=atol)
    rows = tuple(np.array(sorted(WRITTEN)).T)
    for name, leaf in tcache.items():
        changed = (leaf != before[name]).reshape(
            leaf.shape[:3] + (-1,)).any(-1)                 # [L, P, ps]
        stray = changed.clone()
        stray[:, rows[0], rows[1]] = False
        assert not stray.any(), f"{name}: a row outside the tail changed"
        got = leaf[:, rows[0], rows[1]].float().numpy()
        want = np.asarray(jcache[name], np.float32)[:, rows[0], rows[1]]
        if leaf.dtype == torch.int8:
            assert np.abs(got - want).max() <= 1, name
        elif name.endswith("scale_pages"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        else:
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-5 if dtype == "float32" else 3e-2)


def test_feed_len_on_the_contiguous_cache_raises():
    """The contiguous cache takes one token a step and no ragged feed, as
    in the reference."""
    cfg = get_config("llama2_7b", reduced=True)
    params = ttf.init_params(0, cfg, "cpu")
    cache = ttf.init_cache(cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="feed_len"):
        ttf.decode_step(params, cache, torch.tensor([[1], [2]]),
                        torch.tensor(3), cfg,
                        feed_len=torch.tensor([1, 1]))


@pytest.mark.parametrize("arch", ["llama2_7b", "deepseek_v2_236b"])
def test_tail_dispatch_never_reads_the_device_on_the_host(arch):
    """The engine's tail step (ragged decode block, first-token gather,
    greedy sample) reads no tensor's value on the host: the profiler
    counts every such read on the CPU as it would on the card."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(arch, reduced=True)
    params = ttf.init_params(0, cfg, "cpu", compress=GQSAConfig())
    cache = ttf.init_paged_cache(cfg, 8, 4, device="cpu")
    tail_fn = _step_fns(cfg, SamplingParams())[2]
    bt = torch.tensor([[0, 1, 2, 3], [8, 8, 8, 8]], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = tail_fn(params, cache, torch.tensor([[5, 6, 7, 0],
                                                     [0] * 4]),
                        torch.tensor([5, 0], dtype=torch.int32),
                        torch.tensor([3, 0], dtype=torch.int32), bt, gen, 4)
    reads = [e.key for e in prof.key_averages()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads
    assert first.shape == (2,)
