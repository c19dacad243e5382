"""Cases of the port's conformance at the full dense configs' head
ratios, at the reduced width (d_model 64): R = 7 (yi-34b, 56 heads over
8 KV heads), 12 (starcoder2-3b, 24 over 2), 5 (qwen3-14b, 40 over 8) and
4 (mistral-nemo-12b, 32 over 8, whose heads x head_dim differ from
d_model), as each reduced config with (n_heads, n_kv_heads, head_dim) =
(14, 2, 16), (12, 1, 16), (10, 2, 16) and (8, 2, 32) in both packages.
Parameters are initialised (and packed) by the reference and carried
over through the bridge. ``tests/test_torch_head_ratios.py`` runs R = 7
and 12, ``tests/test_torch_head_ratios_r4_r5.py`` R = 4 and 5: the
reference's packing compiles anew at each ratio's shapes (~10 s).

Covered, against the reference on the same numpy inputs: the paged plain
path (GQSA, prefill + teacher-forced decode), the int8 pool (FP weights,
against the reference's Pallas kernel in interpret mode: its packed GEMV
cannot run inside its layer scan under ``use_pallas``), one tree draft +
verify round on the pool, the contiguous int8 decode against the
reference's kernel path, and ``kv_decode_attention_ref`` at R in {12,
16} against the reference's ``ops.kv_decode_attention``.

Tolerances: logits 1e-4 abs (f32, the reduced configs' dtype; the
contiguous path 1e-4 of max |logit|, ROADMAP.md C.4; on the int8 pool a
slot whose codes differ from the reference's by a one-step rounding flip
1e-2 of max |logit|); tree tokens exact,
committed pool rows 1e-5 abs; attention 1e-4 abs and rel (the reference's
own kernel test)."""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jget_config
from repro.core.gqs_layer import GQSAConfig as JGQSAConfig
from repro.core.model_compress import compress_params as jcompress
from repro.engine.sampling import SamplingParams as JSamplingParams
from repro.engine.spec import tree_step_fns as jtree_step_fns
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models import transformer as jtf

from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_config
from repro_torch.engine import SamplingParams
from repro_torch.engine.spec import tree_step_fns
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttf

from _torch_utils import (PAGE, jax_tree_to_numpy, prefill_both,
                          slice_inputs, slice_run)

# R: (arch, n_heads, n_kv_heads, head_dim) at the reduced width
RATIOS = {7: ("yi_34b", 14, 2, 16), 12: ("starcoder2_3b", 12, 1, 16),
          5: ("qwen3_14b", 10, 2, 16), 4: ("mistral_nemo_12b", 8, 2, 32)}

_CACHE = {}


def _cfgs(r, **kw):
    arch, h, kh, hd = RATIOS[r]
    return tuple(dataclasses.replace(get(arch, reduced=True), n_heads=h,
                                     n_kv_heads=kh, head_dim=hd, **kw)
                 for get in (jget_config, get_config))


def _models(r):
    """{name: (jax params, port params)} at ratio ``r``: the FP init and
    its GQSA W4 S50 G16 packing."""
    if r not in _CACHE:
        jcfg, _ = _cfgs(r)
        jfp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
        trees = {"fp": jfp, "gqsa": jcompress(jfp, jcfg, JGQSAConfig())}
        _CACHE[r] = {k: (jp, params_from_numpy(jax_tree_to_numpy(jp), "cpu"))
                     for k, jp in trees.items()}
    return _CACHE[r]


def check_ratios_are_the_full_configs():
    """Each case has its full config's query rows a KV head and the
    reduced width; mistral-nemo's heads x head_dim differ from d_model at
    full width, and so does its case here."""
    for r, (arch, h, kh, hd) in RATIOS.items():
        full = get_config(arch)
        assert full.n_heads // full.n_kv_heads == h // kh == r
        jcfg, tcfg = _cfgs(r)
        assert tcfg.hd == jcfg.hd == hd and tcfg.d_model == 64
    arch, h, kh, hd = RATIOS[4]
    full = get_config(arch)
    assert full.n_heads * full.hd != full.d_model
    assert h * hd != get_config(arch, reduced=True).d_model


def check_paged_plain_path(r):
    jcfg, tcfg = _cfgs(r)
    jp, tp = _models(r)["gqsa"]
    steps, act = slice_run(jcfg, jp, tcfg, tp, steps=2)
    for j, t in steps:
        assert t.shape == j.shape and np.isfinite(t[act]).all()
        np.testing.assert_allclose(t[act], j[act], rtol=0, atol=1e-4)


def _pool_flips(jcache, tcache, bt):
    """Per slot: the largest difference between the two pools' int8 codes
    over the slot's pages (0: the same pool)."""
    worst = np.zeros(bt.shape[0], np.int64)
    for name in ("k_pages", "v_pages"):
        d = np.abs(tcache[name].numpy().astype(np.int64)
                   - np.asarray(jcache[name]).astype(np.int64))
        for i, row in enumerate(bt):
            pages = row[row < d.shape[1]]
            worst[i] = max(worst[i], int(d[:, pages].max(initial=0)))
    return worst


def check_int8_pool(r):
    """Prefill and 3 teacher-forced decode steps on the int8 pool. Where a
    slot's pool holds the reference's codes, its logits agree to 1e-4;
    the two packages' f32 K/V may straddle a rounding boundary, and then
    a code differs by one step (ROADMAP.md C.4's flip; R = 4 has one in a
    V page after prefill): that slot's logits stay within 1e-2 of max
    |logit| (``chip_smoke.py``'s int8 bar)."""
    jcfg, tcfg = _cfgs(r, kv_cache_dtype="int8")
    jp, tp = _models(r)["fp"]
    tokens, lengths, bt, feed = slice_inputs(jcfg.vocab, 3)
    mp, act = bt.shape[1], lengths > 0
    jl, jcache, tl, tcache = prefill_both(jcfg, jp, tcfg, tp, tokens,
                                          lengths, bt, use_pallas=True)
    pos = lengths.copy()
    for i in range(4):
        if i:
            jl, jcache = jtf.decode_step(
                jp, jcache, jnp.asarray(feed[i - 1][:, None]),
                jnp.asarray(pos), jcfg, use_pallas=True,
                block_tables=jnp.asarray(bt), max_live_pages=mp)
            tl, _ = ttf.decode_step(tp, tcache,
                                    torch.from_numpy(feed[i - 1][:, None]),
                                    torch.from_numpy(pos), tcfg,
                                    torch.from_numpy(bt), max_live_pages=mp)
            pos = pos + act
        j, t = np.asarray(jl, np.float32), tl.float().numpy()
        assert t.shape == j.shape and np.isfinite(t[act]).all()
        flips = _pool_flips(jcache, tcache, bt)
        assert flips.max() <= 1
        same = act & (flips == 0)
        np.testing.assert_allclose(t[same], j[same], rtol=0, atol=1e-4)
        flipped = act & (flips > 0)
        assert np.abs(t[flipped] - j[flipped]).max(initial=0) \
            <= 1e-2 * np.abs(j[act]).max()


def check_tree_round(r):
    """From the same prefilled pool, one (2, 2) tree draft + verify round
    (the tree mode over T*R rows) in both packages, the GQSA model
    drafting for itself on all its layers: the same tree tokens, emitted
    tokens and positions, and the same committed rows in every layer
    after the compaction."""
    jcfg, cfg = _cfgs(r)
    jtarget, target = jdraft_p, draft = _models(r)["gqsa"]
    fanout, dl = (2, 2), cfg.n_layers
    tokens, lengths, bt, _ = slice_inputs(jcfg.vocab, 1)
    jl, jcache, _, tcache = prefill_both(jcfg, jtarget, cfg, target, tokens,
                                         lengths, bt)
    first = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    active = (lengths > 0).astype(np.int32)
    rem, mp = active * 8, bt.shape[1]
    jdraft_fn, jverify_fn, _ = jtree_step_fns(jcfg, JSamplingParams(), False,
                                              fanout, dl)
    jd = jdraft_fn(jdraft_p, jcache, jnp.asarray(first),
                   jnp.asarray(lengths), jnp.asarray(bt), mp)
    jout, jn, _, jpos, _, jcache, _ = jverify_fn(
        jtarget, jcache, jnp.asarray(first), jd, jnp.asarray(lengths),
        jnp.asarray(bt), jnp.asarray(active), jnp.asarray(rem),
        jax.random.PRNGKey(0), mp)
    draft_fn, verify_fn, _ = tree_step_fns(cfg, SamplingParams(), fanout, dl)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    td = draft_fn(draft, tcache, t(first), t(lengths), t(bt), mp)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    tout, tn, _, tpos, _ = verify_fn(target, tcache, t(first), td,
                                     t(lengths), t(bt), t(active), t(rem),
                                     None, mp)
    jn, jpos = np.asarray(jn), np.asarray(jpos)
    np.testing.assert_array_equal(tn.numpy(), jn)
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    for i in np.flatnonzero(active):
        np.testing.assert_array_equal(tout[i, :jn[i]].numpy(),
                                      np.asarray(jout)[i, :jn[i]])
        rows = [(bt[i, p // PAGE], p % PAGE) for p in range(int(jpos[i]))]
        for name in ("k_pages", "v_pages"):
            want = np.stack([np.asarray(jcache[name])[:, pg, off]
                             for pg, off in rows], 1)
            got = np.stack([tcache[name][:, pg, off].numpy()
                            for pg, off in rows], 1)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def check_contiguous_int8_decode(r):
    """4 teacher-forced steps of the contiguous decode on an int8 cache at
    a shared ``pos`` (``ops.kv_decode_attention`` in every layer) against
    the reference's kernel path (FP weights)."""
    jcfg, tcfg = _cfgs(r, kv_cache_dtype="int8")
    jp, tp = _models(r)["fp"]
    b, n = 2, 4
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (b, n)) \
        .astype(np.int32)
    jcache = jtf.init_cache(jcfg, b, n + 2)
    tcache = ttf.init_cache(tcfg, b, n + 2, device="cpu")
    for i in range(n):
        jl, jcache = jtf.decode_step(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                                     jnp.int32(i), jcfg, use_pallas=True)
        tl, _ = ttf.decode_step(tp, tcache,
                                torch.from_numpy(toks[:, i:i + 1]),
                                torch.tensor(i, dtype=torch.int32), tcfg)
        j, got = np.asarray(jl, np.float32), tl.float().numpy()
        assert got.shape == j.shape and np.isfinite(got).all()
        assert np.abs(got - j).max() <= 1e-4 * np.abs(j).max()


def check_kv_decode_attention_ref(kh, r, per_slot):
    """The plain version takes any R: at 12 and 16 query rows a KV head
    (D = 128) against the reference's kernel (interpret mode), with a
    shared and a per-slot length."""
    b, s, d = 2, 96, 128
    g = np.random.default_rng(r)
    q = g.normal(size=(b, kh, r, d)).astype(np.float32)
    k8, ks = jlayers.quantize_kv(jnp.asarray(
        g.normal(size=(b, s, kh, d)).astype(np.float32)))
    v8, vs = jlayers.quantize_kv(jnp.asarray(
        g.normal(size=(b, s, kh, d)).astype(np.float32)))
    case = tuple(np.array(a) for a in (q, k8, ks, v8, vs))
    ln = np.array([s - 17, 5], np.int32) if per_slot else np.int32(s - 17)
    got = tref.kv_decode_attention_ref(*map(torch.from_numpy, case),
                                       torch.as_tensor(ln))
    want = jops.kv_decode_attention(*map(jnp.asarray, case), jnp.asarray(ln),
                                    block_s=32, interpret=True)
    assert got.shape == (b, kh, r, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
