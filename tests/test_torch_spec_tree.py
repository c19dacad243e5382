"""Port conformance, token-tree self-speculative decoding: the tree
template, the ancestor mask and the tree mode of paged attention's plain
version, ``tree_verify``, the accepted-path compaction on the pool, one
tree round, and the engine (tree, adaptive, fanout 1 against the chain)
against the JAX reference on the same numpy inputs.

Tolerances:
  * template fields, masks, greedy ``tree_verify`` and ``compact_accepted``
    exact (integer logic and row moves);
  * tree attention: 1e-5 abs and rel in f32 (the same math; sums differ
    only in order), against the reference's oracle and its Pallas kernel
    in interpret mode; length-0 rows give zeros here and NaN in the
    reference's oracle, so they are compared apart;
  * sampled tree verify: the first token's frequencies over 4000 rounds
    within 0.05 of the target (the reference test's bar);
  * one tree round from the same prefilled pool: emitted tokens equal, the
    pool's committed rows to 1e-5 abs (f32);
  * engine: greedy tokens equal to the port's non-speculative engine.

The property test of ``tree_verify`` draws only trees ``TreeTemplate``
accepts (at most 31 fed tokens)."""
import itertools

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
from repro.core.model_compress import compress_draft as jcompress_draft  # noqa: E402
from repro.core.model_compress import compress_params as jcompress  # noqa: E402
from repro.engine.sampling import SamplingParams as JSamplingParams  # noqa: E402
from repro.engine.sampling import tree_verify as jtree_verify  # noqa: E402
from repro.engine.spec import TreeTemplate as JTreeTemplate  # noqa: E402
from repro.engine.spec import compact_accepted as jcompact  # noqa: E402
from repro.engine.spec import tree_step_fns as jtree_step_fns  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.layers import ancestor_mask as jancestor_mask  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.model_compress import draft_layers  # noqa: E402
from repro_torch.engine import (EngineConfig, InferenceEngine,  # noqa: E402
                                SamplingParams)
from repro_torch.engine.sampling import spec_verify, tree_verify  # noqa: E402
from repro_torch.engine.scheduler import DECODE  # noqa: E402
from repro_torch.engine.spec import (TreeTemplate, compact_accepted,  # noqa: E402
                                     spec_step_fns, tree_step_fns)
from repro_torch.engine.spec.tree import top_children  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.layers import ancestor_mask  # noqa: E402

from _torch_utils import (PAGE, engine_prompts, jax_tree_to_numpy,  # noqa: E402
                          prefill_both, serve_all, slice_inputs)

GREEDY = SamplingParams()
TOL = dict(rtol=1e-5, atol=1e-5)
FANOUTS = [(2, 2), (4, 2, 2), (2, 2, 2, 2), (1, 1, 1), (3,), (3, 2, 1)]


@pytest.fixture(scope="module")
def models():
    """The reduced llama2-7b: the reference's FP init and GQSA target
    packing, a w4s75 draft of the same weights, all bridged."""
    jcfg = jget_config("llama2_7b", reduced=True)
    jfp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    jtarget = jcompress(jfp, jcfg, JGQSAConfig())
    jd = jcompress_draft(jfp, jcfg, profile="w4s75")
    bridge = lambda t: params_from_numpy(jax_tree_to_numpy(t), "cpu")  # noqa: E731
    return dict(jcfg=jcfg, jtarget=jtarget, jdraft=jd,
                cfg=get_config("llama2_7b", reduced=True),
                target=bridge(jtarget), draft=bridge(jd))


# ---------------------------------------------------------------------------
# template, mask, tree attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fanout", FANOUTS)
def test_tree_template_fields_match_reference(fanout):
    tpl, jtpl = TreeTemplate(fanout), JTreeTemplate(fanout)
    for name in ("fanout", "depth", "level_sizes", "n_nodes",
                 "level_starts"):
        assert getattr(tpl, name) == getattr(jtpl, name), name
    for name in ("depths", "parents", "child_start", "anc"):
        np.testing.assert_array_equal(getattr(tpl, name),
                                      getattr(jtpl, name))
    for lvl in range(1, tpl.depth):
        got, want = tpl.level_tree(lvl, "cpu"), jtpl.level_tree(lvl)
        assert (got["window"], got["start"]) == (want["window"],
                                                 want["start"])
        np.testing.assert_array_equal(got["anc"].numpy(), want["anc"])
        np.testing.assert_array_equal(got["depths"].numpy(), want["depths"])


def test_tree_template_rejects_what_the_reference_rejects():
    for bad in ((8, 4), (3, 3, 3), (), (2, 0)):
        with pytest.raises(ValueError):
            JTreeTemplate(bad)
        with pytest.raises(ValueError):
            TreeTemplate(bad)


def test_ancestor_mask_matches_reference():
    g = np.random.default_rng(0)
    b, t, s, window = 3, 7, 40, 9
    length = g.integers(0, s, size=(b, t)).astype(np.int32)
    anc = g.integers(0, 2 ** 31 - 1, size=(b, t)).astype(np.int32)
    base = np.array([0, 5, 33], np.int32)
    want = np.asarray(jancestor_mask(jnp.asarray(length), jnp.asarray(anc),
                                     jnp.asarray(base), window, b, t, s))
    got = ancestor_mask(torch.from_numpy(length), torch.from_numpy(anc),
                        torch.from_numpy(base), window, b, t, s)
    np.testing.assert_array_equal(got.numpy(), want)
    # no bitmap: the staircase
    np.testing.assert_array_equal(
        ancestor_mask(torch.from_numpy(length), None, None, 0, b, t,
                      s).numpy(),
        np.asarray(jancestor_mask(jnp.asarray(length), None, None, 0, b, t,
                                  s)))


def _tree_case(seed, fanout, start, dtype):
    """A tree block (or one draft level of it, ``start`` > 0) of 3 slots
    over a shuffled pool: slot 1 is inactive (length 0, sentinel table)."""
    g = np.random.default_rng(seed)
    tpl = TreeTemplate(fanout)
    b, kh, r, d, ps, mp = 3, 2, 2, 16, 4, 6
    num_pages = b * mp + 2
    if start:
        lvl = tpl.level_starts.index(start)
        spec = tpl.level_tree(lvl, "cpu")
    else:
        spec = tpl.verify_tree("cpu")
    t = spec["anc"].shape[0]
    q = g.normal(size=(b, t, kh * r, d)).astype(np.float32)
    if dtype == "int8":
        kp, vp = (g.integers(-127, 128, (num_pages, ps, kh, d))
                  .astype(np.int8) for _ in range(2))
        ks, vs = (g.uniform(0.001, 0.02, (num_pages, ps, kh))
                  .astype(np.float32) for _ in range(2))
    else:
        kp, vp = (g.normal(size=(num_pages, ps, kh, d)).astype(np.float32)
                  for _ in range(2))
        ks = vs = None
    bt = g.permutation(num_pages)[:b * mp].reshape(b, mp).astype(np.int32)
    bt[1] = num_pages
    base = np.array([3, 0, 9], np.int32)              # window roots
    length = np.broadcast_to((base + spec["window"])[:, None],
                             (b, t)).copy()
    length[1] = 0
    anc = np.broadcast_to(spec["anc"].numpy()[None], (b, t)).copy()
    return q, kp, vp, ks, vs, length, bt, anc, base, spec["window"]


@pytest.mark.parametrize("fanout,start", [((4, 2, 2), 0), ((4, 2, 2), 5),
                                          ((2, 2, 2, 2), 0), ((1, 1, 1), 0),
                                          ((2, 2), 1)])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_tree_paged_attention_plain_matches_reference(fanout, start, dtype):
    """The tree mode's plain version against the reference's oracle, at a
    verify block and at draft levels (window < T rows' span: ``start`` >
    0), on f32 and int8 pages."""
    q, kp, vp, ks, vs, length, bt, anc, base, window = _tree_case(
        len(fanout) + start, fanout, start, dtype)
    sc = () if ks is None else (ks, vs)
    want = np.asarray(jref.tree_attention_ref(
        *map(jnp.asarray, (q, kp, vp, length, bt, anc, base)), window,
        *map(jnp.asarray, sc)))
    t = torch.from_numpy
    got = ops.paged_decode_attention(
        t(q), t(kp), t(vp), t(length), t(bt), *map(t, sc), anc=t(anc),
        anc_base=t(base), anc_window=window).numpy()
    live = [0, 2]
    np.testing.assert_allclose(got[live], want[live], **TOL)
    assert (got[1] == 0).all()
    alias = tref.tree_attention_ref(t(q), t(kp), t(vp), t(length), t(bt),
                                    t(anc), t(base), window, *map(t, sc))
    np.testing.assert_array_equal(alias.numpy(), got)


def test_tree_paged_attention_plain_matches_reference_kernel():
    """Against the reference's Pallas kernel itself (interpret mode), on
    bf16 pages at the (4, 2, 2) verify block."""
    q, kp, vp, _, _, length, bt, anc, base, window = _tree_case(
        7, (4, 2, 2), 0, "float32")
    jk = jnp.asarray(kp).astype(jnp.bfloat16)
    jv = jnp.asarray(vp).astype(jnp.bfloat16)
    want = np.asarray(jops.paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(length), jnp.asarray(bt),
        anc=jnp.asarray(anc), anc_base=jnp.asarray(base), anc_window=window,
        use_pallas=True, interpret=True))
    t = torch.from_numpy
    got = ops.paged_decode_attention(
        t(q), t(kp).bfloat16(), t(vp).bfloat16(), t(length), t(bt),
        anc=t(anc), anc_base=t(base), anc_window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# tree_verify
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("logits,f", [([1, 1, 1, 0], 2), ([1] * 8, 2),
                                      ([0, 2, 2, 1, 2], 3), ([3, 1, 3], 1)])
def test_tree_draft_children_break_ties_as_the_reference(logits, f):
    """The drafter's top-f children against the reference's
    ``jax.lax.top_k`` on tied logits: ties go to the lower token id
    ([1, 1, 1, 0] at f = 2 gives [0, 1])."""
    x = np.tile(np.asarray(logits, np.float32), (2, 3, 1))   # [B, n, V]
    _, jtop = jax.lax.top_k(jnp.asarray(x), f)
    top = top_children(torch.from_numpy(x), f)
    np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))
    if logits == [1, 1, 1, 0]:
        assert top[0, 0].tolist() == [0, 1]


def _walk(logits, feed, fanout, child_start):
    """Sequential greedy tree walk of one row: (n_acc, emitted tokens)."""
    tgt = logits.argmax(-1)
    cur, toks = 0, []
    for f in fanout:
        toks.append(int(tgt[cur]))
        nxt = next((child_start[cur] + j for j in range(f)
                    if feed[child_start[cur] + j] == toks[-1]), None)
        if nxt is None:
            return len(toks) - 1, toks
        cur = nxt
    toks.append(int(tgt[cur]))
    return len(fanout), toks


def _tree_logits(seed, tpl, v, b=3):
    """Random logits and feed; row 0 has the argmax path planted."""
    g = np.random.default_rng(seed)
    logits = g.normal(size=(b, tpl.n_nodes + 1, v)).astype(np.float32)
    feed = g.integers(0, v, size=(b, tpl.n_nodes + 1)).astype(np.int32)
    tgt0, cur = logits[0].argmax(-1), 0
    for f in tpl.fanout:
        cb = tpl.child_start[cur]
        j = g.integers(0, f)
        feed[0, cb + j] = tgt0[cur]
        cur = cb + j
    return logits, feed


@pytest.mark.parametrize("fanout", FANOUTS)
def test_tree_verify_greedy_matches_reference(fanout):
    tpl = TreeTemplate(fanout)
    logits, feed = _tree_logits(len(fanout), tpl, 11)
    jn, jout, jpath = map(np.asarray, jtree_verify(
        jnp.asarray(logits), jnp.asarray(feed), fanout, tpl.child_start,
        jax.random.PRNGKey(0), JSamplingParams()))
    tn, tout, tpath = tree_verify(torch.from_numpy(logits),
                                  torch.from_numpy(feed), fanout,
                                  tpl.child_start, None, GREEDY)
    np.testing.assert_array_equal(tn.numpy(), jn)
    assert jn[0] == tpl.depth
    for i in range(len(jn)):
        np.testing.assert_array_equal(tout[i, :jn[i] + 1].numpy(),
                                      jout[i, :jn[i] + 1])
        np.testing.assert_array_equal(tpath[i, :jn[i]].numpy(),
                                      jpath[i, :jn[i]])


# every tree TreeTemplate accepts with depth <= 3 and fanout <= 3 per level
_ACCEPTED = [f for d in (1, 2, 3)
             for f in itertools.product((1, 2, 3), repeat=d)
             if sum(np.cumprod(f)) + 1 <= 31]


@pytest.mark.parametrize("seed", range(8))
def test_tree_verify_greedy_property(seed):
    """For random accepted trees, logits and feeds, the greedy verify
    emits exactly the sequential walk, and each path slot holds the
    emitted token at the right depth."""
    g = np.random.default_rng(100 + seed)
    for _ in range(5):
        fanout = _ACCEPTED[g.integers(len(_ACCEPTED))]
        tpl = TreeTemplate(fanout)
        logits, feed = _tree_logits(int(g.integers(1 << 30)), tpl,
                                    int(g.integers(4, 18)))
        n, out, path = tree_verify(torch.from_numpy(logits),
                                   torch.from_numpy(feed), fanout,
                                   tpl.child_start, None, GREEDY)
        for i in range(logits.shape[0]):
            n_ref, toks = _walk(logits[i], feed[i], fanout, tpl.child_start)
            assert int(n[i]) == n_ref
            assert out[i, :n_ref + 1].tolist() == toks
            for d in range(n_ref):
                assert tpl.depths[path[i, d]] == d + 1
                assert feed[i, path[i, d]] == toks[d]


def test_tree_verify_chain_matches_spec_verify():
    """A fanout-1 tree is the chain: same accepted lengths and tokens."""
    g = np.random.default_rng(7)
    k, v = 4, 9
    logits = torch.from_numpy(g.normal(size=(6, k + 1, v))
                              .astype(np.float32))
    tgt = logits.argmax(-1)
    draft = torch.from_numpy(g.integers(0, v, size=(6, k)).astype(np.int32))
    for i in range(6):                       # accept the first i drafts
        draft[i, :min(i, k)] = tgt[i, :min(i, k)]
    tpl = TreeTemplate((1,) * k)
    feed = torch.cat([torch.zeros((6, 1), dtype=torch.int32), draft], 1)
    tn, tout, _ = tree_verify(logits, feed, tpl.fanout, tpl.child_start,
                              None, GREEDY)
    cn, cout = spec_verify(logits, draft, None, GREEDY)
    assert torch.equal(tn, cn)
    for i in range(6):
        assert torch.equal(tout[i, :tn[i] + 1], cout[i, :cn[i] + 1])


def test_tree_verify_first_token_distribution_preserved():
    """Temperature 1 at fanout (2, 2): the first emitted token follows the
    target whatever the two root children are."""
    v, n = 5, 4000
    tpl = TreeTemplate((2, 2))
    logits0 = np.array([2.0, 1.0, 0.5, 0.0, -1.0], np.float32)
    target = np.exp(logits0) / np.exp(logits0).sum()
    logits = torch.from_numpy(np.tile(logits0, (n, tpl.n_nodes + 1, 1)))
    feed = torch.from_numpy(np.tile(np.array([0, 0, 4, 1, 2, 3, 1],
                                             np.int32), (n, 1)))
    _, out, _ = tree_verify(logits, feed, tpl.fanout, tpl.child_start,
                            torch.Generator().manual_seed(2),
                            SamplingParams(temperature=1.0))
    freq = np.bincount(out[:, 0].numpy(), minlength=v) / n
    np.testing.assert_allclose(freq, target, atol=0.05)


def test_tree_verify_rejection_excludes_rejected_siblings():
    logits0 = np.array([10.0, 0.0, -30.0, -30.0], np.float32)
    tpl = TreeTemplate((2,))
    logits = torch.from_numpy(np.tile(logits0, (400, 3, 1)))
    feed = torch.from_numpy(np.tile(np.array([0, 2, 3], np.int32),
                                    (400, 1)))
    n, out, _ = tree_verify(logits, feed, tpl.fanout, tpl.child_start,
                            torch.Generator().manual_seed(3),
                            SamplingParams(temperature=1.0))
    assert (n == 0).all()
    assert not np.isin(out[:, 0].numpy(), (2, 3)).any()


# ---------------------------------------------------------------------------
# compact_accepted
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "latent"])
def test_compact_accepted_matches_reference(kv):
    """Random pools (an int8 pool with its scale pages; MLA's one latent
    pool, rows of width R + rope), three slots: a full path, a path cut
    short, an inactive slot (n_new 0, sentinel table). The in-place move
    equals the reference's functional result, bit for bit, in every
    pool."""
    g = np.random.default_rng(4)
    layers, num_pages, ps, kh, d = 2, 14, 4, 2, 4
    tpl = TreeTemplate((2, 2, 2))
    shape = (layers, num_pages, ps, kh, d)
    if kv == "int8":
        pools = {"k_pages": g.integers(-127, 128, shape).astype(np.int8),
                 "v_pages": g.integers(-127, 128, shape).astype(np.int8),
                 "k_scale_pages": g.random(shape[:-1]).astype(np.float32),
                 "v_scale_pages": g.random(shape[:-1]).astype(np.float32)}
    elif kv == "latent":
        pools = {"lat_pages": g.normal(size=(layers, num_pages, ps, 12))
                 .astype(np.float32)}
    else:
        pools = {k: g.normal(size=shape).astype(np.float32)
                 for k in ("k_pages", "v_pages")}
    # every source inside the slot's table, as the engine's lookahead
    # reservation guarantees
    bt = g.permutation(num_pages)[:12].reshape(3, 4).astype(np.int32)
    bt[2] = num_pages
    positions = np.array([1, 5, 0], np.int32)
    path = np.array([[2, 5, 12], [1, 3, 7], [1, 3, 7]], np.int32)
    n_new = np.array([4, 2, 0], np.int32)
    jpools = {k: jnp.asarray(v) for k, v in pools.items()}
    tpools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    if kv == "bfloat16":
        jpools = {k: v.astype(jnp.bfloat16) for k, v in jpools.items()}
        tpools = {k: v.bfloat16() for k, v in tpools.items()}
    want = jcompact(jpools, jnp.asarray(bt), jnp.asarray(positions),
                    jnp.asarray(path), jnp.asarray(n_new), ps)
    ptrs = {k: v.data_ptr() for k, v in tpools.items()}
    compact_accepted(tpools, torch.from_numpy(bt),
                     torch.from_numpy(positions), torch.from_numpy(path),
                     torch.from_numpy(n_new), ps)
    assert tpl.n_nodes == 14
    for k in pools:
        assert tpools[k].data_ptr() == ptrs[k]
        np.testing.assert_array_equal(tpools[k].float().numpy(),
                                      np.asarray(want[k], np.float32))
    # slot 0's path slots really moved: pos 1 + path -> 2, 3, 4
    name = next(iter(pools))
    src = torch.from_numpy(pools[name]).to(tpools[name].dtype)
    for i, s in enumerate((2, 5, 12)):
        sp, dp = 1 + s, 2 + i
        assert torch.equal(tpools[name][:, bt[0, dp // ps], dp % ps],
                           src[:, bt[0, sp // ps], sp % ps])


def test_compact_accepted_reads_nothing_on_the_host():
    from torch.profiler import ProfilerActivity, profile
    pools = {k: torch.randn((2, 6, 4, 1, 2)) for k in ("k_pages", "v_pages")}
    bt = torch.tensor([[0, 1, 2], [6, 6, 6]], dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        compact_accepted(pools, bt, torch.tensor([1, 0], dtype=torch.int32),
                         torch.tensor([[2, 5], [1, 3]], dtype=torch.int32),
                         torch.tensor([3, 0], dtype=torch.int32), 4)
    reads = [e.key for e in prof.key_averages()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads


# ---------------------------------------------------------------------------
# one round on the pool
# ---------------------------------------------------------------------------

def _round_inputs(models):
    jcfg, cfg = models["jcfg"], models["cfg"]
    tokens, lengths, bt, _ = slice_inputs(jcfg.vocab, 1)
    jl, jcache, tl, tcache = prefill_both(jcfg, models["jtarget"], cfg,
                                          models["target"], tokens, lengths,
                                          bt)
    first = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    active = (lengths > 0).astype(np.int32)
    return jcache, tcache, first, lengths, bt, active, active * 8


@pytest.mark.parametrize("fanout", [(4, 2, 2), (2, 1, 2)])
def test_tree_round_matches_reference_on_the_pool(models, fanout):
    """From the same prefilled pool, one tree draft + verify round in
    both packages: the same tree tokens, emitted tokens and positions,
    and the same committed rows in every layer after the compaction."""
    jcfg, cfg = models["jcfg"], models["cfg"]
    dl = draft_layers(cfg, "w4s75")
    jcache, tcache, first, lengths, bt, active, rem = _round_inputs(models)
    mp = bt.shape[1]
    jdraft_fn, jverify_fn, _ = jtree_step_fns(jcfg, JSamplingParams(), False,
                                              fanout, dl)
    jdraft = jdraft_fn(models["jdraft"], jcache, jnp.asarray(first),
                       jnp.asarray(lengths), jnp.asarray(bt), mp)
    jout, jn, _, jpos, _, jcache, _ = jverify_fn(
        models["jtarget"], jcache, jnp.asarray(first), jdraft,
        jnp.asarray(lengths), jnp.asarray(bt), jnp.asarray(active),
        jnp.asarray(rem), jax.random.PRNGKey(0), mp)
    draft_fn, verify_fn, _ = tree_step_fns(cfg, GREEDY, fanout, dl)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    tdraft = draft_fn(models["draft"], tcache, t(first), t(lengths), t(bt),
                      mp)
    np.testing.assert_array_equal(tdraft.numpy(), np.asarray(jdraft))
    tout, tn, _, tpos, _ = verify_fn(models["target"], tcache, t(first),
                                     tdraft, t(lengths), t(bt), t(active),
                                     t(rem), None, mp)
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


@pytest.mark.parametrize("tree", [False, True])
def test_spec_round_reads_nothing_on_the_host(models, tree):
    """A whole draft + verify round (with the tree's compaction) only
    enqueues: no ``.item()``, no 0-dim index, nothing read on the host."""
    from torch.profiler import ProfilerActivity, profile
    cfg = models["cfg"]
    _, tcache, first, lengths, bt, active, rem = _round_inputs(models)
    if tree:
        draft_fn, verify_fn, _ = tree_step_fns(cfg, GREEDY, (2, 2), 2)
    else:
        draft_fn, verify_fn = spec_step_fns(cfg, GREEDY, 3, 2)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        d = draft_fn(models["draft"], tcache, t(first), t(lengths), t(bt), 4)
        verify_fn(models["target"], tcache, t(first), d, t(lengths), t(bt),
                  t(active), t(rem), None, 4)
    reads = [e.key for e in prof.key_averages()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _engine(models, profile="w4s75", **spec):
    cfg = models["cfg"]
    draft = models["draft"] if spec else None
    return InferenceEngine(cfg, models["target"], EngineConfig(
        num_slots=2, max_seq=24, page_size=4, device="cpu",
        spec_draft_layers=draft_layers(cfg, profile) if spec else None,
        **spec), GREEDY, draft_params=draft)


def _serve(eng, seed, max_new=6, lens=(5, 9, 4)):
    g = np.random.default_rng(seed)
    prompts = [g.integers(0, eng.cfg.vocab, n).astype(np.int32)
               for n in lens]
    rids = [eng.submit(p, max_new) for p in prompts]
    by = {r["rid"]: list(r["tokens"]) for r in eng.run()["results"]}
    return [by[r] for r in rids]


@pytest.mark.parametrize("k", [1, 3])
def test_fanout1_tree_bit_identical_to_chain(models, k):
    """A fanout-1 tree IS the chain: tokens, the whole pool and the
    positions end bit-identical."""
    chain, tree = _engine(models, spec_k=k), _engine(models,
                                                     spec_fanout=(1,) * k)
    assert _serve(chain, k) == _serve(tree, k)
    for name in chain.kv.data:
        assert torch.equal(chain.kv.data[name], tree.kv.data[name]), name
    assert torch.equal(chain._positions, tree._positions)


@pytest.mark.parametrize("fanout,adaptive", [((2, 2), False),
                                             ((3, 2, 1), False),
                                             ((4, 2, 2), False),
                                             ((2, 2), True)])
def test_tree_spec_greedy_lossless(models, fanout, adaptive):
    """Greedy tree speculation (and its adaptive ladder) serves the
    non-speculative engine's tokens, and leaks no page."""
    want = _serve(_engine(models), 3)
    eng = _engine(models, spec_fanout=fanout, spec_adaptive=adaptive)
    assert _serve(eng, 3) == want
    m = eng.metrics.summary()
    assert m["spec_rounds"] > 0 and m["verify_tokens"] > 0
    assert np.isfinite(m["accepted_len_mean"])
    assert eng.kv.allocator.num_free == eng.kv.num_pages


@pytest.mark.parametrize("fanout", [(2,), (2, 2), (1, 2), (3, 1)])
def test_tree_allocator_leak_free(models, fanout):
    """Requests stream through a pool that fits about one of them: tree
    rounds interleaved with admission and eviction give every page
    back."""
    lookahead = TreeTemplate(fanout).n_nodes
    cfg = models["cfg"]
    eng = InferenceEngine(cfg, models["target"], EngineConfig(
        num_slots=2, max_seq=16, page_size=4, device="cpu",
        num_pages=-(-(16 + lookahead) // 4) + 1, spec_fanout=fanout,
        spec_draft_layers=draft_layers(cfg, "w4s75")), GREEDY,
        draft_params=models["draft"])
    initial = eng.kv.allocator.num_free
    out = _serve(eng, len(fanout), max_new=4, lens=(3, 7, 5, 4))
    assert all(len(t) == 4 for t in out)
    assert eng.kv.allocator.num_free == initial


def test_tree_spec_sampled_runs(models):
    cfg = models["cfg"]
    eng = InferenceEngine(cfg, models["target"], EngineConfig(
        num_slots=2, max_seq=24, page_size=4, device="cpu",
        spec_fanout=(2, 2)), SamplingParams(temperature=0.8, top_k=16),
        draft_params=models["draft"])
    res = serve_all(eng, engine_prompts(cfg.vocab)[:3], 5)
    assert all(t.shape == (5,) and (t >= 0).all() and (t < cfg.vocab).all()
               for t in res.values())
    m = eng.metrics.summary()
    assert m["draft_accepted"] <= m["draft_proposed"]
    assert eng.kv.allocator.num_free == eng.kv.num_pages


def test_adaptive_ladder_controller(models):
    """The active slots' EWMA floor picks the rung: thrash -> chain K=1,
    middling -> a depth-equal chain, high -> the full tree; every flip
    counts."""
    eng = _engine(models, spec_fanout=(2, 2), spec_adaptive=True)
    assert eng._fanout_ladder == [(1,), (1, 1), (2, 2)]
    eng.submit(np.arange(4, dtype=np.int32), 2)
    for r in eng.scheduler.admit():
        r.state = DECODE
    eng._accept_ewma[:] = 0.1
    assert eng._segment_fanout() == (1,)
    eng._accept_ewma[:] = 0.5
    assert eng._segment_fanout() == (1, 1)
    eng._accept_ewma[:] = 0.9
    assert eng._segment_fanout() == (2, 2)
    assert eng.tel.registry.counter("spec.ladder_transitions").value == 2
    eng._update_accept_ewma(np.array([1, 0]), 2)     # a rejected round
    assert eng._accept_ewma[0] == pytest.approx(0.7 * 0.9)
    assert eng._accept_ewma[1] == 0.9
