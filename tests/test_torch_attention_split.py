"""Port conformance, the split page walk of paged attention: the plain
version of the CUDA kernel in every mode
(``kernels/ref.py:paged_attention_split_ref``: per-split partials over the
strided page assignment, merged in split order) against the port's
``paged_attention_ref`` / ``paged_latent_attention_ref`` and the JAX
reference's ``ops.paged_decode_attention`` (with scale pages in the int8
mode) / ``ops.paged_latent_attention`` (their jnp oracles) on the same
numpy inputs, and the host-side split plan.

Inputs are drawn from seeded numpy generators; each case is small (4 slots,
2 KV heads, D = 16, pages of 4, 6 table columns; the latent pool: one head
of D = 24 with 16 value dims, 4 query heads). Tolerance 1e-5 (abs and rel)
in f32: the sides differ only in summation order over at most 24 positions
of O(1) values, and in the int8 mode in where the f32 scale multiplies
(folded into the score and the probability here, into each code in the
oracles). Rows with no visible position (length 0, or a tree row whose
ancestor bits hide its whole window) are exact zeros in the port and NaN
in the reference's oracle, so they are compared apart."""
import numpy as np
import pytest
import torch

# the suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps these small products from crowding the other files
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402

from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels.paged_attention import (split_count,  # noqa: E402
                                                 workspace_floats)

TOL = dict(rtol=1e-5, atol=1e-5)
B, KH, D, PS, MP = 4, 2, 16, 4, 6
LH, LD, LV = 4, 24, 16          # latent pool: query heads, D, value dims


def _case(seed, t, r, n_split, tree, dtype, d=D, kh=KH):
    """A shuffled pool with a sentinel tail column in every row. Slot 0:
    ragged lengths; slot 1: an all-sentinel row of length 0 (no split has a
    page); slot 2: a length on a page boundary (2 pages); slot 3: a length
    on the split boundary (n_split pages, or the table's width) with a
    length-0 row (plain mode) beside longer ones. Tree mode: random
    ancestor bitmaps over a window of T at each slot's ragged base."""
    g = np.random.default_rng(seed)
    num_pages = B * MP + 2
    q = g.normal(size=(B, t, kh * r, d)).astype(np.float32)
    kp = g.normal(size=(num_pages, PS, kh, d)).astype(np.float32)
    vp = g.normal(size=(num_pages, PS, kh, d)).astype(np.float32)
    bt = g.permutation(num_pages)[:B * MP].reshape(B, MP).astype(np.int32)
    bt[:, MP - 1] = num_pages                  # sentinel tail
    bt[1] = num_pages + 3                      # all-sentinel slot
    cap = (MP - 1) * PS
    ends = np.array([g.integers(t + 1, cap + 1), 0, 2 * PS,
                     min(n_split * PS, cap)], np.int32)
    if tree:
        window = t
        base = np.maximum(ends - window, 0).astype(np.int32)
        lens = np.repeat((base + window)[:, None], t, axis=1)
        lens[1] = 0
        anc = g.integers(0, 2 ** 31 - 1, size=(B, t)).astype(np.int32)
        tree_args = (anc, base, window)
    else:
        lens = ends[:, None] - (t - 1) + np.arange(t)[None, :]
        lens = np.clip(lens, 0, None).astype(np.int32)
        lens[1] = 0
        lens[3, 0] = 0                         # a length-0 row
        tree_args = None
    if dtype == "int8":                        # codes, then f32 scales
        kp, vp = (np.clip(np.rint(x * 40), -127, 127).astype(np.int8)
                  for x in (kp, vp))
        return (q, kp, vp, lens.astype(np.int32), bt, tree_args,
                g.uniform(1e-3, 2e-2, size=kp.shape[:3]).astype(np.float32),
                g.uniform(1e-3, 2e-2, size=kp.shape[:3]).astype(np.float32))
    if dtype == "bfloat16":                    # pages rounded to bf16
        kp = np.asarray(jnp.asarray(kp).astype(jnp.bfloat16)
                        .astype(jnp.float32))
        vp = np.asarray(jnp.asarray(vp).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    return q, kp, vp, lens.astype(np.int32), bt, tree_args


def _torch_pages(kp, vp, dtype):
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return (torch.tensor(kp).to(tdt), torch.tensor(vp).to(tdt))


@pytest.fixture(scope="module")
def jax_compiled():
    """The reference oracle's first plain and tree calls trace and compile
    its ops (about 2 s); later calls at the same shapes reuse them."""
    for tree in (False, True):
        t, r = (5, 1) if tree else (3, 2)
        q, kp, vp, lens, bt, tree_args = _case(0, t, r, 1, tree, "float32")
        jkw = {}
        if tree:
            anc, base, window = tree_args
            jkw = dict(anc=jnp.asarray(anc), anc_base=jnp.asarray(base),
                       anc_window=window)
        for jdt in (jnp.float32, jnp.bfloat16):
            jops.paged_decode_attention(
                jnp.asarray(q), jnp.asarray(kp).astype(jdt),
                jnp.asarray(vp).astype(jdt), jnp.asarray(lens),
                jnp.asarray(bt), use_pallas=False, **jkw)
        q, kp, vp, lens, bt, _, ks, vs = _case(0, t, r, 1, tree, "int8")
        jops.paged_decode_attention(
            *map(jnp.asarray, (q, kp, vp, lens, bt, ks, vs)),
            use_pallas=False, **jkw)
        q, kp, _, lens, bt, _ = _case(0, t, LH, 1, tree, "float32", d=LD,
                                      kh=1)
        jops.paged_latent_attention(
            *map(jnp.asarray, (q, kp[:, :, 0], lens, bt)), v_rank=LV,
            use_pallas=False, **jkw)


@pytest.mark.parametrize("n_split", [1, 2, 3, MP])
@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ref_matches_references(jax_compiled, n_split, tree, dtype):
    t, r = (5, 1) if tree else (3, 2)
    q, kp, vp, lens, bt, tree_args = _case(10 * n_split + tree, t, r,
                                           n_split, tree, dtype)
    tk, tv = _torch_pages(kp, vp, dtype)
    kw, jkw = {}, {}
    if tree:
        anc, base, window = tree_args
        kw = dict(anc=torch.from_numpy(anc), anc_base=torch.from_numpy(base),
                  anc_window=window)
        jkw = dict(anc=jnp.asarray(anc), anc_base=jnp.asarray(base),
                   anc_window=window)
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(lens),
            torch.from_numpy(bt))
    o = kref.paged_attention_split_ref(*args, n_split, **kw).numpy()
    o_plain = kref.paged_attention_ref(*args, **kw).numpy()
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    o_jax = np.asarray(jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp).astype(jdt),
        jnp.asarray(vp).astype(jdt), jnp.asarray(lens), jnp.asarray(bt),
        use_pallas=False, **jkw))
    assert o.shape == (B, t, KH * r, D)
    np.testing.assert_allclose(o, o_plain, **TOL)
    # rows with no visible position (length 0, or a tree row whose bits
    # hide its whole window): zeros here, NaN in the reference's oracle
    empty = np.isnan(o_jax).all(axis=-1)               # [B, T, H]
    assert empty[1].all() and empty[lens == 0].all()
    assert np.all(o[empty] == 0.0) and (~empty).sum() > B * t
    np.testing.assert_allclose(o[~empty], o_jax[~empty], **TOL)


def _tree_kwargs(tree_args):
    """(port, reference) keyword arguments of the tree mode."""
    if tree_args is None:
        return {}, {}
    anc, base, window = tree_args
    return (dict(anc=torch.from_numpy(anc), anc_base=torch.from_numpy(base),
                 anc_window=window),
            dict(anc=jnp.asarray(anc), anc_base=jnp.asarray(base),
                 anc_window=window))


def _hold(o, o_plain, o_jax, lens, t, h, dv):
    """o against the port's plain version everywhere and the reference's
    oracle where a row sees a position (zeros here, NaN there)."""
    assert o.shape == (B, t, h, dv)
    np.testing.assert_allclose(o, o_plain, **TOL)
    empty = np.isnan(o_jax).all(axis=-1)               # [B, T, H]
    assert empty[1].all() and empty[lens == 0].all()
    assert np.all(o[empty] == 0.0) and (~empty).sum() > B * t
    np.testing.assert_allclose(o[~empty], o_jax[~empty], **TOL)


@pytest.mark.parametrize("n_split", [1, 2, 3, MP])
@pytest.mark.parametrize("tree", [False, True])
def test_split_ref_int8_matches_references(jax_compiled, n_split, tree):
    """int8 pages with f32 scale pages: the kernel's folded scales (score
    times k_scale / sqrt(D), probability times v_scale against the codes)
    against the oracles' dequantized codes."""
    t, r = (5, 1) if tree else (3, 2)
    q, kp, vp, lens, bt, tree_args, ks, vs = _case(20 * n_split + tree, t,
                                                   r, n_split, tree, "int8")
    kw, jkw = _tree_kwargs(tree_args)
    args = tuple(map(torch.from_numpy, (q, kp, vp, lens, bt)))
    scales = tuple(map(torch.from_numpy, (ks, vs)))
    o = kref.paged_attention_split_ref(*args, n_split, *scales, **kw).numpy()
    o_plain = kref.paged_attention_ref(*args, *scales, **kw).numpy()
    o_jax = np.asarray(jops.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, lens, bt, ks, vs)), use_pallas=False,
        **jkw))
    _hold(o, o_plain, o_jax, lens, t, KH * r, D)


@pytest.mark.parametrize("n_split", [1, 2, 3, MP])
@pytest.mark.parametrize("tree", [False, True])
def test_split_ref_latent_matches_references(jax_compiled, n_split, tree):
    """The latent pool (v_pages None): one head of D = 24 whose value is
    its leading 16 dims, 4 query heads on it."""
    t = 5 if tree else 3
    q, kp, _, lens, bt, tree_args = _case(30 * n_split + tree, t, LH,
                                          n_split, tree, "float32", d=LD,
                                          kh=1)
    lat = kp[:, :, 0]                                  # [P, ps, D]
    kw, jkw = _tree_kwargs(tree_args)
    args = tuple(map(torch.from_numpy, (q, lat)))
    rest = tuple(map(torch.from_numpy, (lens, bt)))
    o = kref.paged_attention_split_ref(args[0], args[1], None, *rest,
                                       n_split, v_rank=LV, **kw).numpy()
    o_plain = kref.paged_latent_attention_ref(*args, *rest, LV,
                                              **kw).numpy()
    o_jax = np.asarray(jops.paged_latent_attention(
        *map(jnp.asarray, (q, lat, lens, bt)), v_rank=LV, use_pallas=False,
        **jkw))
    _hold(o, o_plain, o_jax, lens, t, LH, LV)


def test_split_partials_follow_the_strided_page_assignment():
    """Split i holds pages i, i + S, ...: a 2-page request at S = 4 has
    partials in splits 0 and 1 and none in 2 and 3 (m = -inf, l = 0,
    acc = 0); the all-sentinel slot has none anywhere."""
    q, kp, vp, lens, bt, _ = _case(3, 1, 1, 4, False, "float32")
    lens[2] = 2 * PS
    m, l, acc = kref.paged_attention_split_partials(
        *map(torch.from_numpy, (q, kp, vp, lens, bt)), 4)
    assert m.shape == (4, B, 1, KH) and acc.shape == (4, B, 1, KH, D)
    assert torch.isfinite(m[:2, 2]).all() and (l[:2, 2] > 0).all()
    assert torch.isneginf(m[2:, 2]).all()
    assert (l[2:, 2] == 0).all() and (acc[2:, 2] == 0).all()
    assert torch.isneginf(m[:, 1]).all() and (acc[:, 1] == 0).all()


def test_split_ref_pages_visited_and_masked_as_the_kernel():
    """A split's pages past the slot's live count are never visited, and a
    position inside a visited page past the row's length is masked: a
    length of PS + 1 puts one position in page 1, seen only by split 1."""
    q, kp, vp, lens, bt, _ = _case(4, 1, 1, 2, False, "float32")
    lens[0] = PS + 1
    m, l, _ = kref.paged_attention_split_partials(
        *map(torch.from_numpy, (q, kp, vp, lens, bt)), 2)
    e = torch.exp(torch.zeros(()))                     # one visible position
    assert torch.allclose(l[1, 0], e.expand_as(l[1, 0]))
    o = kref.paged_attention_split_ref(*map(torch.from_numpy,
                                            (q, kp, vp, lens, bt)), 2)
    np.testing.assert_allclose(o.numpy(), kref.paged_attention_ref(
        *map(torch.from_numpy, (q, kp, vp, lens, bt))).numpy(), **TOL)


@pytest.mark.parametrize("b,khn,tr,mp,ps,want", [
    (4, 32, 1, 16, 16, 2),       # llama2-7b decode at 4 slots, 256 tokens
    (4, 32, 1, 2, 16, 1),        # the same at serve lengths: one chunk
    (4, 32, 29, 16, 16, 2),      # (4,2,2) tree verify: one row group
    (4, 32, 40, 16, 16, 2),      # two row groups
    (1, 32, 1, 16, 16, 4),       # one slot: a split a chunk of 4 pages
    (1, 8, 1, 64, 16, 16),       # few heads: a power of two, 33 -> 32 -> 16
    (1, 32, 1, 6, 16, 2),
    (1, 32, 1, 16, 8, 2),        # pages of 8: chunks of 8 pages
    (64, 32, 1, 16, 16, 1),      # large batch: no split
    (2, 2, 1, 0, 16, 1),         # an empty table still has one split
])
def test_split_count_comes_from_shapes(b, khn, tr, mp, ps, want):
    assert split_count(b, khn, tr, mp, 132, ps) == want
    assert workspace_floats(b, khn, tr, 128, want) == (
        0 if want == 1 else b * khn * want * tr * 130)


@pytest.mark.parametrize("b,tr,mp,want", [
    (4, 128, 16, 4),     # DeepSeek-V2 decode at 4 slots, 256 tokens
    (4, 128, 3, 1),      # serve lengths at the engine's live table
    (4, 128, 8, 2),      # 128 tokens: two chunks of 4 pages
    (4, 384, 16, 2),     # (2,2) tree verify, T = 3: 24 row groups a slot
    (1, 128, 16, 4),     # one slot: capped by the table's 4 chunks
    (128, 128, 16, 1),   # large batch: no split
])
def test_split_count_comes_from_shapes_latent(b, tr, mp, want):
    """The latent mode (one KV head, T*H rows in groups of WIDE_ROWS = 16,
    the value width 512) and its workspace of 512 value columns."""
    assert split_count(b, 1, tr, mp, 132, 16, 512) == want
    assert workspace_floats(b, 1, tr, 512, want) == (
        0 if want == 1 else b * want * tr * 514)
