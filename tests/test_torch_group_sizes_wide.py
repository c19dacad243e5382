"""Port conformance at group sizes 64 and 128: the served paths of
``gqsa_gemv`` and its expert axis at the group sizes the CUDA kernels take
above 32, where a kept group is g / 32 work items (its 32-code parts). The
reduced configs are too narrow for these sizes (llama2-7b's d_model 64
and deepseek-moe-16b's d_expert 96 hold no group of 128), so each case
widens its reduced config the same way in both packages
(``dataclasses.replace``): every packed K is a multiple of 128, and some
rows keep an odd number of groups or hold an odd number of them (K / g
odd), as deepseek-moe-16b's expert w_d does at full width (K = 1408 =
11 x 128, 6 kept). Each model is initialised and GQSA-packed (W4 S50 at
g) by the JAX reference and carried over through the bridge; both
packages then run batched prefill and teacher-forced decode steps, and
the serving engine, on the same inputs. The port's CPU path is the
kernels' plain versions; the card's kernels are held against those in
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.

Cases: llama2-7b and deepseek-moe-16b at g = 64 and 128; DeepSeek-V2 at
g = 128 with its MLA ranks widened to 128.

Tolerances, as ``tests/test_torch_group_sizes.py:BARS`` holds the same
three families at g = 8 and 32 (f32, the reduced configs' compute dtype):
logits to 1e-4 abs on llama2-7b, |port - ref| <= 1e-5 x max |ref| on
deepseek-moe-16b and 2e-4 x max |ref| on DeepSeek-V2: the same f32 math,
summed in another order. Engine: greedy tokens identical wherever the
reference's top-2 logit margin exceeds 1e-3 (a flip at a nearer tie is
not a fault). The grouped plain versions (``kernels/ref.py``, the CUDA
kernels' order of arithmetic, per part) are held against the reference's
Pallas kernel in interpret mode and the port's plain version at the
widened shapes to 1e-5 x max |y|, as ``test_torch_gqsa_stream.py`` holds
them at every group size."""
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
from repro.core import bsr as jbsr  # noqa: E402
from repro.core.gqs_layer import GQSAConfig as JGQSAConfig  # noqa: E402
from repro.core.model_compress import compress_params as jcompress  # noqa: E402
from repro.core.pruning import PruneConfig as JPruneConfig  # noqa: E402
from repro.core.pruning import group_mask as jgroup_mask  # noqa: E402
from repro.core.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.saliency import group_saliency as jgroup_saliency  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.engine import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.gqsa_gemv import (GROUP_SIZES,  # noqa: E402
                                           experts_plan, line_values, plan,
                                           row_lanes)

from _torch_utils import (PAGE, assert_greedy_match, engine_prompts,  # noqa: E402
                          jax_tree_to_numpy, reference_margins, serve_all,
                          slice_run)

CASES = [("llama2_7b", 64), ("llama2_7b", 128), ("deepseek_moe_16b", 64),
         ("deepseek_moe_16b", 128), ("deepseek_v2_236b", 128)]
# logits bar a step: (absolute, relative to max |ref|)
BARS = {"llama2_7b": (1e-4, 0.0), "deepseek_moe_16b": (0.0, 1e-5),
        "deepseek_v2_236b": (0.0, 2e-4)}
TOL = 1e-5          # the grouped plain versions, over max |y|


def _widen(cfg):
    """The reduced config of either package widened for g = 128: d_model
    128 (4 heads of 32); llama2-7b's d_ff 384 (wd: 3 groups of 128, 2
    kept; 6 of 64, 3 kept; wq: 1 of 128, 1 kept); the MoE families' expert
    width 384 (w_d as llama's wd); DeepSeek-V2's q and kv ranks 128 and
    v_dim 32 (its wo: K = 4 x 32)."""
    out = dataclasses.replace(cfg, d_model=128, d_ff=384)
    if cfg.moe is not None:
        out = dataclasses.replace(out, moe=dataclasses.replace(
            cfg.moe, d_expert=384))
    if cfg.mla is not None:
        out = dataclasses.replace(out, mla=dataclasses.replace(
            cfg.mla, kv_lora_rank=128, q_lora_rank=128, qk_nope_dim=32,
            qk_rope_dim=16, v_dim=32))
    return out


@functools.lru_cache(maxsize=None)
def _packed(arch, g):
    """(jax config, jax params, numpy bridge form) of the widened reduced
    ``arch`` packed by the reference at group size ``g``."""
    jcfg = _widen(jget_config(arch, reduced=True))
    gqsa = JGQSAConfig(quant=JQuantConfig(bits=4, group_size=g),
                       prune=JPruneConfig(sparsity=0.5, group_size=g),
                       saliency="magnitude")
    jp = jcompress(jtf.init_params(jax.random.PRNGKey(0), jcfg), jcfg, gqsa)
    return jcfg, jp, jax_tree_to_numpy(jp)


def _leaves(tree):
    """Every packed leaf of a bridge-form tree."""
    if isinstance(tree, dict):
        if "group_size" in tree:
            return [tree]
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return []


@pytest.mark.parametrize("arch,g", CASES)
def test_widened_packing_holds_whole_groups(arch, g):
    """Every packed leaf is at group size g with K a multiple of 128, and
    the packing holds the row layouts the kernels must take above g = 32:
    an odd number of kept groups a row and, at g = 128, a K of an odd
    number of groups (a K that is a multiple of 128 holds an even number
    of groups of 64)."""
    _, _, npp = _packed(arch, g)
    leaves = _leaves(npp)
    assert leaves and {leaf["group_size"] for leaf in leaves} == {g}
    assert all(leaf["shape"][1] % 128 == 0 for leaf in leaves)
    assert any(leaf["idx"].shape[-1] % 2 for leaf in leaves)
    if g == 128:
        assert any(leaf["shape"][1] // g % 2 for leaf in leaves)


@pytest.mark.parametrize("arch,g", CASES)
def test_prefill_and_decode_logits_match_reference(arch, g):
    """Paged prefill (3 slots, one inactive) and 6 teacher-forced decode
    steps in both packages on the reference's packing at g."""
    jcfg, jp, npp = _packed(arch, g)
    steps, act = slice_run(jcfg, jp, _widen(get_config(arch, reduced=True)),
                           params_from_numpy(npp, "cpu"), steps=6)
    atol, rel = BARS[arch]
    for j, t in steps:
        assert t.shape == j.shape and np.isfinite(t[act]).all()
        bar = atol + rel * np.abs(j[act]).max()
        np.testing.assert_allclose(t[act], j[act], rtol=0, atol=bar)


@pytest.mark.parametrize("arch,g", CASES)
def test_engine_greedy_tokens_match_reference(arch, g):
    """The serving engines of both packages, 5 requests x 8 greedy tokens
    on 2 slots, on the reference's packing at g."""
    jcfg, jp, npp = _packed(arch, g)
    tcfg = _widen(get_config(arch, reduced=True))
    prompts, max_new = engine_prompts(jcfg.vocab), 8
    ref_tokens = serve_all(JInferenceEngine(jcfg, jp, JEngineConfig(
        num_slots=2, max_seq=32, page_size=PAGE)), prompts, max_new)
    got = serve_all(InferenceEngine(tcfg, params_from_numpy(npp, "cpu"),
                                    EngineConfig(num_slots=2, max_seq=32,
                                                 page_size=PAGE,
                                                 device="cpu")),
                    prompts, max_new)
    assert_greedy_match(ref_tokens, got, prompts,
                        reference_margins(jcfg, jp, prompts, ref_tokens,
                                          max_new),
                        max_new)


# ---------------------------------------------------------------------------
# the grouped plain versions against the reference's interpret-mode kernel
# ---------------------------------------------------------------------------

def _pack_pair(w, g, balanced):
    """One [N, K] matrix packed by the reference at group size ``g`` (row
    balanced, or ragged with -1 padding slots), in both packages."""
    gm = jgroup_mask(jgroup_saliency(jnp.square(jnp.asarray(w)), g),
                     JPruneConfig(sparsity=0.5, group_size=g,
                                  row_balanced=balanced))
    jb = jbsr.pack_dense(jnp.asarray(w), gm, JQuantConfig(bits=4,
                                                          group_size=g))
    return jb, params_from_numpy(jax_tree_to_numpy(jb), "cpu")


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _interpret(x, jb):
    """The reference's Pallas kernel in interpret mode on x (torch)."""
    jx = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
    return np.asarray(jops.gqsa_gemv(jx, jb, use_pallas=True,
                                     interpret=True, block_n=16, block_m=4))


@pytest.mark.parametrize("g", [64, 128])
@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grouped_ref_matches_reference_kernel(dtype, balanced, g):
    """One matrix, N = 40, K = 1408 (deepseek-moe-16b's expert width: 11
    groups of 128, 22 of 64), T = 5: the kernels' order of arithmetic per
    32-code part against the reference's interpret-mode kernel and the
    port's plain version; the ragged packing carries -1 padding slots."""
    w = np.random.default_rng(g + balanced).normal(
        size=(40, 1408)).astype(np.float32)
    jb, tb = _pack_pair(w, g, balanced)
    assert tb.vals.shape[-1] == g // 2
    if not balanced:
        assert (tb.idx < 0).any()
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(5, 1408)).astype(np.float32)).to(dtype)
    y = ref.gqsa_gemv_grouped_ref(x, tb).numpy()
    assert _rel(y, ops.gqsa_gemv(x, tb).numpy()) <= TOL
    assert _rel(y, _interpret(x, jb)) <= TOL


@pytest.mark.parametrize("g", [64, 128])
def test_experts_grouped_ref_matches_reference_kernel(g):
    """The expert axis: 3 experts of [40, 384] at C = 4, ``rows`` below C
    ([0, 4, 2]: an idle expert, a full one, a part-filled one), bf16 x;
    each filled expert's rows against the reference's kernel, every other
    row exact zeros, and the whole against the port's plain version."""
    rng = np.random.default_rng(g)
    pairs = [_pack_pair(rng.normal(size=(40, 384)).astype(np.float32), g,
                        True) for _ in range(3)]
    jbs, tbs = zip(*pairs)
    stacked = dataclasses.replace(tbs[0], **{
        f: torch.stack([getattr(b, f) for b in tbs])
        for f in ("idx", "vals", "scale", "zero")})
    x = torch.from_numpy(rng.normal(size=(3, 4, 384)).astype(
        np.float32)).to(torch.bfloat16)
    rows = torch.tensor([0, 4, 2], dtype=torch.int32)
    y = ref.gqsa_gemv_experts_grouped_ref(x, stacked, rows).numpy()
    assert _rel(y, ops.gqsa_gemv_experts(x, stacked, rows).numpy()) <= TOL
    for e, r in enumerate(rows.tolist()):
        assert (y[e, r:] == 0).all()
        if r:
            assert _rel(y[e, :r], _interpret(x[e, :r], jbs[e])) <= TOL


def test_grouped_ref_parts_of_a_group_are_its_32_column_lines():
    """At g = 128 one kept group of codes q, scale s and zero z at column
    group c adds, per 32-column part p, s * sum(q_p x_p) - s z sum(x_p):
    the grouped version equals that sum of parts exactly, and the whole
    group's value, each within f32 rounding (1e-6 and 1e-5 of max |y|)."""
    w = np.random.default_rng(3).normal(size=(2, 512)).astype(np.float32)
    _, tb = _pack_pair(w, 128, True)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, 512)).astype(np.float32))
    from repro_torch.core.quant import unpack_int4
    q = unpack_int4(tb.vals).float()                        # [N, M, 128]
    want = torch.zeros((1, 2))
    for n in range(2):
        for i in range(tb.idx.shape[1]):
            c, s, z = int(tb.idx[n, i]), tb.scale[n, i], tb.zero[n, i]
            for p in range(4):
                xp = x[0, 128 * c + 32 * p:128 * c + 32 * (p + 1)]
                qp = q[n, i, 32 * p:32 * (p + 1)]
                want[0, n] += s * (qp * xp).sum() - (s * z) * xp.sum()
    got = ref.gqsa_gemv_grouped_ref(x, tb).numpy()
    assert _rel(got, want.numpy()) <= 1e-6
    assert _rel(got, ref.gqsa_gemv_ref(x, tb).numpy()) <= TOL


# ---------------------------------------------------------------------------
# the launch plans at g = 64 and 128 (shapes and SM count alone)
# ---------------------------------------------------------------------------

SMS = 132           # an H100 SXM
LLAMA = {"wq/wk/wv/wo": (4096, 4096), "wg/wu": (11008, 4096),
         "wd": (4096, 11008)}
MOE = {"deepseek-v2 wg/wu": (160, 1536, 5120),
       "deepseek-v2 wd": (160, 5120, 1536),
       "deepseek-moe-16b wg/wu": (64, 1408, 2048),
       "deepseek-moe-16b wd": (64, 2048, 1408)}


def _kept(k, g):
    """Kept groups a row at S50, as the pruning rounds them."""
    return max(1, int(round(k // g * 0.5)))


@pytest.mark.parametrize("g", [64, 128])
@pytest.mark.parametrize("t", [1, 4, 8, 9, 64, 116])
@pytest.mark.parametrize("label", list(LLAMA))
def test_plan_for_llama_projections_at_wide_group_sizes(label, t, g):
    """Every llama2-7b projection on 132 SMs at g = 64 and 128: one wave,
    at least 116 blocks busy, within the block's shared memory, and the
    largest tile from T = 5 on: x is staged as at g = 32, so wd (K =
    11008) takes 8 bf16 rows (230144 bytes) as it does there."""
    from repro_torch.kernels.gqsa_gemv import (SMEM_LIMIT, TILES,
                                               smem_bytes, token_tile)
    n, k = LLAMA[label]
    for itemsize in (2, 4):
        p = plan(t, n, k, g, itemsize, SMS)
        assert p.tiles == -(-t // p.tile)
        assert p.blocks % p.tiles == 0 and p.tiles <= p.blocks <= SMS
        assert p.blocks >= 116
        assert smem_bytes(p.tile, k, g, itemsize) == smem_bytes(
            p.tile, k, 32, itemsize) <= SMEM_LIMIT
        assert p.tile == token_tile(t, k, 32, itemsize)
        if t >= 8:
            assert p.tile == TILES[itemsize][-1]
    assert smem_bytes(8, 11008, g, 2) == 230144


@pytest.mark.parametrize("g", [64, 128])
@pytest.mark.parametrize("c", [1, 5, 13, 30])
@pytest.mark.parametrize("label", list(MOE))
def test_experts_plan_at_wide_group_sizes(label, c, g):
    """Both MoE families' expert projections at g = 64 and 128: a row's
    work items are M x g / 32 (deepseek-moe-16b's w_d: M = 11 at g = 64
    and 6 at g = 128, 22 and 24 items), so every row takes 32 lanes but
    DeepSeek-V2's w_g / w_u (M = 40 and 20, 80 items at both sizes: a
    third trip of 16), which take 16, as at g = 32 (M = 80); the tile
    follows C and every expert width fits 8
    bf16 rows; one block an SM, within the block's shared memory."""
    from repro_torch.kernels.gqsa_gemv import (SMEM_LIMIT, TILES,
                                               experts_smem_bytes)
    e, n, k = MOE[label]
    m = _kept(k, g)
    items = m * g // 32
    for itemsize in (2, 4):
        p = experts_plan(e, c, n, m, k, g, itemsize, SMS)
        assert p.row_lanes == row_lanes(items) == (
            16 if label == "deepseek-v2 wg/wu" else 32)
        assert p.tile == min(TILES[itemsize][-1], 1 << (c - 1).bit_length())
        assert p.blocks == SMS
        assert p.smem == experts_smem_bytes(p.tile, k, g, itemsize)
        assert p.smem <= SMEM_LIMIT
    if label == "deepseek-moe-16b wd":
        assert (m, items) == {64: (11, 22), 128: (6, 24)}[g]


def test_work_items_and_lines():
    """A staged line holds g values up to 32 and 32 above; a kept group
    is g / 32 work items above 32 (one below)."""
    assert [line_values(g) for g in GROUP_SIZES] == [8, 16, 32, 32, 32]
    assert [g // line_values(g) for g in GROUP_SIZES] == [1, 1, 1, 2, 4]


@pytest.mark.parametrize("g", [256, 96, 4])
def test_other_group_sizes_raise_naming_the_roadmap(g):
    """A group size the kernels still refuse raises NotImplementedError
    naming ROADMAP.md B.8, before the wrapper checks anything else (here
    on CPU tensors, which it would refuse next): nothing falls back to the
    plain version."""
    from repro_torch.core.bsr import BSRMatrix
    from repro_torch.kernels.gqsa_gemv import (gqsa_gemv_cuda,
                                               gqsa_gemv_experts_cuda)
    k = 3 * 256
    bsr = BSRMatrix(idx=torch.zeros((8, 1), dtype=torch.int32),
                    vals=torch.zeros((8, 1, g // 2), dtype=torch.uint8),
                    scale=torch.ones((8, 1)), zero=torch.zeros((8, 1)),
                    shape=(8, k), group_size=g, bits=4)
    x = torch.zeros((2, k))
    with pytest.raises(NotImplementedError, match="ROADMAP.md B.8"):
        gqsa_gemv_cuda(x, bsr)
    stacked = dataclasses.replace(bsr, **{
        f: getattr(bsr, f)[None] for f in ("idx", "vals", "scale", "zero")})
    with pytest.raises(NotImplementedError, match="ROADMAP.md B.8"):
        gqsa_gemv_experts_cuda(x[None], stacked)
