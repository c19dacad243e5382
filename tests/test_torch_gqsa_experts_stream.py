"""The expert axis of the streaming ``gqsa_gemv`` kernel, on the CPU: its
order of arithmetic in plain PyTorch
(``kernels/ref.py:gqsa_gemv_experts_grouped_ref``) against the port's
plain version (``gqsa_gemv_experts_ref``) and, expert by expert, the JAX
reference's Pallas kernel in interpret mode, on the same numpy inputs,
at each group size the kernel takes (8, 16, 32, 64, 128); and the
expert launch's plan (token tile, grid, shared memory), which comes from
shapes, the group size and the SM count alone.

Tolerance, max-abs error over max |y|: 1e-5 for bf16 and f32 x, as for
the single-matrix kernel (``test_torch_gqsa_stream.py``): every side
multiplies the same f32 values, and the grouped order differs from the
dequantize-then-multiply oracles in rounding only."""
import dataclasses
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import bsr as jbsr  # noqa: E402
from repro.core.pruning import PruneConfig as JPruneConfig  # noqa: E402
from repro.core.pruning import group_mask as jgroup_mask  # noqa: E402
from repro.core.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.saliency import group_saliency as jgroup_saliency  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.gqsa_gemv import (CTRL_BYTES,  # noqa: E402
                                           EXPERT_RING_DEPTH, GROUP_SIZES,
                                           SMEM_LIMIT, STAGE_BYTES,
                                           STREAM_WARPS, TILES, experts_plan,
                                           experts_smem_bytes, row_lanes,
                                           smem_bytes, token_tile)

from _torch_utils import jax_tree_to_numpy  # noqa: E402

TOL = 1e-5
SMS = 132           # an H100 SXM
E, N, K = 4, 48, 256
# (E, N, M, K) of each routed-expert projection under GQSA W4 S50 G16
# (M = K / 32 kept groups a row): DeepSeek-V2 w_g / w_u and w_d,
# deepseek-moe-16b wg / wu and wd
MOE = {"deepseek-v2 wg/wu": (160, 1536, 160, 5120),
       "deepseek-v2 wd": (160, 5120, 48, 1536),
       "deepseek-moe-16b wg/wu": (64, 1408, 64, 2048),
       "deepseek-moe-16b wd": (64, 2048, 44, 1408)}


def _stacked_pair(seed, balanced, g=16):
    """E experts packed by the reference at group size ``g``, stacked
    [E, ...], in both packages (carried over through the bridge)."""
    rng = np.random.default_rng(seed)
    packed = []
    for _ in range(E):
        w = jnp.asarray(rng.normal(size=(N, K)).astype(np.float32))
        gm = jgroup_mask(jgroup_saliency(jnp.square(w), g),
                         JPruneConfig(sparsity=0.5, group_size=g,
                                      row_balanced=balanced))
        packed.append(jbsr.pack_dense(w, gm, JQuantConfig(bits=4,
                                                          group_size=g)))
    # a ragged packing's M differs by expert: pad each to the largest with
    # padding slots (idx -1, scale 0), as a stacked packing holds them
    m = max(b.idx.shape[1] for b in packed)
    packed = [dataclasses.replace(
        b, idx=jnp.pad(b.idx, ((0, 0), (0, m - b.idx.shape[1])),
                       constant_values=-1),
        **{f: jnp.pad(getattr(b, f), ((0, 0), (0, m - b.idx.shape[1]))
                      + ((0, 0),) * (getattr(b, f).ndim - 2))
           for f in ("vals", "scale", "zero")}) for b in packed]
    jb = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *packed)
    return jb, params_from_numpy(jax_tree_to_numpy(jb), "cpu")


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _rows(c):
    """An idle expert, a full one, a partly filled one (C > 1) and one
    holding a single row."""
    return torch.tensor([0, c, (c + 1) // 2, 1], dtype=torch.int32)


@pytest.mark.parametrize("g", GROUP_SIZES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("c", [1, 3, 9])
def test_experts_grouped_ref_matches_plain_and_reference(c, balanced, dtype,
                                                         g):
    """N = 48, K = 256, E = 4 at C buffer rows and group size g, with
    ``rows`` given (idle and partly filled experts) and absent; the ragged
    packing carries -1 padding slots with scale 0. The reference runs its
    Pallas kernel on each expert's filled rows in interpret mode."""
    jb, tb = _stacked_pair(c + 10 * balanced, balanced, g)
    assert tb.group_size == g and tb.vals.shape[-1] == g // 2
    if not balanced:
        assert (tb.idx < 0).any()
    x = np.random.default_rng(c).normal(size=(E, c, K)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype))
    for rows in (_rows(c), None):
        y = ref.gqsa_gemv_experts_grouped_ref(tx, tb, rows)
        assert y.shape == (E, c, N) and y.dtype == torch.float32
        y = y.numpy()
        plain = ops.gqsa_gemv_experts(tx, tb, rows).numpy()   # the CPU path
        assert _rel(y, plain) <= TOL
        filled = [c] * E if rows is None else rows.tolist()
        for e in range(E):
            assert (y[e, filled[e]:] == 0).all()
            if filled[e]:
                be = jax.tree_util.tree_map(lambda a: a[e], jb)
                y_ker = np.asarray(jops.gqsa_gemv(
                    jx[e, :filled[e]], be, use_pallas=True, interpret=True,
                    block_n=16, block_m=4))
                assert _rel(y[e, :filled[e]], y_ker) <= TOL


def test_experts_grouped_ref_reads_nothing_idle():
    """An idle expert's leaves and the x rows past an expert's count are
    never read: NaN there leaves the output finite and unchanged."""
    _, tb = _stacked_pair(3, False)
    c = 3
    rows = _rows(c)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(E, c, K))
                         .astype(np.float32))
    y = ref.gqsa_gemv_experts_grouped_ref(x, tb, rows)
    idle = torch.arange(c)[None, :] >= rows[:, None]
    x[idle] = float("nan")
    tb.scale[rows == 0] = float("nan")
    tb.zero[rows == 0] = float("nan")
    got = ref.gqsa_gemv_experts_grouped_ref(x, tb, rows)
    assert torch.isfinite(got).all()
    assert torch.equal(got, y)


@pytest.mark.parametrize("c", [1, 3, 7, 9, 30])
@pytest.mark.parametrize("label", list(MOE))
def test_experts_plan_at_moe_shapes(label, c):
    """Every routed-expert projection of both MoE families on 132 SMs:
    the tile the single-matrix plan would take for C rows (8 bf16 or 4
    f32 rows from C = 5 on), two rows a warp for the w_d projections (M
    = 48 and 44) and one for the others, one block an SM, and the block's
    shared memory within 227 KB."""
    e, n, m, k = MOE[label]
    for itemsize in (2, 4):
        p = experts_plan(e, c, n, m, k, 16, itemsize, SMS)
        assert p.row_lanes == (16 if label.endswith("wd") else 32)
        assert p.tile == token_tile(c, k, 16, itemsize) in TILES[itemsize]
        assert p.tile == min(TILES[itemsize][-1], 1 << (c - 1).bit_length())
        assert p.blocks == SMS
        assert p.smem == experts_smem_bytes(p.tile, k, 16, itemsize)
        assert p.smem <= SMEM_LIMIT


@pytest.mark.parametrize("c", [1, 3, 9, 30])
@pytest.mark.parametrize("label", list(MOE))
@pytest.mark.parametrize("g", [8, 32])
def test_experts_plan_at_other_group_sizes(g, label, c):
    """The same at g = 8 and 32, where a row keeps M x 16 / g groups: the
    w_d rows (M = 96 and 88 at g = 8, 24 and 22 at g = 32) take 32 lanes,
    and so does every other row but DeepSeek-V2's w_g / w_u at g = 32 (M
    = 80: its third trip would leave half a warp idle), which takes 16;
    the tile follows C as at g = 16 (every expert width fits 8 bf16
    rows)."""
    e, n, m16, k = MOE[label]
    m = m16 * 16 // g
    for itemsize in (2, 4):
        p = experts_plan(e, c, n, m, k, g, itemsize, SMS)
        assert p.row_lanes == (16 if (g, label) == (32, "deepseek-v2 wg/wu")
                               else 32)
        assert p.tile == min(TILES[itemsize][-1], 1 << (c - 1).bit_length())
        assert p.blocks == SMS
        assert p.smem == experts_smem_bytes(p.tile, k, g, itemsize)
        assert p.smem <= SMEM_LIMIT


@pytest.mark.parametrize("e,c,n,want", [(160, 1, 1536, 132), (2, 1, 40, 5),
                                        (1, 9, 40, 5), (3, 1, 16, 3),
                                        (64, 30, 2048, 132)])
def test_experts_grid_from_shapes(e, c, n, want):
    """One block an SM, fewer only when all E x C buffer rows give fewer
    than 16 output rows (a block's warps) a block: E x ceil(C / tile) x N
    rows over 16."""
    assert experts_plan(e, c, n, 8, 256, 16, 2, SMS).blocks == want


@pytest.mark.parametrize("m,want", [(1, 16), (16, 16), (17, 32), (32, 32),
                                    (44, 16), (48, 16), (49, 32), (64, 32),
                                    (160, 32), (344, 32)])
def test_experts_row_lanes(m, want):
    """16 lanes a row (two rows a warp) when a row's last 32-slot trip
    would be half empty or less, else 32."""
    assert row_lanes(m) == want


def test_experts_shared_memory_sizes():
    """The single-matrix layout with rings ``EXPERT_RING_DEPTH`` deep and
    ``CTRL_BYTES`` of block-shared ints after them: a DeepSeek-V2 w_g at
    C = 1 (bf16) takes 52608 bytes, at 8 rows 133248."""
    ring = STREAM_WARPS * EXPERT_RING_DEPTH * STAGE_BYTES[16]
    assert experts_smem_bytes(1, 5120, 16, 2) == 10240 + 1280 + ring + 128
    assert experts_smem_bytes(8, 5120, 16, 2) == 81920 + 10240 + ring + 128
    assert experts_smem_bytes(4, 48, 16, 4) == (
        smem_bytes(4, 48, 16, 4)
        + STREAM_WARPS * STAGE_BYTES[16] * (EXPERT_RING_DEPTH - 3) + 128)
    assert experts_smem_bytes(8, 5120, 16, 2) == 133248 <= SMEM_LIMIT


@pytest.mark.parametrize("g,stage,w8", [(8, 512, 135296), (32, 896, 144512)])
def test_experts_shared_memory_sizes_at_other_group_sizes(g, stage, w8):
    """At g = 8 and 32: the x tile as at g = 16, group sums [K/g][tile]
    f32, rings of 512- or 896-byte stages ``EXPERT_RING_DEPTH`` deep and
    ``CTRL_BYTES``: a DeepSeek-V2 w_g (K = 5120) at 8 bf16 rows takes
    81920 + 20480 + 32768 + 128 = 135296 bytes at g = 8 and 81920 + 5120
    + 57344 + 128 = 144512 at g = 32."""
    ring = STREAM_WARPS * EXPERT_RING_DEPTH * stage
    assert STAGE_BYTES[g] == stage
    assert experts_smem_bytes(8, 5120, g, 2) == (81920 + 5120 // g * 32
                                                 + ring + 128)
    assert experts_smem_bytes(8, 5120, g, 2) == w8 <= SMEM_LIMIT
    assert experts_smem_bytes(1, 1408, g, 2) == (
        smem_bytes(1, 1408, g, 2)
        + STREAM_WARPS * stage * (EXPERT_RING_DEPTH - 3) + 128)


def test_experts_layout_constants_match_the_cuda_source():
    """The expert plan's shared-memory count and the kernel's layout share
    their constants: the CUDA source's ring depth, block-shared ints and
    per-group-size stages (``Stage<G>``, the single-matrix kernel's) are
    the wrapper's. On the card the launcher also refuses any size but its
    own count, and any group size but 8, 16, 32, 64 and 128."""
    path = os.path.join(os.path.dirname(__file__), "..", "src",
                        "repro_torch", "csrc", "gqsa_gemv.cu")
    with open(path) as f:
        src = f.read()
    for decl in (f"constexpr int kExpertDepth = {EXPERT_RING_DEPTH};",
                 f"constexpr int kCtrlInts = {CTRL_BYTES // 4};",
                 "+ kCtrlInts * sizeof(int);",
                 "static_cast<size_t>(kWarps) * kExpertDepth * "
                 "stage_bytes(g)",
                 "template <typename T, int TT, int G, int kRowLanes>\n"
                 "__global__ void __launch_bounds__(kThreads, 1)\n"
                 "gqsa_gemv_experts_kernel(",
                 *(f"static_assert(sizeof(Stage<{g}>) == {STAGE_BYTES[g]},"
                   for g in GROUP_SIZES)):
        assert decl in src, decl
