"""The streaming ``gqsa_gemv`` kernel, on the CPU: its order of arithmetic
in plain PyTorch (``kernels/ref.py:gqsa_gemv_grouped_ref``) against the
port's plain version and the JAX reference (the Pallas kernel in
interpret mode and its jnp oracle) on the same numpy inputs, at each
group size the kernel takes (8, 16, 32, 64, 128; the reference packs at
g), and the launcher's choices (token tile, grid, shared memory), which
come from shapes, the group size and the SM count alone.

Tolerance, max-abs error over max |y|: 1e-5 for bf16 and f32 x. Every
side multiplies the same f32 values (bf16 x widens exactly, the codes are
exact integers); the grouped order (s * sum q x - s z * sum x a group)
differs from the dequantize-then-multiply oracles in rounding only
(measured a few 1e-7)."""
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
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.gqsa_gemv import (GROUP_SIZES,  # noqa: E402
                                           RING_DEPTH, SMEM_LIMIT,
                                           STAGE_BYTES, STREAM_WARPS, TILES,
                                           payload_bytes, plan, smem_bytes,
                                           token_tile)

from _torch_utils import jax_tree_to_numpy  # noqa: E402

TOL = 1e-5
SMS = 132           # an H100 SXM
LLAMA = {"wq/wk/wv/wo": (4096, 4096), "wg/wu": (11008, 4096),
         "wd": (4096, 11008)}


def _bsr_pair(seed, n, k, balanced, g=16):
    """The same packed matrix in both packages (packed by the reference at
    group size ``g``, carried over through the bridge)."""
    w = np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)
    gm = jgroup_mask(jgroup_saliency(jnp.square(jnp.asarray(w)), g),
                     JPruneConfig(sparsity=0.5, group_size=g,
                                  row_balanced=balanced))
    jb = jbsr.pack_dense(jnp.asarray(w), gm, JQuantConfig(bits=4,
                                                          group_size=g))
    return jb, params_from_numpy(jax_tree_to_numpy(jb), "cpu")


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("g", GROUP_SIZES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("t", [1, 4, 8, 9, 20, 116])
def test_grouped_ref_matches_plain_and_reference(t, balanced, dtype, g):
    """N = 48, K = 256 at group size g; the ragged packing (not
    row-balanced) carries -1 padding slots with scale 0."""
    n, k = 48, 256
    jb, tb = _bsr_pair(t + 100 * balanced, n, k, balanced, g)
    assert tb.group_size == g and tb.vals.shape[-1] == g // 2
    if not balanced:
        assert (tb.idx < 0).any()
    x = np.random.default_rng(t).normal(size=(t, k)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    y = ref.gqsa_gemv_grouped_ref(tx, tb)
    assert y.shape == (t, n) and y.dtype == torch.float32
    y = y.numpy()
    plain = ops.gqsa_gemv(tx, tb).numpy()          # the CPU path
    # the reference sees the same x values: bf16 ones widen exactly
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype))
    y_ker = np.asarray(jops.gqsa_gemv(jx, jb, use_pallas=True,
                                      interpret=True, block_n=16,
                                      block_m=4))
    y_ref = np.asarray(jref.gqsa_gemv_ref(jx, jb))
    for other in (plain, y_ker, y_ref):
        assert _rel(y, other) <= TOL


@pytest.mark.parametrize("g", GROUP_SIZES)
def test_grouped_ref_reads_nothing_of_a_padding_slot(g):
    """A padding slot (idx -1, scale 0) adds nothing, whatever its codes
    and zero point hold."""
    _, tb = _bsr_pair(7, 32, 128, False, g)
    pad = tb.idx < 0
    assert pad.any()
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(3, 128))
                         .astype(np.float32))
    y = ref.gqsa_gemv_grouped_ref(x, tb)
    tb.vals[pad] = 0xA5
    tb.zero[pad] = 3.0
    assert torch.equal(ref.gqsa_gemv_grouped_ref(x, tb), y)


@pytest.mark.parametrize("t", [1, 4, 8, 64, 116, 128])
@pytest.mark.parametrize("label", list(LLAMA))
def test_plan_for_llama_projections(label, t):
    """Every llama2-7b projection on 132 SMs: one wave of blocks (at most
    one an SM, a multiple of the tile count), at least 116 of them busy,
    dynamic shared memory within 227 KB, and the largest tile the rows
    can use (8 bf16 or 4 f32 rows) from T = 5 on."""
    n, k = LLAMA[label]
    for itemsize in (2, 4):
        p = plan(t, n, k, 16, itemsize, SMS)
        assert p.tile in TILES[itemsize]
        assert p.tiles == -(-t // p.tile)
        assert p.blocks % p.tiles == 0 and p.tiles <= p.blocks <= SMS
        assert p.blocks >= 116
        assert smem_bytes(p.tile, k, 16, itemsize) <= SMEM_LIMIT
        if t >= 64:
            assert p.tile == TILES[itemsize][-1]


@pytest.mark.parametrize("t", [1, 4, 8, 64, 116])
@pytest.mark.parametrize("label", list(LLAMA))
@pytest.mark.parametrize("g", [8, 32])
def test_plan_for_llama_projections_at_other_group_sizes(g, label, t):
    """The same at g = 8 and 32: one wave, at least 116 blocks busy,
    within 227 KB, and the largest tile from T = 5 on but for wd (K =
    11008) at g = 8 in bf16, where 8 rows do not fit (244736 bytes) and
    the tile stays 4 (a T = 64 prefill runs 16 tiles)."""
    n, k = LLAMA[label]
    for itemsize in (2, 4):
        p = plan(t, n, k, g, itemsize, SMS)
        assert p.tiles == -(-t // p.tile)
        assert p.blocks % p.tiles == 0 and p.tiles <= p.blocks <= SMS
        assert p.blocks >= 116
        assert smem_bytes(p.tile, k, g, itemsize) <= SMEM_LIMIT
        short = g == 8 and label == "wd" and itemsize == 2
        largest = 4 if short else TILES[itemsize][-1]
        if t >= 8:
            assert p.tile == largest
        if t == 64 and short:
            assert p.tiles == 16


@pytest.mark.parametrize("t,itemsize,k,g,want", [
    (1, 2, 4096, 16, 1), (2, 2, 4096, 16, 2), (3, 2, 4096, 16, 4),
    (4, 2, 4096, 16, 4), (5, 2, 4096, 16, 8), (8, 2, 4096, 16, 8),
    (9, 2, 4096, 16, 8), (20, 2, 4096, 16, 8), (64, 2, 4096, 16, 8),
    (116, 2, 4096, 16, 8), (128, 2, 11008, 16, 8), (4, 4, 4096, 16, 4),
    (8, 4, 4096, 16, 4), (116, 4, 11008, 16, 4), (8, 2, 16384, 16, 4),
    (8, 4, 16384, 16, 2),
    (8, 2, 11008, 8, 4), (64, 2, 11008, 8, 4), (8, 4, 11008, 8, 4),
    (8, 2, 4096, 8, 8), (3, 2, 11008, 8, 4), (1, 2, 11008, 8, 1),
    (8, 2, 11008, 32, 8), (116, 2, 11008, 32, 8), (116, 4, 11008, 32, 4),
    (8, 2, 16384, 32, 4), (8, 4, 16384, 8, 2)])
def test_token_tile(t, itemsize, k, g, want):
    """The smallest tile that holds the rows, else the largest, among the
    tiles whose x fits beside the rings: a K = 16384 bf16 tile of 8 rows
    (256 KB) does not, nor an f32 one of 4; at g = 8, llama2-7b's wd (K =
    11008) does not take 8 bf16 rows either (its group sums are twice
    g = 16's), at g = 32 it does."""
    assert token_tile(t, k, g, itemsize) == want


def test_shared_memory_sizes():
    """x tile [K/16][tile][16], its f32 group sums rounded up to 16 bytes,
    ``STREAM_WARPS`` rings of ``RING_DEPTH`` 640-byte stages; llama2-7b's
    wd (K = 11008) at 8 bf16 rows takes 228864 bytes of 232448."""
    ring = STREAM_WARPS * RING_DEPTH * 640
    assert smem_bytes(4, 4096, 16, 2) == 32768 + 4096 + ring
    assert smem_bytes(1, 48, 16, 4) == 192 + 16 + ring
    assert smem_bytes(8, 11008, 16, 2) == 228864 <= SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        token_tile(1, 1 << 20, 16, 4)


@pytest.mark.parametrize("g,stage,payload,wd8", [(8, 512, 16, 244736),
                                                 (32, 896, 28, 230144)])
def test_shared_memory_sizes_at_other_group_sizes(g, stage, payload, wd8):
    """x tile [K/g][tile][g] (K x tile values whatever g), its group sums
    [K/g][tile] f32, rings of 32 slots of g/2 + 12 bytes: llama2-7b's wd
    at 8 bf16 rows takes 176128 + 44032 + 24576 = 244736 bytes at g = 8,
    over the 232448 a block may take, and 176128 + 11008 + 43008 = 230144
    at g = 32, under it."""
    assert STAGE_BYTES[g] == stage == 32 * payload_bytes(g)
    assert payload_bytes(g) == payload
    ring = STREAM_WARPS * RING_DEPTH * stage
    assert smem_bytes(8, 11008, g, 2) == 176128 + 11008 // g * 32 + ring
    assert smem_bytes(8, 11008, g, 2) == wd8
    assert (wd8 <= SMEM_LIMIT) == (g == 32)
    assert smem_bytes(4, 4096, g, 2) == 32768 + 4096 * 16 // g + ring
    assert smem_bytes(1, 64, g, 4) == 256 + {8: 32, 32: 16}[g] + ring


def test_layout_constants_match_the_cuda_source():
    """The plan's shared-memory count and the kernel's layout share their
    constants: the CUDA source declares the same warps, ring depth, stage
    size at each group size (a static_assert on ``sizeof(Stage<G>)``),
    group sizes and limit. On the card the launcher also refuses any
    size but its own count, and any other group size."""
    path = os.path.join(os.path.dirname(__file__), "..", "src",
                        "repro_torch", "csrc", "gqsa_gemv.cu")
    with open(path) as f:
        src = f.read()
    taken = " || ".join(f"g == {g}" for g in GROUP_SIZES)
    for decl in (f"constexpr int kWarps = {STREAM_WARPS};",
                 f"constexpr int kDepth = {RING_DEPTH};",
                 f"constexpr int kMaxSmem = {SMEM_LIMIT};",
                 f"inline bool takes_group(int g) {{ return {taken}; }}",
                 *(f"static_assert(sizeof(Stage<{g}>) == {STAGE_BYTES[g]},"
                   for g in GROUP_SIZES)):
        assert decl in src, decl
    assert sorted(STAGE_BYTES) == list(GROUP_SIZES)


@pytest.mark.parametrize("n,t,want", [(4096, 4, 132), (4096, 116, 120),
                                      (40, 4, 3), (40, 116, 45),
                                      (11008, 2000, 250)])
def test_grid_from_shapes(n, t, want):
    """Blocks: SMs / tiles on each tile, at least one, never more than
    N / 16 a tile (a block of 16 warps needs a row a warp); beyond 132
    tiles, several waves of one block a tile."""
    assert plan(t, n, 4096, 16, 2, SMS).blocks == want
