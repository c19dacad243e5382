"""The streaming ``gqsa_gemv`` kernel, on the CPU: its order of arithmetic
in plain PyTorch (``kernels/ref.py:gqsa_gemv_grouped_ref``) against the
port's plain version and the JAX reference (the Pallas kernel in
interpret mode and its jnp oracle) on the same numpy inputs, and the
launcher's choices (token tile, grid, shared memory), which
come from shapes and the SM count alone.

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
from repro_torch.kernels.gqsa_gemv import (GROUP_SIZE,  # noqa: E402
                                           RING_DEPTH, SMEM_LIMIT,
                                           STAGE_BYTES, STREAM_WARPS, TILES,
                                           plan, smem_bytes, token_tile)

from _torch_utils import jax_tree_to_numpy  # noqa: E402

TOL = 1e-5
SMS = 132           # an H100 SXM
LLAMA = {"wq/wk/wv/wo": (4096, 4096), "wg/wu": (11008, 4096),
         "wd": (4096, 11008)}


def _bsr_pair(seed, n, k, balanced):
    """The same packed matrix in both packages (packed by the reference,
    carried over through the bridge)."""
    w = np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)
    gm = jgroup_mask(jgroup_saliency(jnp.square(jnp.asarray(w)), 16),
                     JPruneConfig(sparsity=0.5, group_size=16,
                                  row_balanced=balanced))
    jb = jbsr.pack_dense(jnp.asarray(w), gm, JQuantConfig(bits=4,
                                                          group_size=16))
    return jb, params_from_numpy(jax_tree_to_numpy(jb), "cpu")


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("t", [1, 4, 8, 9, 20, 116])
def test_grouped_ref_matches_plain_and_reference(t, balanced, dtype):
    """N = 48, K = 256; the ragged packing (not row-balanced) carries -1
    padding slots with scale 0."""
    n, k = 48, 256
    jb, tb = _bsr_pair(t + 100 * balanced, n, k, balanced)
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


def test_grouped_ref_reads_nothing_of_a_padding_slot():
    """A padding slot (idx -1, scale 0) adds nothing, whatever its codes
    and zero point hold."""
    _, tb = _bsr_pair(7, 32, 128, False)
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
        p = plan(t, n, k, itemsize, SMS)
        assert p.tile in TILES[itemsize]
        assert p.tiles == -(-t // p.tile)
        assert p.blocks % p.tiles == 0 and p.tiles <= p.blocks <= SMS
        assert p.blocks >= 116
        assert smem_bytes(p.tile, k, itemsize) <= SMEM_LIMIT
        if t >= 64:
            assert p.tile == TILES[itemsize][-1]


@pytest.mark.parametrize("t,itemsize,k,want", [
    (1, 2, 4096, 1), (2, 2, 4096, 2), (3, 2, 4096, 4), (4, 2, 4096, 4),
    (5, 2, 4096, 8), (8, 2, 4096, 8), (9, 2, 4096, 8), (20, 2, 4096, 8),
    (64, 2, 4096, 8),
    (116, 2, 4096, 8), (128, 2, 11008, 8), (4, 4, 4096, 4),
    (8, 4, 4096, 4), (116, 4, 11008, 4), (8, 2, 16384, 4),
    (8, 4, 16384, 2)])
def test_token_tile(t, itemsize, k, want):
    """The smallest tile that holds the rows, else the largest, among the
    tiles whose x fits beside the rings: a K = 16384 bf16 tile of 8 rows
    (256 KB) does not, nor an f32 one of 4."""
    assert token_tile(t, k, itemsize) == want


def test_shared_memory_sizes():
    """x tile [K/16][tile][16], its f32 group sums rounded up to 16 bytes,
    ``STREAM_WARPS`` rings of ``RING_DEPTH`` 640-byte stages; llama2-7b's
    wd (K = 11008) at 8 bf16 rows takes 228864 bytes of 232448."""
    ring = STREAM_WARPS * RING_DEPTH * 640
    assert smem_bytes(4, 4096, 2) == 32768 + 4096 + ring
    assert smem_bytes(1, 48, 4) == 192 + 16 + ring
    assert smem_bytes(8, 11008, 2) == 228864 <= SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        token_tile(1, 1 << 20, 4)


def test_layout_constants_match_the_cuda_source():
    """The plan's shared-memory count and the kernel's layout share their
    constants: the CUDA source declares the same warps, ring depth, stage
    size (a static_assert on ``sizeof(Stage)``), group size and limit.
    On the card the launcher also refuses any size but its own count."""
    path = os.path.join(os.path.dirname(__file__), "..", "src",
                        "repro_torch", "csrc", "gqsa_gemv.cu")
    with open(path) as f:
        src = f.read()
    for decl in (f"constexpr int kWarps = {STREAM_WARPS};",
                 f"constexpr int kDepth = {RING_DEPTH};",
                 f"constexpr int kMaxSmem = {SMEM_LIMIT};",
                 f"constexpr int kGroup = {GROUP_SIZE};",
                 f"static_assert(sizeof(Stage) == {STAGE_BYTES},"):
        assert decl in src, decl


@pytest.mark.parametrize("n,t,want", [(4096, 4, 132), (4096, 116, 120),
                                      (40, 4, 3), (40, 116, 45),
                                      (11008, 2000, 250)])
def test_grid_from_shapes(n, t, want):
    """Blocks: SMs / tiles on each tile, at least one, never more than
    N / 16 a tile (a block of 16 warps needs a row a warp); beyond 132
    tiles, several waves of one block a tile."""
    assert plan(t, n, 4096, 2, SMS).blocks == want
