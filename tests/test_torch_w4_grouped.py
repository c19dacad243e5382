"""The tensor-core path of the ``w4_matmul`` kernel, on the CPU: its order
of arithmetic in plain PyTorch (``kernels/ref.py:w4_matmul_grouped_ref``)
against the port's plain version and the JAX reference (the Pallas kernel
in interpret mode and its jnp oracle) on the same numpy inputs, and the
launcher's choices (path, x tile, split count), which come from shapes
alone.

Tolerances, max-abs error over max |y|:
  * bf16 x: 1e-5. Both sides multiply the same f32 values exactly; the
    grouped order (s * sum q x - s z * sum x a group) differs in rounding
    only (measured a few 1e-7);
  * f32 x: 2e-5. The grouped order takes x as bf16 hi + lo, which holds x
    to 2^-18 relative (measured 2-3e-6)."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.gqs_layer import pack_w4 as jpack_w4  # noqa: E402
from repro.core.quant import QuantConfig as JQuantConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.w4_matmul import (TC_K, split_count,  # noqa: E402
                                           takes_tensor_cores, token_tiles)

TOL = {"bfloat16": 1e-5, "float32": 2e-5}


def _case(t, n, k, g, integer_zero, seed):
    """x [T, K] and the W4 packing of a random [N, K] weight; zero points
    moved off the integers by up to 0.5 where ``integer_zero`` is False."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    x = rng.normal(size=(t, k)).astype(np.float32)
    p = {f: np.array(v) for f, v in
         jpack_w4(jnp.asarray(w), JQuantConfig(bits=4, group_size=g)).items()}
    if not integer_zero:
        p["zero"] = (p["zero"] + rng.uniform(-0.5, 0.5, p["zero"].shape)
                     ).astype(np.float32)
    return x, p


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("integer_zero", [True, False])
@pytest.mark.parametrize("g", [16, 128])
@pytest.mark.parametrize("t", [1, 3, 8, 64])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_grouped_ref_matches_plain_and_reference(dtype, t, g, integer_zero):
    """Ragged N (70 rows, not a multiple of the kernel's 64-row tile)."""
    n, k = 70, 256
    x, p = _case(t, n, k, g, integer_zero, seed=t * 7 + g)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tp = {f: torch.from_numpy(v) for f, v in p.items()}
    y = ref.w4_matmul_grouped_ref(tx, tp["qw"], tp["scale"], tp["zero"], g)
    assert y.shape == (t, n) and y.dtype == torch.float32
    y = y.numpy()
    plain = ref.w4_matmul_ref(tx, tp["qw"], tp["scale"], tp["zero"],
                              g).numpy()
    # the reference sees the same x values: bf16 ones widen exactly
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype))
    jargs = (jx, jnp.asarray(p["qw"]), jnp.asarray(p["scale"]),
             jnp.asarray(p["zero"]))
    y_ker = np.asarray(jops.w4_matmul(*jargs, group_size=g, use_pallas=True,
                                      interpret=True))
    y_ref = np.asarray(jref.w4_matmul_ref(*jargs, g))
    for other in (plain, y_ker, y_ref):
        assert _rel(y, other) <= TOL[dtype]


def test_grouped_ref_f32_split_is_the_kernels_rounding():
    """f32 x enters as bf16 hi + lo: x values that bf16 holds exactly give
    the bf16 result, and the split's residual stays below 2^-16 of |x|."""
    x, p = _case(4, 40, 256, 16, True, seed=5)
    tp = {f: torch.from_numpy(v) for f, v in p.items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    args = (tp["qw"], tp["scale"], tp["zero"], 16)
    assert torch.equal(ref.w4_matmul_grouped_ref(xb.float(), *args),
                       ref.w4_matmul_grouped_ref(xb, *args))
    xf = torch.from_numpy(x)
    hi = xf.to(torch.bfloat16).float()
    lo = (xf - hi).to(torch.bfloat16).float()
    assert ((xf - hi - lo).abs() <= 2.0 ** -16 * xf.abs()).all()


@pytest.mark.parametrize("k,g,aligned,want", [
    (4096, 16, True, True), (11008, 16, True, True), (256, 32, True, True),
    (256, 64, True, True), (512, 128, True, True),
    (96, 6, True, False), (48, 16, True, False), (192, 16, True, False),
    (512, 256, True, False), (4096, 16, False, False)])
def test_tensor_core_path_is_chosen_by_shape(k, g, aligned, want):
    """G in {16, 32, 64, 128}, K a multiple of 128 and 16-byte aligned
    operands take the tensor cores; G = 6, K = 48 or 192, G = 256 and a
    misaligned operand the CUDA cores."""
    ptrs = (4096, 8192, 1 << 20, 3 << 20)
    if not aligned:
        ptrs = (4096, 8193, 1 << 20, 3 << 20)
    assert takes_tensor_cores(k, g, *ptrs) is want


@pytest.mark.parametrize("t,want", [(1, 1), (4, 1), (8, 1), (9, 2), (16, 2),
                                    (17, 4), (32, 4), (33, 8), (64, 8),
                                    (200, 8)])
def test_token_tiles(t, want):
    assert token_tiles(t) == want


@pytest.mark.parametrize("t,n,k,want", [
    (4, 4096, 4096, 6), (4, 11008, 4096, 2), (4, 4096, 11008, 6),
    (1, 4096, 4096, 6), (16, 4096, 4096, 6), (64, 4096, 4096, 4),
    (64, 11008, 4096, 2), (200, 4096, 4096, 1), (4, 64, 128, 1),
    (4, 100, 512, 4), (4, 11008, 128, 1)])
def test_split_count_comes_from_shapes(t, n, k, want):
    """On 132 SMs: the count nearest to 3 blocks an SM up to 16 x rows and
    2 above, at most one split a 128-element stage of K, at least one."""
    s = split_count(t, n, k, 132)
    assert s == want and 1 <= s <= max(1, k // TC_K)
