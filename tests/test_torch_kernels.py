"""Port conformance, kernels: the plain PyTorch versions that the port runs
on the CPU (and holds its CUDA kernels against on the card) agree with the
JAX reference's Pallas kernels (interpret mode) and oracles on the same
numpy inputs.

Tolerance 1e-5 (abs and rel) in f32: both sides compute the same f32
products and differ only in summation order over at most a few hundred
terms of O(1) values."""
import numpy as np
import pytest
import torch

# the suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps these small products from crowding the other files
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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.gqsa_gemv import gqsa_gemv_cuda  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_cuda  # noqa: E402
from repro_torch.kernels.w4_matmul import w4_matmul_cuda  # noqa: E402

from _torch_utils import jax_tree_to_numpy  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


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


@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("b", [1, 3, 8, 13])
def test_gqsa_gemv_plain_matches_reference(b, balanced):
    jb, tb = _bsr_pair(b + 10 * balanced, 48, 256, balanced)
    if not balanced:
        assert (tb.idx < 0).any()            # ragged rows carry padding
    x = np.random.default_rng(100 + b).normal(size=(b, 256)) \
        .astype(np.float32)
    y = ops.gqsa_gemv(torch.from_numpy(x), tb).numpy()
    y_ker = np.asarray(jops.gqsa_gemv(jnp.asarray(x), jb, use_pallas=True,
                                      interpret=True, block_n=16,
                                      block_m=4))
    y_ref = np.asarray(jref.gqsa_gemv_ref(jnp.asarray(x), jb))
    assert y.shape == (b, 48) and y.dtype == np.float32
    np.testing.assert_allclose(y, y_ker, **TOL)
    np.testing.assert_allclose(y, y_ref, **TOL)


def test_gqsa_gemv_plain_bf16_activations():
    """bf16 x is widened to f32 exactly on both sides."""
    jb, tb = _bsr_pair(5, 32, 128, True)
    x = np.random.default_rng(6).normal(size=(4, 128)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_allclose(ops.gqsa_gemv(tx, tb).numpy(),
                               np.asarray(jref.gqsa_gemv_ref(jx, jb)), **TOL)


def _paged_case(seed, b, t, kh, r, d, ps, mp, num_pages, dtype=np.float32):
    """Ragged block tables with sentinel tails over a shuffled pool, one
    all-sentinel slot (length 0) and staircase lengths [B, T]."""
    g = np.random.default_rng(seed)
    q = g.normal(size=(b, t, kh * r, d)).astype(np.float32)
    kp = g.normal(size=(num_pages, ps, kh, d)).astype(np.float32)
    vp = g.normal(size=(num_pages, ps, kh, d)).astype(np.float32)
    pages = g.permutation(num_pages)[:b * mp].reshape(b, mp).astype(np.int32)
    occ = g.integers(1, mp + 1, size=b)
    occ[-1] = 0                                  # all-sentinel slot
    bt = np.where(np.arange(mp)[None, :] < occ[:, None], pages, num_pages)
    lengths = np.zeros((b, t), np.int32)
    for i in range(b - 1):
        lengths[i] = np.sort(g.integers(1, occ[i] * ps + 1, size=t))
    return q, kp.astype(dtype), vp.astype(dtype), lengths, bt.astype(np.int32)


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("kh,r", [(4, 1), (2, 2)])
def test_paged_attention_plain_matches_reference(t, kh, r):
    q, kp, vp, lengths, bt = _paged_case(7 * t + kh, b=4, t=t, kh=kh, r=r,
                                         d=32, ps=8, mp=4, num_pages=20)
    o = ops.paged_decode_attention(*map(torch.from_numpy,
                                        (q, kp, vp, lengths, bt))).numpy()
    jargs = tuple(map(jnp.asarray, (q, kp, vp, lengths, bt)))
    o_ker = np.asarray(jops.paged_decode_attention(*jargs, use_pallas=True,
                                                   interpret=True))
    o_ref = np.asarray(jref.paged_attention_ref(*jargs))
    assert o.shape == (4, t, kh * r, 32)
    # length-0 rows: exact zeros in the port and in the TPU kernel; the
    # reference's oracle returns NaN there, so it is compared on the rest
    assert np.all(o[-1] == 0.0) and np.all(o_ker[-1] == 0.0)
    assert np.isnan(o_ref[-1]).all()
    np.testing.assert_allclose(o, o_ker, **TOL)
    np.testing.assert_allclose(o[:-1], o_ref[:-1], **TOL)


def test_paged_attention_plain_bf16_pages():
    q, kp, vp, lengths, bt = _paged_case(3, b=3, t=1, kh=2, r=1, d=16,
                                         ps=4, mp=3, num_pages=12)
    tk = torch.from_numpy(kp).to(torch.bfloat16)
    tv = torch.from_numpy(vp).to(torch.bfloat16)
    o = ops.paged_decode_attention(torch.from_numpy(q), tk, tv,
                                   torch.from_numpy(lengths),
                                   torch.from_numpy(bt)).numpy()
    jk = jnp.asarray(kp).astype(jnp.bfloat16)
    jv = jnp.asarray(vp).astype(jnp.bfloat16)
    o_ker = np.asarray(jops.paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(lengths), jnp.asarray(bt),
        use_pallas=True, interpret=True))
    np.testing.assert_allclose(o, o_ker, **TOL)


def test_dispatchers_never_fall_back():
    """Only a CPU tensor takes the plain version; a CUDA wrapper refuses a
    CPU tensor outright, and another device raises."""
    _, tb = _bsr_pair(1, 16, 64, True)
    with pytest.raises(ValueError, match="CUDA"):
        gqsa_gemv_cuda(torch.zeros(2, 64), tb)
    with pytest.raises(ValueError, match="no kernel"):
        ops.gqsa_gemv(torch.zeros(2, 64, device="meta"), tb)
    q, kp, vp, lengths, bt = map(torch.from_numpy, _paged_case(
        1, b=2, t=1, kh=2, r=1, d=16, ps=4, mp=2, num_pages=8))
    live = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(q.reshape(2, 2, 1, 16), kp, vp, lengths, bt,
                             live, 1)
    # the int8 mode: int8 pages with their scale pages
    k8, v8 = kp.to(torch.int8), vp.to(torch.int8)
    ks = vs = torch.ones(kp.shape[:3])
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(q.reshape(2, 2, 1, 16), k8, v8, lengths, bt,
                             live, 1, ks, vs)
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_decode_attention(q.to("meta"), k8, v8, lengths, bt, ks, vs)
    # w4_matmul
    qw = torch.zeros((16, 32), dtype=torch.uint8)
    sz = torch.ones((16, 4))
    with pytest.raises(ValueError, match="CUDA"):
        w4_matmul_cuda(torch.zeros(2, 64), qw, sz, sz, 16)
    with pytest.raises(ValueError, match="no kernel"):
        ops.w4_matmul(torch.zeros(2, 64, device="meta"), qw, sz, sz,
                      group_size=16)
    assert gqsa_gemv_cuda.launches == 0
    assert paged_attention_cuda.launches == 0
    assert paged_attention_cuda.int8_launches == 0
    assert w4_matmul_cuda.launches == 0
