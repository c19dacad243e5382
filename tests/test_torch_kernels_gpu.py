"""The port's CUDA kernels against their plain PyTorch versions, on the card.

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Marked ``gpu``; each test asks the ``cuda`` fixture for the card, which
skips when there is none (decided at run time, never at import). The
kernels build from ``src/repro_torch/csrc`` on first use. Tolerance:
max-abs error <= 1e-4 of the plain output's max-abs, since both sides run
f32 products (int8 pages and W4 codes dequantized to the same f32 values)
and differ only in summation order over K <= 11008."""
import dataclasses

import pytest
import torch

from repro_torch.core.bsr import pack_dense
from repro_torch.core.gqs_layer import GQSAConfig, pack_w4
from repro_torch.core.model_compress import pack_linear
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops
from repro_torch.kernels.gqsa_gemv import gqsa_gemv_cuda
from repro_torch.kernels.kv_decode_attention import kv_decode_attention_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.w4_matmul import plan as w4_plan
from repro_torch.kernels.w4_matmul import w4_matmul_cuda

pytestmark = pytest.mark.gpu
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(a, b):
    torch.cuda.synchronize()
    assert torch.isfinite(a).all()
    err = (a - b).abs().max().item()
    assert err <= TOL * b.abs().max().item(), err


GEMV_ROWS = (1, 4, 8, 9, 20, 64, 116)


@pytest.mark.parametrize("n,k", [(4096, 4096), (11008, 4096), (4096, 11008),
                                 (100, 48)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gqsa_gemv_kernel_matches_plain(cuda, n, k, dtype):
    """One launch a call at any row count (every token tile the launcher
    picks: 1, 2, 4, 8 rows)."""
    w = torch.randn((n, k), generator=cuda, device="cuda")
    bsr = pack_linear(w, GQSAConfig())
    for b in GEMV_ROWS:
        x = torch.randn((b, k), generator=cuda, device="cuda").to(dtype)
        before = gqsa_gemv_cuda.launches
        y = ops.gqsa_gemv(x, bsr)
        assert gqsa_gemv_cuda.launches - before == 1
        _close(y, ops.gqsa_gemv(x, bsr, plain=True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gqsa_gemv_kernel_at_yi_34b_wd(cuda, dtype):
    """yi-34b's wd (N = 7168, K = 20480), the widest K of a served config:
    8 bf16 rows (4 f32) do not fit a block, so the tile stops at 4 (2);
    one launch a call at every row count."""
    from repro_torch.kernels.gqsa_gemv import plan
    n, k = 7168, 20480
    bsr = pack_linear(torch.randn((n, k), generator=cuda, device="cuda")
                      / k ** 0.5, GQSAConfig())
    top = 4 if dtype == torch.bfloat16 else 2
    for b in GEMV_ROWS:
        x = torch.randn((b, k), generator=cuda, device="cuda").to(dtype)
        tile = plan(b, n, k, 16, x.element_size(), 132).tile
        assert tile == min(top, 1 << (b - 1).bit_length())
        before = gqsa_gemv_cuda.launches
        y = ops.gqsa_gemv(x, bsr)
        assert gqsa_gemv_cuda.launches - before == 1
        _close(y, ops.gqsa_gemv(x, bsr, plain=True))


def test_gqsa_gemv_kernel_ragged_rows(cuda):
    """-1 padding slots, an empty row and M = 17 (a ragged last lane
    trip), bf16 and f32 x at every row count."""
    w = torch.randn((300, 512), generator=cuda, device="cuda")
    mask = torch.rand((300, 32), generator=cuda, device="cuda") < 0.3
    mask[7] = False
    bsr = pack_dense(w, mask, QuantConfig(bits=4, group_size=16))
    assert bool((bsr.idx < 0).any())
    for b in GEMV_ROWS:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((b, 512), generator=cuda, device="cuda").to(dtype)
            _close(ops.gqsa_gemv(x, bsr), ops.gqsa_gemv(x, bsr, plain=True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gqsa_gemv_kernel_bit_identical(cuda, dtype):
    """Repeats are bit-identical, and a row of x gives the same bits
    whatever else the call holds: at T = 1, in a tile of 2, 4 or 8, or in
    a tile of a 116-row call; there is no split to vary."""
    from repro_torch.kernels.gqsa_gemv import plan
    bsr = pack_linear(torch.randn((4096, 11008), generator=cuda,
                                  device="cuda"), GQSAConfig())
    x = torch.randn((116, 11008), generator=cuda, device="cuda").to(dtype)
    y = ops.gqsa_gemv(x, bsr)
    assert torch.equal(y, ops.gqsa_gemv(x, bsr))
    tiles = set()
    for rows in (slice(5, 6), slice(6, 8), slice(8, 12), slice(16, 24),
                 slice(0, 20)):
        part = x[rows].contiguous()
        tiles.add(plan(part.shape[0], 4096, 11008, 16, part.element_size(),
                       132).tile)
        assert torch.equal(ops.gqsa_gemv(part, bsr), y[rows])
    assert len(tiles) >= 3


def test_gqsa_gemv_kernel_rejects_what_it_does_not_take(cuda):
    bsr = pack_linear(torch.randn((64, 128), device="cuda"), GQSAConfig())
    x = torch.randn((128, 4), device="cuda").T           # not contiguous
    with pytest.raises(ValueError):
        gqsa_gemv_cuda(x, bsr)
    with pytest.raises(ValueError):
        gqsa_gemv_cuda(torch.randn((0, 128), device="cuda"), bsr)
    with pytest.raises(TypeError):
        gqsa_gemv_cuda(torch.randn((2, 128), device="cuda").half(), bsr)


@pytest.mark.parametrize("t", [1, 4, 8, 116])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gqsa_gemv_launcher_takes_only_its_shared_memory_count(cuda, t,
                                                              dtype):
    """The wrapper's count of a block's shared memory is the launcher's
    own at every tile and group size (the launch goes through); one
    16-byte line more or less is refused (cudaErrorInvalidValue) before
    anything launches, and so is the count of another group size."""
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.gqsa_gemv import (GROUP_SIZES, _launcher, plan,
                                               smem_bytes)
    n, k = 4096, 11008
    w = torch.randn((n, k), generator=cuda, device="cuda")
    x = torch.randn((t, k), generator=cuda, device="cuda").to(dtype)
    for g in GROUP_SIZES:
        bsr = pack_linear(w, _gqsa(g))
        _close(gqsa_gemv_cuda(x, bsr), ops.gqsa_gemv(x, bsr, plain=True))
        p = plan(t, n, k, g, x.element_size(), sm_count(0))
        y = torch.empty((t, n), device="cuda")
        m = bsr.idx.shape[1]
        other = 8 if g != 8 else 32
        for smem in (smem_bytes(p.tile, k, g, x.element_size()) - 16,
                     smem_bytes(p.tile, k, g, x.element_size()) + 16,
                     smem_bytes(p.tile, k, other, x.element_size())):
            rc = _launcher()(x.data_ptr(), int(dtype == torch.bfloat16),
                             bsr.idx.data_ptr(), bsr.vals.data_ptr(),
                             bsr.scale.data_ptr(), bsr.zero.data_ptr(),
                             y.data_ptr(), t, n, m, k, g, p.tile, p.tiles,
                             p.blocks, smem,
                             torch.cuda.current_stream().cuda_stream)
            assert rc == 1, rc


def _gqsa(g):
    """GQSA W4 S50 at group size ``g``."""
    from repro_torch.core.pruning import PruneConfig
    return GQSAConfig(quant=QuantConfig(bits=4, group_size=g),
                      prune=PruneConfig(sparsity=0.5, group_size=g))


@pytest.mark.parametrize("n,k", [(4096, 4096), (11008, 4096), (4096, 11008),
                                 (100, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g", [8, 32])
def test_gqsa_gemv_kernel_matches_plain_at_group_sizes(cuda, g, n, k, dtype):
    """g = 8 and 32 at the llama2-7b shapes and a small one: one launch a
    call at every row count (every token tile, and wd at g = 8, where 8
    bf16 rows do not fit a block and the tile stays 4)."""
    w = torch.randn((n, k), generator=cuda, device="cuda")
    bsr = pack_linear(w, _gqsa(g))
    assert bsr.group_size == g and bsr.vals.shape[-1] == g // 2
    for b in GEMV_ROWS:
        x = torch.randn((b, k), generator=cuda, device="cuda").to(dtype)
        before = gqsa_gemv_cuda.launches
        y = ops.gqsa_gemv(x, bsr)
        assert gqsa_gemv_cuda.launches - before == 1
        _close(y, ops.gqsa_gemv(x, bsr, plain=True))


@pytest.mark.parametrize("g", [8, 32])
def test_gqsa_gemv_kernel_ragged_rows_at_group_sizes(cuda, g):
    """-1 padding slots, an empty row and ragged last lane trips at g = 8
    and 32, bf16 and f32 x at every row count."""
    w = torch.randn((300, 512), generator=cuda, device="cuda")
    mask = torch.rand((300, 512 // g), generator=cuda, device="cuda") < 0.3
    mask[7] = False
    bsr = pack_dense(w, mask, QuantConfig(bits=4, group_size=g))
    assert bool((bsr.idx < 0).any())
    for b in GEMV_ROWS:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((b, 512), generator=cuda, device="cuda").to(dtype)
            _close(ops.gqsa_gemv(x, bsr), ops.gqsa_gemv(x, bsr, plain=True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g", [8, 32])
def test_gqsa_gemv_kernel_bit_identical_at_group_sizes(cuda, g, dtype):
    """At g = 8 and 32, repeats are bit-identical and a row of x gives the
    same bits at T = 1, in a tile of 2, 4 or 8, or in a 116-row call."""
    from repro_torch.kernels.gqsa_gemv import plan
    bsr = pack_linear(torch.randn((4096, 4096), generator=cuda,
                                  device="cuda"), _gqsa(g))
    x = torch.randn((116, 4096), generator=cuda, device="cuda").to(dtype)
    y = ops.gqsa_gemv(x, bsr)
    assert torch.equal(y, ops.gqsa_gemv(x, bsr))
    tiles = set()
    for rows in (slice(5, 6), slice(6, 8), slice(8, 12), slice(16, 24),
                 slice(0, 20)):
        part = x[rows].contiguous()
        tiles.add(plan(part.shape[0], 4096, 4096, g, part.element_size(),
                       132).tile)
        assert torch.equal(ops.gqsa_gemv(part, bsr), y[rows])
    assert len(tiles) >= 3


def test_gqsa_gemv_kernel_refuses_other_group_sizes(cuda):
    """g = 256 (which the reference takes) raises, naming ROADMAP.md, on
    one matrix and on the expert axis, before anything launches; nothing
    goes to the plain version. The launcher itself refuses g = 256 and
    4."""
    from repro_torch.kernels.gqsa_gemv import (_launcher,
                                               gqsa_gemv_experts_cuda)
    bsr = pack_linear(torch.randn((64, 512), generator=cuda, device="cuda"),
                      _gqsa(256))
    x = torch.randn((4, 512), generator=cuda, device="cuda")
    before = (gqsa_gemv_cuda.launches, gqsa_gemv_experts_cuda.launches)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ops.gqsa_gemv(x, bsr)
    stacked = dataclasses.replace(
        bsr, **{f: getattr(bsr, f)[None] for f in ("idx", "vals", "scale",
                                                   "zero")})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ops.gqsa_gemv_experts(x[None], stacked, None)
    assert (gqsa_gemv_cuda.launches,
            gqsa_gemv_experts_cuda.launches) == before
    y = torch.empty((4, 64), device="cuda")
    for g in (256, 4):
        rc = _launcher()(x.data_ptr(), 0, bsr.idx.data_ptr(),
                         bsr.vals.data_ptr(), bsr.scale.data_ptr(),
                         bsr.zero.data_ptr(), y.data_ptr(), 4, 64,
                         bsr.idx.shape[1], 512, g, 4, 1, 1, 0,
                         torch.cuda.current_stream().cuda_stream)
        assert rc == 1, rc
        assert rc == 1, rc


def _attn_case(cuda, t, kh, r, d, dtype):
    b, ps, mp = 5, 16, 6
    num_pages = b * mp + 3
    q = torch.randn((b, t, kh * r, d), generator=cuda, device="cuda")
    if dtype == torch.int8:
        kp, vp = (torch.randint(-127, 128, (num_pages, ps, kh, d),
                                generator=cuda, device="cuda",
                                dtype=torch.int8) for _ in range(2))
    else:
        kp = torch.randn((num_pages, ps, kh, d), generator=cuda,
                         device="cuda").to(dtype)
        vp = torch.randn_like(kp, dtype=torch.float32).to(dtype)
    perm = torch.randperm(num_pages, generator=cuda, device="cuda")
    bt = perm[:b * mp].reshape(b, mp).to(torch.int32)
    bt[:, 4:] = num_pages                     # sentinel tails
    bt[3] = num_pages                         # all-sentinel slot
    lens = torch.tensor([1, 30, 64 - t, 0, 17], device="cuda")[:, None] \
        + torch.arange(t, device="cuda")[None, :]
    lens[3] = 0
    lens[4, 0] = 0                            # a length-0 row
    return q, kp, vp, lens.to(torch.int32), bt


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kh,r,d", [(32, 1, 128), (4, 2, 64), (8, 7, 128),
                                    (2, 12, 128)])
def test_paged_attention_kernel_matches_plain(cuda, t, dtype, kh, r, d):
    q, kp, vp, lens, bt = _attn_case(cuda, t, kh, r, d, dtype)
    before = paged_attention_cuda.launches
    o = ops.paged_decode_attention(q, kp, vp, lens, bt)
    assert paged_attention_cuda.launches == before + 1
    ref = ops.paged_decode_attention(q, kp, vp, lens, bt, plain=True)
    _close(o, ref)
    assert (o[3] == 0).all() and (o[4, 0] == 0).all()


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("kh,r,d", [(32, 1, 128), (4, 2, 64), (8, 7, 128),
                                    (2, 12, 128)])
def test_paged_attention_kernel_int8_matches_plain(cuda, t, kh, r, d):
    """int8 mode: random codes with positive per-token scales."""
    q, kp, vp, lens, bt = _attn_case(cuda, t, kh, r, d, torch.int8)
    ks, vs = (torch.rand(kp.shape[:3], generator=cuda, device="cuda") / 64
              + 1e-3 for _ in range(2))
    plain, int8 = (paged_attention_cuda.launches,
                   paged_attention_cuda.int8_launches)
    o = ops.paged_decode_attention(q, kp, vp, lens, bt, ks, vs)
    assert paged_attention_cuda.int8_launches == int8 + 1
    assert paged_attention_cuda.launches == plain
    ref = ops.paged_decode_attention(q, kp, vp, lens, bt, ks, vs,
                                     plain=True)
    _close(o, ref)
    assert (o[3] == 0).all() and (o[4, 0] == 0).all()


@pytest.mark.parametrize("t", [20, 9])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_paged_attention_kernel_rows_above_one_group(cuda, t, dtype):
    """Plain and int8 modes past 8 rows: T*R = 40 rows take two 32-row
    groups, 18 rows one."""
    q, kp, vp, lens, bt = _attn_case(cuda, t, 4, 2, 64, dtype)
    sc = ()
    if dtype == torch.int8:
        sc = tuple(torch.rand(kp.shape[:3], generator=cuda, device="cuda")
                   / 64 + 1e-3 for _ in range(2))
    o = ops.paged_decode_attention(q, kp, vp, lens, bt, *sc)
    _close(o, ops.paged_decode_attention(q, kp, vp, lens, bt, *sc,
                                         plain=True))
    assert (o[3] == 0).all() and (o[4, 0] == 0).all()


@pytest.mark.parametrize("t,window", [(2, 2), (5, 5), (29, 29), (31, 31),
                                      (5, 13), (13, 5), (4, 0)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
@pytest.mark.parametrize("kh,r,d", [(32, 1, 128), (4, 2, 64), (8, 7, 128),
                                    (2, 12, 128)])
def test_paged_attention_kernel_tree_matches_plain(cuda, t, window, dtype,
                                                   kh, r, d):
    """Tree mode: random ancestor bitmaps over a fed window equal to T, as
    wide as a draft level's (window > T), narrower than T and empty;
    lengths base + window as the model sets them, slot 3 all-sentinel with
    length 0 and a length-0 row in slot 4."""
    q, kp, vp, lens, bt = _attn_case(cuda, t, kh, r, d, dtype)
    sc = ()
    if dtype == torch.int8:
        sc = tuple(torch.rand(kp.shape[:3], generator=cuda, device="cuda")
                   / 64 + 1e-3 for _ in range(2))
    base = torch.tensor([0, 11, 64 - max(t, window), 0, 30],
                        dtype=torch.int32, device="cuda")
    lens = (base + window)[:, None].expand(-1, t).contiguous()
    lens[3] = 0
    lens[4, 0] = 0
    anc = torch.randint(0, 2 ** 31 - 1, (5, t), generator=cuda,
                        device="cuda", dtype=torch.int32)
    before = (paged_attention_cuda.launches,
              paged_attention_cuda.int8_launches,
              paged_attention_cuda.tree_launches)
    o = ops.paged_decode_attention(q, kp, vp, lens, bt, *sc, anc=anc,
                                   anc_base=base, anc_window=window)
    assert (paged_attention_cuda.launches,
            paged_attention_cuda.int8_launches,
            paged_attention_cuda.tree_launches) == (before[0], before[1],
                                                    before[2] + 1)
    ref = ops.paged_decode_attention(q, kp, vp, lens, bt, *sc, anc=anc,
                                     anc_base=base, anc_window=window,
                                     plain=True)
    _close(o, ref)
    assert (o[3] == 0).all() and (o[4, 0] == 0).all()


def test_paged_attention_kernel_tree_of_prefix_bitmaps_is_the_staircase(
        cuda):
    """A chain's bitmaps (prefixes of ones) over the window give exactly
    the staircase's result."""
    t = 5
    q, kp, vp, lens, bt = _attn_case(cuda, t, 4, 2, 64, torch.float32)
    base = lens[:, 0] - 1
    anc = ((1 << (torch.arange(t, device="cuda") + 1)) - 1).to(torch.int32)
    o = ops.paged_decode_attention(q, kp, vp, (base + t)[:, None]
                                   .expand(-1, t).contiguous(), bt,
                                   anc=anc[None].expand(5, t),
                                   anc_base=base.clamp_min(0), anc_window=t)
    live = [0, 1, 2]
    _close(o[live], ops.paged_decode_attention(q, kp, vp, lens, bt)[live])


def _w4(cuda, n, k, g):
    w = torch.randn((n, k), generator=cuda, device="cuda") / k ** 0.5
    return pack_w4(w, QuantConfig(bits=4, group_size=g))


@pytest.mark.parametrize("n,k,g", [(4096, 4096, 16), (11008, 4096, 16),
                                   (4096, 11008, 16), (300, 512, 128),
                                   (100, 48, 16), (37, 96, 6)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w4_matmul_kernel_matches_plain(cuda, n, k, g, dtype):
    """Full-width shapes, a G128 case, and K that is not a multiple of 64
    (the byte-load path); T past one 8-row tile and ragged N."""
    p = _w4(cuda, n, k, g)
    for t in (1, 4, 5, 8, 13, 200):
        x = torch.randn((t, k), generator=cuda, device="cuda").to(dtype)
        before = w4_matmul_cuda.launches
        y = ops.w4_matmul(x, p["qw"], p["scale"], p["zero"], group_size=g)
        assert w4_matmul_cuda.launches == before + 1
        assert y.shape == (t, n) and y.dtype == torch.float32
        _close(y, ops.w4_matmul(x, p["qw"], p["scale"], p["zero"],
                                group_size=g, plain=True))


def test_w4_matmul_kernel_misaligned_codes(cuda):
    """qw that is not 16-byte aligned takes the byte-load path."""
    p = _w4(cuda, 64, 256, 16)
    buf = torch.empty(64 * 128 + 1, dtype=torch.uint8, device="cuda")
    qw = buf[1:].view(64, 128)
    qw.copy_(p["qw"])
    x = torch.randn((3, 256), generator=cuda, device="cuda")
    _close(ops.w4_matmul(x, qw, p["scale"], p["zero"], group_size=16),
           ops.w4_matmul(x, p["qw"], p["scale"], p["zero"], group_size=16,
                         plain=True))


def test_w4_matmul_kernel_rejects_what_it_does_not_take(cuda):
    p = _w4(cuda, 64, 128, 16)
    args = (p["qw"], p["scale"], p["zero"], 16)
    before = w4_matmul_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        w4_matmul_cuda(torch.randn((2, 128)), *args)
    with pytest.raises(ValueError, match="contiguous"):
        w4_matmul_cuda(torch.randn((128, 4), device="cuda").T, *args)
    with pytest.raises(TypeError):
        w4_matmul_cuda(torch.randn((2, 128), device="cuda").half(), *args)
    with pytest.raises(ValueError, match="group size"):
        w4_matmul_cuda(torch.randn((2, 128), device="cuda"), p["qw"],
                       p["scale"], p["zero"], 7)
    with pytest.raises(ValueError, match="shape"):
        w4_matmul_cuda(torch.randn((2, 64), device="cuda"), *args)
    assert w4_matmul_cuda.launches == before


W4_FULL = [(4096, 4096), (11008, 4096), (4096, 11008)]


@pytest.mark.parametrize("n,k", W4_FULL)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w4_matmul_tensor_cores_match_plain(cuda, n, k, dtype):
    """The llama2-7b projections at G16 take the tensor-core path, from
    decode rows to prefill tiles past one block's 64 x rows (f32 x as
    bf16 hi + lo: within a few 1e-6 of the f32 plain version)."""
    p = _w4(cuda, n, k, 16)
    args = (p["qw"], p["scale"], p["zero"])
    for t in (1, 2, 3, 4, 8, 16, 64, 200):
        x = torch.randn((t, k), generator=cuda, device="cuda").to(dtype)
        assert w4_plan(x, *args, 16)[0] == "tc"
        before = w4_matmul_cuda.tc_launches
        y = ops.w4_matmul(x, *args, group_size=16)
        assert w4_matmul_cuda.tc_launches == before + 1
        assert y.shape == (t, n) and y.dtype == torch.float32
        _close(y, ops.w4_matmul(x, *args, group_size=16, plain=True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w4_matmul_tensor_cores_bit_identical(cuda, dtype):
    """Split K is added in split order by whichever block comes last, so
    two launches give the same bits."""
    for n, k in W4_FULL:
        p = _w4(cuda, n, k, 16)
        args = (p["qw"], p["scale"], p["zero"], 16)
        for t in (4, 64):
            x = torch.randn((t, k), generator=cuda, device="cuda").to(dtype)
            assert torch.equal(w4_matmul_cuda(x, *args),
                               w4_matmul_cuda(x, *args))


@pytest.mark.parametrize("n,k,splits", [
    (4096, 4096, range(1, 33)), (4096, 11008, (1, 2, 3, 7, 8, 43, 86)),
    (11008, 4096, (1, 2, 3, 4, 32))])
def test_w4_matmul_tensor_cores_every_split_count(cuda, n, k, splits):
    """Every split count the launcher may choose (1 .. K/128; all of them
    at K = 4096), at decode and prefill rows, against the plain version
    and bit-identical on a repeat."""
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.w4_matmul import split_count
    p = _w4(cuda, n, k, 16)
    args = (p["qw"], p["scale"], p["zero"], 16)
    for t in (4, 64):
        x = torch.randn((t, k), generator=cuda,
                        device="cuda").to(torch.bfloat16)
        ref = ops.w4_matmul(x, *args[:3], group_size=16, plain=True)
        chosen = split_count(t, n, k, sm_count(0))
        for s in sorted({chosen, *splits}):
            y = w4_matmul_cuda(x, *args, n_split=s)
            _close(y, ref)
            assert torch.equal(y, w4_matmul_cuda(x, *args, n_split=s))
    with pytest.raises(ValueError, match="n_split"):
        w4_matmul_cuda(x, *args, n_split=k // 128 + 1)


def test_w4_matmul_routes_by_shape(cuda):
    """G = 6, K = 48, G = 256 and misaligned codes go to the CUDA-core
    path, by shape; G in {16, 32, 64, 128} with K a multiple of 128 to the
    tensor cores. Both paths match the plain version."""
    buf = torch.empty(64 * 128 + 1, dtype=torch.uint8, device="cuda")
    cases = [(37, 96, 6, "simt", None), (100, 48, 16, "simt", None),
             (64, 512, 256, "simt", None), (64, 256, 16, "simt", buf),
             (4096, 4096, 16, "tc", None), (300, 512, 128, "tc", None),
             (70, 256, 32, "tc", None), (70, 256, 64, "tc", None)]
    for n, k, g, path, misaligned in cases:
        p = _w4(cuda, n, k, g)
        qw = p["qw"]
        if misaligned is not None:
            qw = misaligned[1:].view(n, k // 2)
            qw.copy_(p["qw"])
        x = torch.randn((5, k), generator=cuda, device="cuda")
        assert w4_plan(x, qw, p["scale"], p["zero"], g)[0] == path
        before = (w4_matmul_cuda.launches, w4_matmul_cuda.tc_launches)
        y = ops.w4_matmul(x, qw, p["scale"], p["zero"], group_size=g)
        assert w4_matmul_cuda.launches == before[0] + 1
        assert w4_matmul_cuda.tc_launches == before[1] + (path == "tc")
        _close(y, ops.w4_matmul(x, p["qw"], p["scale"], p["zero"],
                                group_size=g, plain=True))
    p = _w4(cuda, 37, 96, 6)
    with pytest.raises(ValueError, match="n_split"):
        w4_matmul_cuda(torch.randn((2, 96), device="cuda"), p["qw"],
                       p["scale"], p["zero"], 6, n_split=2)


def _w4_experts(cuda, e, n, k, g=16):
    """E experts of dense W4 stacked [E, ...], packed one at a time."""
    from repro_torch.core.model_compress import StackedPacker, slice_packer
    packer = StackedPacker(e, slice_packer(QuantConfig(bits=4,
                                                       group_size=g)))
    for i in range(e):
        packer.put(i, torch.randn((n, k), generator=cuda, device="cuda")
                   / k ** 0.5)
    return packer.result((e,))


def _w4_experts_call(x, p, rows, g=16, plain=False):
    return ops.w4_matmul_experts(x, p["qw"], p["scale"], p["zero"], rows,
                                 group_size=g, plain=plain)


W4_EXPERT_SHAPES = [(64, 1408, 2048), (64, 2048, 1408), (160, 1536, 5120),
                    (160, 5120, 1536)]


@pytest.mark.parametrize("e,n,k", W4_EXPERT_SHAPES + [(8, 96, 64),
                                                      (5, 300, 512)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w4_matmul_experts_kernel_matches_plain(cuda, e, n, k, dtype):
    """The expert axis at the deepseek-moe-16b and DeepSeek-V2 expert
    shapes and two small ones: C = 1, 3, 8, 20 and 70 buffer rows in one
    launch, with ``rows`` absent and given (idle experts, partly filled
    and full buffers): rows at or past rows[e] are exact zeros."""
    from repro_torch.kernels.w4_matmul import w4_matmul_experts_cuda
    p = _w4_experts(cuda, e, n, k)
    for c in (1, 3, 8, 20, 70):
        x = torch.randn((e, c, k), generator=cuda, device="cuda").to(dtype)
        rows = torch.randint(0, c + 1, (e,), generator=cuda, device="cuda",
                             dtype=torch.int32)
        rows[:2] = 0
        rows[2] = c
        for r in (None, rows):
            before = w4_matmul_experts_cuda.launches
            y = _w4_experts_call(x, p, r)
            assert w4_matmul_experts_cuda.launches == before + 1
            assert y.shape == (e, c, n) and y.dtype == torch.float32
            _close(y, _w4_experts_call(x, p, r, plain=True))
            if r is not None:
                idle = torch.arange(c, device="cuda")[None, :] >= r[:, None]
                assert (y[idle] == 0).all()


@pytest.mark.parametrize("e,n,k,g", [(64, 1408, 2048, 16),
                                     (5, 100, 48, 16)])
def test_w4_matmul_experts_never_reads_an_idle_expert(cuda, e, n, k, g):
    """Idle experts' scales are NaN and x is NaN past every expert's
    rows: the output stays finite (nothing idle was read), idle rows are
    exact zeros, and the live rows match the plain version on the clean
    operands. On both paths (tensor cores, then CUDA cores)."""
    p = _w4_experts(cuda, e, n, k, g)
    for c in (1, 3, 20):
        x = torch.randn((e, c, k), generator=cuda, device="cuda")
        rows = torch.randint(0, c + 1, (e,), generator=cuda, device="cuda",
                             dtype=torch.int32)
        rows[:e // 2] = 0
        rows[-1] = c
        ref = _w4_experts_call(x, p, rows, g, plain=True)
        idle = torch.arange(c, device="cuda")[None, :] >= rows[:, None]
        poisoned = dict(p, scale=p["scale"].clone())
        poisoned["scale"][rows == 0] = float("nan")
        xp = x.clone()
        xp[idle] = float("nan")
        y = _w4_experts_call(xp, poisoned, rows, g)
        assert torch.isfinite(y).all()
        assert (y[idle] == 0).all()
        _close(y, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w4_matmul_experts_bit_identical(cuda, dtype):
    """No split of K: a repeat gives the same bits, and an expert's rows
    give the same bits whatever the other experts hold."""
    e, n, k = W4_EXPERT_SHAPES[0]
    p = _w4_experts(cuda, e, n, k)
    for c in (1, 8, 70):
        x = torch.randn((e, c, k), generator=cuda, device="cuda").to(dtype)
        rows = torch.randint(0, c + 1, (e,), generator=cuda, device="cuda",
                             dtype=torch.int32)
        y = _w4_experts_call(x, p, rows)
        assert torch.equal(y, _w4_experts_call(x, p, rows))
        other = x.clone()
        other[1:] = torch.randn_like(other[1:])
        assert torch.equal(y[0], _w4_experts_call(other, p, rows)[0])


def test_w4_matmul_experts_routes_by_shape(cuda):
    """The expert axis routes as ``w4_matmul`` does: G = 6, K = 48,
    G = 256 and misaligned codes to the CUDA-core path, G in {16, 32, 64,
    128} with K a multiple of 128 to the tensor cores; both match the
    plain version, with ``rows`` too."""
    from repro_torch.kernels.w4_matmul import w4_matmul_experts_cuda
    cases = [(3, 37, 96, 6, "simt", False), (3, 100, 48, 16, "simt", False),
             (3, 64, 512, 256, "simt", False), (3, 64, 256, 16, "simt", True),
             (3, 1408, 2048, 16, "tc", False), (3, 300, 512, 128, "tc", False),
             (3, 70, 256, 32, "tc", False), (3, 70, 256, 64, "tc", False)]
    for e, n, k, g, path, misaligned in cases:
        p = _w4_experts(cuda, e, n, k, g)
        qw = p["qw"]
        if misaligned:
            buf = torch.empty(qw.numel() + 1, dtype=torch.uint8,
                              device="cuda")
            qw = buf[1:].view(qw.shape)
            qw.copy_(p["qw"])
        x = torch.randn((e, 5, k), generator=cuda, device="cuda")
        rows = torch.tensor([0, 2, 5], dtype=torch.int32, device="cuda")
        for r in (None, rows):
            before = (w4_matmul_experts_cuda.launches,
                      w4_matmul_experts_cuda.tc_launches)
            y = ops.w4_matmul_experts(x, qw, p["scale"], p["zero"], r,
                                      group_size=g)
            assert w4_matmul_experts_cuda.launches == before[0] + 1
            assert (w4_matmul_experts_cuda.tc_launches
                    == before[1] + (path == "tc"))
            _close(y, _w4_experts_call(x, p, r, g, plain=True))


def test_w4_matmul_experts_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.w4_matmul import w4_matmul_experts_cuda
    p = _w4_experts(cuda, 3, 64, 128)
    args = (p["qw"], p["scale"], p["zero"])
    before = w4_matmul_experts_cuda.launches
    x = torch.randn((3, 2, 128), device="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        w4_matmul_experts_cuda(x.cpu(), *args, None, 16)
    with pytest.raises(ValueError, match="x \\[E, C, K\\]"):
        w4_matmul_experts_cuda(x[0], *args, None, 16)
    with pytest.raises(ValueError, match="shape"):
        w4_matmul_experts_cuda(x[:2], *args, None, 16)
    with pytest.raises(TypeError, match="rows"):
        w4_matmul_experts_cuda(x, *args, torch.ones(3, device="cuda"), 16)
    with pytest.raises(ValueError, match="contiguous"):
        w4_matmul_experts_cuda(x.transpose(0, 1).contiguous()
                               .transpose(0, 1), *args, None, 16)
    assert w4_matmul_experts_cuda.launches == before


def _latent_case(cuda, b, t, h, d, dtype, ps=16, mp=16):
    """Latent pool over a shuffled table with sentinel tails; slot 1 is
    all-sentinel with length 0 when b > 2, and a length-0 row sits in the
    last slot."""
    num_pages = b * mp + 3
    q = torch.randn((b, t, h, d), generator=cuda, device="cuda")
    lat = torch.randn((num_pages, ps, d), generator=cuda,
                      device="cuda").to(dtype)
    perm = torch.randperm(num_pages, generator=cuda, device="cuda")
    bt = perm[:b * mp].reshape(b, mp).to(torch.int32)
    bt[:, mp - 2:] = num_pages
    lens = torch.tensor([37, 0, 200, 256 - t - 2 * ps][:b], device="cuda")
    lens = lens[:, None] + torch.arange(t, device="cuda")[None, :]
    if b > 2:
        bt[1] = num_pages
        lens[1] = 0
    lens[-1, 0] = 0
    return q, lat, lens.to(torch.int32), bt


@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,d,v_rank", [(128, 576, 512), (4, 40, 32),
                                        (4, 160, 140)])
def test_paged_attention_kernel_latent_matches_plain(cuda, t, dtype, h, d,
                                                     v_rank):
    """Latent mode: one KV head of D = 576 (DeepSeek-V2: 128 rows per
    decode token, 8 row groups, over 48 KB of shared memory), value = the
    leading 512 dims; small and ragged widths too."""
    q, lat, lens, bt = _latent_case(cuda, 4, t, h, d, dtype)
    before = (paged_attention_cuda.launches,
              paged_attention_cuda.tree_launches,
              paged_attention_cuda.latent_launches)
    o = ops.paged_latent_attention(q, lat, lens, bt, v_rank=v_rank)
    assert (paged_attention_cuda.launches,
            paged_attention_cuda.tree_launches,
            paged_attention_cuda.latent_launches) == (before[0], before[1],
                                                      before[2] + 1)
    assert o.shape == (4, t, h, v_rank) and o.dtype == torch.float32
    ref = ops.paged_latent_attention(q, lat, lens, bt, v_rank=v_rank,
                                     plain=True)
    _close(o, ref)
    assert (o[1] == 0).all() and (o[3, 0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_kernel_latent_tree_matches_plain(cuda, dtype):
    """The latent mode takes the tree mode's operands, as the reference
    kernel does: random bitmaps over a (4,2,2)-verify-wide window."""
    t = 29
    q, lat, _, bt = _latent_case(cuda, 4, t, 8, 576, dtype)
    base = torch.tensor([3, 0, 100, 160], dtype=torch.int32, device="cuda")
    lens = (base + t)[:, None].expand(-1, t).contiguous()
    lens[1] = 0
    anc = torch.randint(0, 2 ** 31 - 1, (4, t), generator=cuda,
                        device="cuda", dtype=torch.int32)
    kw = dict(v_rank=512, anc=anc, anc_base=base, anc_window=t)
    o = ops.paged_latent_attention(q, lat, lens, bt, **kw)
    _close(o, ops.paged_latent_attention(q, lat, lens, bt, plain=True,
                                         **kw))
    assert (o[1] == 0).all()


def test_paged_attention_kernel_latent_refuses_int8(cuda):
    q, lat, lens, bt = _latent_case(cuda, 2, 1, 4, 64, torch.float32)
    with pytest.raises(NotImplementedError, match="int8"):
        ops.paged_latent_attention(q, lat.to(torch.int8), lens, bt,
                                   v_rank=32)


def _experts(cuda, e, n, k, g=16):
    from repro_torch.core.model_compress import StackedPacker, slice_packer
    packer = StackedPacker(e, slice_packer(_gqsa(g)))
    for i in range(e):
        packer.put(i, torch.randn((n, k), generator=cuda, device="cuda")
                   / k ** 0.5)
    return packer.result((e,))["bsr"]


GQSA_EXPERT_SHAPES = [(160, 5120, 1536), (160, 1536, 5120), (64, 1408, 2048),
                      (64, 2048, 1408)]


def _occupancy(cuda, e, c):
    """rows [E]: random in 0..C, the first two experts idle, the third
    full, a third of the rest idle."""
    rows = torch.randint(0, c + 1, (e,), generator=cuda, device="cuda",
                         dtype=torch.int32)
    rows[:2] = 0
    rows[2] = c
    rows[3:3 + e // 3] = 0
    return rows


@pytest.mark.parametrize("e,n,k", GQSA_EXPERT_SHAPES + [(8, 96, 64),
                                                        (5, 300, 512)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gqsa_gemv_experts_kernel_matches_plain(cuda, e, n, k, dtype):
    """The expert axis at the DeepSeek-V2 and deepseek-moe-16b expert
    shapes and two small ones: C = 1, 3, 9, 13 and 30 buffer rows, each in
    one launch, with ``rows`` absent and given (idle experts and partly
    filled buffers): rows at or past rows[e] are exact zeros."""
    from repro_torch.kernels.gqsa_gemv import gqsa_gemv_experts_cuda
    bsr = _experts(cuda, e, n, k)
    for c in (1, 3, 9, 13, 30):
        x = torch.randn((e, c, k), generator=cuda, device="cuda").to(dtype)
        rows = _occupancy(cuda, e, c)
        for r in (None, rows):
            before = gqsa_gemv_experts_cuda.launches
            y = ops.gqsa_gemv_experts(x, bsr, r)
            assert gqsa_gemv_experts_cuda.launches - before == 1
            assert y.shape == (e, c, n) and y.dtype == torch.float32
            _close(y, ops.gqsa_gemv_experts(x, bsr, r, plain=True))
            if r is not None:
                idle = torch.arange(c, device="cuda")[None, :] >= r[:, None]
                assert (y[idle] == 0).all()


@pytest.mark.parametrize("e,n,k", [(64, 2048, 1408), (160, 1536, 5120),
                                   (5, 300, 512)])
def test_gqsa_gemv_experts_never_reads_an_idle_expert(cuda, e, n, k):
    """Idle experts' scales are NaN and x is NaN past every expert's
    rows: the output stays finite (nothing idle was read), idle rows are
    exact zeros, and the live rows match the plain version on the clean
    operands."""
    import dataclasses
    bsr = _experts(cuda, e, n, k)
    for c in (1, 3, 9, 30):
        x = torch.randn((e, c, k), generator=cuda, device="cuda")
        rows = _occupancy(cuda, e, c)
        ref = ops.gqsa_gemv_experts(x, bsr, rows, plain=True)
        idle = torch.arange(c, device="cuda")[None, :] >= rows[:, None]
        poisoned = dataclasses.replace(bsr, scale=bsr.scale.clone())
        poisoned.scale[rows == 0] = float("nan")
        xp = x.clone()
        xp[idle] = float("nan")
        y = ops.gqsa_gemv_experts(xp, poisoned, rows)
        assert torch.isfinite(y).all()
        assert (y[idle] == 0).all()
        _close(y, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gqsa_gemv_experts_bit_identical(cuda, dtype):
    """A repeat gives the same bits, and an expert's rows give the same
    bits whatever the other experts hold and however many of them are
    occupied (which moves every block's share of the work)."""
    e, n, k = GQSA_EXPERT_SHAPES[2]
    bsr = _experts(cuda, e, n, k)
    for c in (1, 8, 30):
        x = torch.randn((e, c, k), generator=cuda, device="cuda").to(dtype)
        rows = _occupancy(cuda, e, c)
        rows[0] = c
        y = ops.gqsa_gemv_experts(x, bsr, rows)
        assert torch.equal(y, ops.gqsa_gemv_experts(x, bsr, rows))
        other = x.clone()
        other[1:] = torch.randn_like(other[1:])
        others = rows.clone()
        others[1:] = torch.randint(0, c + 1, (e - 1,), generator=cuda,
                                   device="cuda", dtype=torch.int32)
        assert torch.equal(y[0], ops.gqsa_gemv_experts(other, bsr,
                                                       others)[0])
        assert torch.equal(y[0], ops.gqsa_gemv_experts(x, bsr, None)[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gqsa_gemv_experts_both_row_layouts(cuda, dtype):
    """The launcher at 16 lanes a row (two rows a warp) and at 32, whatever
    M the plan would pick them for (K = 640: M = 20 at g = 16, 40 at g =
    8, 10 at g = 32): both match the plain version, with ``rows``, at C =
    1, 3 and 9, at every group size."""
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.gqsa_gemv import (GROUP_SIZES,
                                               _experts_launcher,
                                               experts_plan)
    e, n, k = 6, 200, 640
    for g in GROUP_SIZES:
        bsr = _experts(cuda, e, n, k, g)
        m = bsr.idx.shape[-1]
        for c in (1, 3, 9):
            x = torch.randn((e, c, k), generator=cuda,
                            device="cuda").to(dtype)
            rows = _occupancy(cuda, e, c)
            ref = ops.gqsa_gemv_experts(x, bsr, rows, plain=True)
            p = experts_plan(e, c, n, m, k, g, x.element_size(),
                             sm_count(0))
            for lanes in (16, 32):
                y = torch.full((e, c, n), float("nan"), device="cuda")
                rc = _experts_launcher()(
                    x.data_ptr(), int(dtype == torch.bfloat16),
                    bsr.idx.data_ptr(), bsr.vals.data_ptr(),
                    bsr.scale.data_ptr(), bsr.zero.data_ptr(), y.data_ptr(),
                    rows.data_ptr(), e, c, n, m, k, g, p.tile, lanes,
                    p.blocks, p.smem, torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc
                _close(y, ref)


@pytest.mark.parametrize("e,n,k", GQSA_EXPERT_SHAPES + [(5, 300, 512)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g", [8, 32])
def test_gqsa_gemv_experts_at_group_sizes(cuda, g, e, n, k, dtype):
    """The expert axis at g = 8 and 32, at the DeepSeek-V2 and
    deepseek-moe-16b expert shapes and a small one: C = 1, 3, 13 and 30,
    one launch a call, ``rows`` absent and given (idle rows exact zeros),
    a repeat bit-identical; then NaN in the idle experts' scales and in x
    past every expert's rows leaves the output equal to the plain
    version's on the clean operands (nothing idle is read)."""
    from repro_torch.kernels.gqsa_gemv import gqsa_gemv_experts_cuda
    bsr = _experts(cuda, e, n, k, g)
    assert bsr.group_size == g
    for c in (1, 3, 13, 30):
        x = torch.randn((e, c, k), generator=cuda, device="cuda").to(dtype)
        rows = _occupancy(cuda, e, c)
        idle = torch.arange(c, device="cuda")[None, :] >= rows[:, None]
        for r in (None, rows):
            before = gqsa_gemv_experts_cuda.launches
            y = ops.gqsa_gemv_experts(x, bsr, r)
            assert gqsa_gemv_experts_cuda.launches - before == 1
            assert y.shape == (e, c, n) and y.dtype == torch.float32
            assert torch.equal(y, ops.gqsa_gemv_experts(x, bsr, r))
            _close(y, ops.gqsa_gemv_experts(x, bsr, r, plain=True))
            if r is not None:
                assert (y[idle] == 0).all()
        ref = ops.gqsa_gemv_experts(x, bsr, rows, plain=True)
        poisoned = dataclasses.replace(bsr, scale=bsr.scale.clone())
        poisoned.scale[rows == 0] = float("nan")
        xp = x.clone()
        xp[idle] = float("nan")
        y = ops.gqsa_gemv_experts(xp, poisoned, rows)
        assert torch.isfinite(y).all()
        _close(y, ref)


def test_gqsa_gemv_experts_rejects_what_it_does_not_take(cuda):
    """Operands the wrapper refuses before any launch, and a launcher
    that takes no shared-memory count but its own (g = 8's count is not
    g = 16's), only 16 or 32 lanes a row and no group size but 8, 16, 32,
    64 or 128."""
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.gqsa_gemv import (_experts_launcher,
                                               experts_plan,
                                               gqsa_gemv_experts_cuda)
    e, n, k = 3, 64, 128
    bsr = _experts(cuda, e, n, k)
    before = gqsa_gemv_experts_cuda.launches
    x = torch.randn((e, 2, k), device="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        gqsa_gemv_experts_cuda(x.cpu(), bsr)
    with pytest.raises(ValueError, match="x \\[E, C, K\\]"):
        gqsa_gemv_experts_cuda(x[0], bsr)
    with pytest.raises(ValueError, match="x \\[E, C, K\\]"):
        gqsa_gemv_experts_cuda(x[:, :0], bsr)
    with pytest.raises(ValueError, match="shape"):
        gqsa_gemv_experts_cuda(x[:2], bsr)
    with pytest.raises(TypeError, match="rows"):
        gqsa_gemv_experts_cuda(x, bsr, torch.ones(e, device="cuda"))
    with pytest.raises(TypeError, match="x must be f32 or bf16"):
        gqsa_gemv_experts_cuda(x.half(), bsr)
    with pytest.raises(ValueError, match="contiguous"):
        gqsa_gemv_experts_cuda(x.transpose(0, 1).contiguous()
                               .transpose(0, 1), bsr)
    assert gqsa_gemv_experts_cuda.launches == before
    m = bsr.idx.shape[-1]
    p = experts_plan(e, 2, n, m, k, 16, 4, sm_count(0))
    y = torch.empty((e, 2, n), device="cuda")
    for smem, lanes, g in ((p.smem - 16, p.row_lanes, 16),
                           (p.smem + 16, p.row_lanes, 16), (p.smem, 8, 16),
                           (p.smem, p.row_lanes, 256), (p.smem, p.row_lanes,
                                                        8)):
        rc = _experts_launcher()(
            x.data_ptr(), 0, bsr.idx.data_ptr(), bsr.vals.data_ptr(),
            bsr.scale.data_ptr(), bsr.zero.data_ptr(), y.data_ptr(), None,
            e, 2, n, m, k, g, p.tile, lanes, p.blocks, smem,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 1, rc


WIDE_ROWS = (1, 4, 8, 9, 64, 116)   # x rows at g = 64 and 128


@pytest.mark.parametrize("n,k", [(4096, 4096), (11008, 4096), (4096, 11008),
                                 (40, 1408)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g", [64, 128])
def test_gqsa_gemv_kernel_matches_grouped_at_wide_group_sizes(cuda, g, n, k,
                                                             dtype):
    """g = 64 and 128 (a kept group as g / 32 parts of 32 codes) at the
    llama2-7b shapes and K = 1408 (11 groups of 128): one launch a call
    at every row count, a repeat bit-identical, the output held to its
    grouped plain version (the kernel's order of arithmetic per part) and
    to the plain version."""
    from repro_torch.kernels import ref
    bsr = pack_linear(torch.randn((n, k), generator=cuda, device="cuda")
                      / k ** 0.5, _gqsa(g))
    assert bsr.group_size == g and bsr.vals.shape[-1] == g // 2
    for b in WIDE_ROWS:
        x = torch.randn((b, k), generator=cuda, device="cuda").to(dtype)
        before = gqsa_gemv_cuda.launches
        y = ops.gqsa_gemv(x, bsr)
        assert gqsa_gemv_cuda.launches - before == 1
        assert torch.equal(y, ops.gqsa_gemv(x, bsr))
        _close(y, ref.gqsa_gemv_grouped_ref(x, bsr))
        _close(y, ops.gqsa_gemv(x, bsr, plain=True))


@pytest.mark.parametrize("g", [64, 128])
def test_gqsa_gemv_kernel_ragged_rows_at_wide_group_sizes(cuda, g):
    """-1 padding slots, an empty row and rows of an odd number of parts
    (K = 1408), bf16 and f32 x at every row count."""
    from repro_torch.kernels import ref
    k = 1408
    w = torch.randn((300, k), generator=cuda, device="cuda")
    mask = torch.rand((300, k // g), generator=cuda, device="cuda") < 0.3
    mask[7] = False
    bsr = pack_dense(w, mask, QuantConfig(bits=4, group_size=g))
    assert bool((bsr.idx < 0).any())
    for b in WIDE_ROWS:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((b, k), generator=cuda, device="cuda").to(dtype)
            y = ops.gqsa_gemv(x, bsr)
            _close(y, ref.gqsa_gemv_grouped_ref(x, bsr))
            _close(y, ops.gqsa_gemv(x, bsr, plain=True))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g", [64, 128])
def test_gqsa_gemv_kernel_bit_identical_at_wide_group_sizes(cuda, g, dtype):
    """At g = 64 and 128 a row of x gives the same bits at T = 1, in a
    tile of 2, 4 or 8, or in a 116-row call."""
    from repro_torch.kernels.gqsa_gemv import plan
    bsr = pack_linear(torch.randn((4096, 11008), generator=cuda,
                                  device="cuda"), _gqsa(g))
    x = torch.randn((116, 11008), generator=cuda, device="cuda").to(dtype)
    y = ops.gqsa_gemv(x, bsr)
    tiles = set()
    for rows in (slice(5, 6), slice(6, 8), slice(8, 12), slice(16, 24),
                 slice(0, 20)):
        part = x[rows].contiguous()
        tiles.add(plan(part.shape[0], 4096, 11008, g, part.element_size(),
                       132).tile)
        assert torch.equal(ops.gqsa_gemv(part, bsr), y[rows])
    assert len(tiles) >= 3


@pytest.mark.parametrize("e,n,k", GQSA_EXPERT_SHAPES + [(5, 300, 512)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g", [64, 128])
def test_gqsa_gemv_experts_at_wide_group_sizes(cuda, g, e, n, k, dtype):
    """The expert axis at g = 64 and 128, at the DeepSeek-V2 and
    deepseek-moe-16b expert shapes (its w_d: 6 kept groups of 128, 24
    parts a row) and a small one: C = 1, 5, 13 and 30, one launch a call,
    ``rows`` absent and given (idle rows exact zeros), a repeat
    bit-identical, held to the grouped plain version and the plain
    version; then NaN in the idle experts' scales and in x past every
    expert's rows leaves the output equal to the plain version's on the
    clean operands (nothing idle is read)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gqsa_gemv import gqsa_gemv_experts_cuda
    bsr = _experts(cuda, e, n, k, g)
    assert bsr.group_size == g
    for c in (1, 5, 13, 30):
        x = torch.randn((e, c, k), generator=cuda, device="cuda").to(dtype)
        rows = _occupancy(cuda, e, c)
        idle = torch.arange(c, device="cuda")[None, :] >= rows[:, None]
        for r in (None, rows):
            before = gqsa_gemv_experts_cuda.launches
            y = ops.gqsa_gemv_experts(x, bsr, r)
            assert gqsa_gemv_experts_cuda.launches - before == 1
            assert y.shape == (e, c, n) and y.dtype == torch.float32
            assert torch.equal(y, ops.gqsa_gemv_experts(x, bsr, r))
            _close(y, ops.gqsa_gemv_experts(x, bsr, r, plain=True))
            if r is not None:
                assert (y[idle] == 0).all()
        _close(ops.gqsa_gemv_experts(x, bsr, rows),
               ref.gqsa_gemv_experts_grouped_ref(x, bsr, rows))
        plain = ops.gqsa_gemv_experts(x, bsr, rows, plain=True)
        poisoned = dataclasses.replace(bsr, scale=bsr.scale.clone())
        poisoned.scale[rows == 0] = float("nan")
        xp = x.clone()
        xp[idle] = float("nan")
        y = ops.gqsa_gemv_experts(xp, poisoned, rows)
        assert torch.isfinite(y).all()
        _close(y, plain)


def test_paged_attention_kernel_above_48kb_of_shared_memory(cuda):
    """Plain mode at D = 256 with 16 rows needs over 48 KB of shared
    memory: the launcher opts in past the default 48 KB."""
    q, kp, vp, lens, bt = _attn_case(cuda, 2, 2, 8, 256, torch.float32)
    o = ops.paged_decode_attention(q, kp, vp, lens, bt)
    _close(o, ops.paged_decode_attention(q, kp, vp, lens, bt, plain=True))
    assert (o[3] == 0).all() and (o[4, 0] == 0).all()


def _split_case(cuda, t, r, dtype, tree):
    """Lengths for the split walk over the 6-column table of
    :func:`_attn_case` (4 live columns, then sentinels): slot 0 one
    position (splits past 0 have no page), slot 1 two full pages (a page
    boundary), slot 2 three pages (the split boundary at S = 3), slot 3
    all-sentinel with length 0, slot 4 the four live pages with a length-0
    row. Tree mode: random bitmaps over a window of T ending at those
    lengths (slot 3 stays 0)."""
    q, kp, vp, _, bt = _attn_case(cuda, t, 4, r, 64, dtype)
    ends = torch.tensor([1, 32, 48, 0, 64], dtype=torch.int32, device="cuda")
    kw = {}
    if tree:
        base = (ends - t).clamp_min(0)
        lens = (base + t)[:, None].expand(-1, t).contiguous()
        lens[3] = 0
        kw = dict(anc=torch.randint(0, 2 ** 31 - 1, (5, t), generator=cuda,
                                    device="cuda", dtype=torch.int32),
                  anc_base=base, anc_window=t)
    else:
        lens = (ends[:, None] - t + 1
                + torch.arange(t, device="cuda")[None, :]).clamp_min(0)
        lens[3] = 0
        lens[4, 0] = 0
    return q, kp, vp, lens.to(torch.int32).contiguous(), bt, kw


def _split_kernel(q, kp, vp, lens, bt, n_split, ks=None, vs=None, anc=None,
                  anc_base=None, anc_window=0):
    """The wrapper at a given split count, on the dispatcher's operands."""
    b, t, h, d = q.shape
    khn = kp.shape[2]
    lq, live = ops.paged_query_prep(lens, bt, b, t, kp.shape[1])
    qh = q.reshape(b, t, khn, h // khn, d).permute(0, 2, 1, 3, 4) \
          .reshape(b, khn, -1, d).contiguous()
    o = paged_attention_cuda(
        qh, kp, vp, lq, bt, live, t, ks, vs, anc=anc,
        anc_base=None if anc is None else anc_base.to(torch.int32),
        window=anc_window, n_split=n_split)
    return o.reshape(b, khn, t, h // khn, d).permute(0, 2, 1, 3, 4) \
            .reshape(b, t, h, d)


@pytest.mark.parametrize("n_split", [1, 2, 3, 6])
@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_split_walk_matches_plain(cuda, n_split, tree,
                                                  dtype):
    """The split walk at S = 1, 2, 3 and the table's width: against the
    plain version and the plain version of the split; zeros where no
    position is visible; a second launch bit-identical."""
    from repro_torch.kernels.ref import paged_attention_split_ref
    t, r = (5, 1) if tree else (3, 2)
    q, kp, vp, lens, bt, kw = _split_case(cuda, t, r, dtype, tree)
    o = _split_kernel(q, kp, vp, lens, bt, n_split, **kw)
    _close(o, ops.paged_decode_attention(q, kp, vp, lens, bt, plain=True,
                                         **kw))
    _close(o, paged_attention_split_ref(q, kp, vp, lens, bt, n_split, **kw))
    assert (o[3] == 0).all() and (o[lens == 0] == 0).all()
    assert torch.equal(o, _split_kernel(q, kp, vp, lens, bt, n_split, **kw))


@pytest.mark.parametrize("t,r,tree", [(16, 2, False), (32, 1, False),
                                      (31, 1, True)])
def test_paged_attention_split_walk_32_rows_in_one_block(cuda, t, r, tree):
    """T*R = 32 (and a tree verify of T = 31) in one block of the split
    walk: one row group, each split's pages staged once."""
    q, kp, vp, lens, bt, kw = _split_case(cuda, t, r, torch.bfloat16, tree)
    before = (paged_attention_cuda.launches,
              paged_attention_cuda.tree_launches)
    o = ops.paged_decode_attention(q, kp, vp, lens, bt, **kw)
    after = (paged_attention_cuda.launches,
             paged_attention_cuda.tree_launches)
    assert after == (before[0] + (not tree), before[1] + tree)
    _close(o, ops.paged_decode_attention(q, kp, vp, lens, bt, plain=True,
                                         **kw))
    assert (o[3] == 0).all() and (o[lens == 0] == 0).all()


def test_paged_attention_split_walk_bit_identical_at_full_width(cuda):
    """4 slots x 32 KV heads x D = 128, 256 positions each (the default
    split count, 2 on an H100): two launches give the same bits."""
    b, mp, ps = 4, 16, 16
    q = torch.randn((b, 1, 32, 128), generator=cuda, device="cuda")
    kp, vp = (torch.randn((b * mp, ps, 32, 128), generator=cuda,
                          device="cuda").to(torch.bfloat16)
              for _ in range(2))
    bt = torch.randperm(b * mp, generator=cuda, device="cuda") \
        .reshape(b, mp).to(torch.int32)
    lens = torch.full((b, 1), 256, dtype=torch.int32, device="cuda")
    o = ops.paged_decode_attention(q, kp, vp, lens, bt)
    assert torch.equal(o, ops.paged_decode_attention(q, kp, vp, lens, bt))
    _close(o, ops.paged_decode_attention(q, kp, vp, lens, bt, plain=True))


def test_kernel_decode_steps_never_read_the_device_on_the_host(cuda):
    """A decode step and a tree-verify step of the reduced model through
    the kernels (split walk included), and a decode step of its dense-W4
    form (split K included), read no tensor value on the host: no
    ``aten::_local_scalar_dense`` or ``aten::item`` in the profile."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.engine.spec import TreeTemplate
    from repro_torch.models import transformer as ttf
    cfg = get_config("llama2_7b", reduced=True)
    params = ttf.init_params(0, cfg, "cuda", compress=GQSAConfig())
    cache = ttf.init_paged_cache(cfg, 16, 4, device="cuda")
    bt = torch.tensor([[0, 1, 2, 3, 4, 5], [16] * 6], dtype=torch.int32,
                      device="cuda")
    ttf.prefill(params, cache, torch.tensor([[5, 6, 7, 1, 2], [0] * 5],
                                            device="cuda"),
                torch.tensor([5, 0], device="cuda"), bt, cfg)
    spec = TreeTemplate((2, 2)).verify_tree("cuda")
    toks = torch.zeros((2, spec["anc"].shape[0]), dtype=torch.int32,
                       device="cuda")
    pos = torch.tensor([5, 0], dtype=torch.int32, device="cuda")
    # the dense-W4 model: wd (K = d_ff = 128) takes the tensor cores
    w4 = ttf.init_params(0, cfg, "cuda",
                         compress=QuantConfig(bits=4, group_size=16))
    w4_cache = ttf.init_paged_cache(cfg, 16, 4, device="cuda")
    ttf.prefill(w4, w4_cache, torch.tensor([[5, 6, 7, 1, 2], [0] * 5],
                                           device="cuda"),
                torch.tensor([5, 0], device="cuda"), bt, cfg)
    before = (paged_attention_cuda.launches,
              paged_attention_cuda.tree_launches,
              w4_matmul_cuda.tc_launches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ttf.decode_step(params, cache, torch.tensor([[1], [2]],
                                                    device="cuda"),
                        pos, cfg, bt, max_live_pages=2)
        ttf.decode_step(params, cache, toks, pos + 1, cfg, bt,
                        max_live_pages=4, tree=spec)
        ttf.decode_step(w4, w4_cache, torch.tensor([[1], [2]],
                                                   device="cuda"),
                        pos, cfg, bt, max_live_pages=2)
    torch.cuda.synchronize()
    assert paged_attention_cuda.launches > before[0]
    assert paged_attention_cuda.tree_launches > before[1]
    assert w4_matmul_cuda.tc_launches > before[2]
    reads = [e.key for e in prof.key_averages()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads


def _scales(cuda, kp):
    """Positive per-token K and V scales of an int8 pool."""
    return tuple(torch.rand(kp.shape[:3], generator=cuda, device="cuda") / 64
                 + 1e-3 for _ in range(2))


@pytest.mark.parametrize("n_split", [1, 2, 3, 6])
@pytest.mark.parametrize("tree", [False, True])
def test_paged_attention_split_walk_int8_matches_plain(cuda, n_split, tree):
    """The int8 mode on the split walk at S = 1, 2, 3 and the table's
    width: against the plain version (codes dequantized) and the plain
    version of the split (scales folded as the kernel folds them); zeros
    where no position is visible; a second launch bit-identical."""
    from repro_torch.kernels.ref import paged_attention_split_ref
    t, r = (5, 1) if tree else (3, 2)
    q, kp, vp, lens, bt, kw = _split_case(cuda, t, r, torch.int8, tree)
    ks, vs = _scales(cuda, kp)
    before = (paged_attention_cuda.int8_launches,
              paged_attention_cuda.tree_launches)
    o = _split_kernel(q, kp, vp, lens, bt, n_split, ks, vs, **kw)
    assert (paged_attention_cuda.int8_launches,
            paged_attention_cuda.tree_launches) == (before[0] + (not tree),
                                                    before[1] + tree)
    _close(o, ops.paged_decode_attention(q, kp, vp, lens, bt, ks, vs,
                                         plain=True, **kw))
    _close(o, paged_attention_split_ref(q, kp, vp, lens, bt, n_split, ks,
                                        vs, **kw))
    assert (o[3] == 0).all() and (o[lens == 0] == 0).all()
    assert torch.equal(o, _split_kernel(q, kp, vp, lens, bt, n_split, ks, vs,
                                        **kw))


def _latent_kernel(q, lat, lens, bt, v_rank, n_split, anc=None,
                   anc_base=None, anc_window=0):
    """The wrapper's latent mode at a given split count."""
    b, t, h, d = q.shape
    lq, live = ops.paged_query_prep(lens, bt, b, t, lat.shape[1])
    o = paged_attention_cuda(
        q.reshape(b, 1, t * h, d).contiguous(), lat[:, :, None, :], None,
        lq, bt, live, t, anc=anc, anc_base=anc_base, window=anc_window,
        v_rank=v_rank, n_split=n_split)
    return o.reshape(b, t, h, v_rank)


@pytest.mark.parametrize("n_split", [1, 2, 3, 16])
@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_split_walk_latent_matches_plain(cuda, n_split,
                                                         tree, dtype):
    """The latent mode at DeepSeek-V2 width (128 heads, D = 576, v_rank
    512) on the split walk at S = 1, 2, 3 and the 16-column table's
    width: against the plain version and the plain version of the split;
    zeros where no position is visible; a second launch bit-identical.
    Tree: a window of T = 3 with random bitmaps."""
    from repro_torch.kernels.ref import paged_attention_split_ref
    t = 3 if tree else 1
    q, lat, lens, bt = _latent_case(cuda, 4, t, 128, 576, dtype)
    kw = {}
    if tree:
        base = torch.tensor([30, 0, 197, 221], dtype=torch.int32,
                            device="cuda")
        lens = (base + t)[:, None].expand(-1, t).contiguous()
        lens[1] = 0
        kw = dict(anc=torch.randint(0, 2 ** 31 - 1, (4, t), generator=cuda,
                                    device="cuda", dtype=torch.int32),
                  anc_base=base, anc_window=t)
    before = (paged_attention_cuda.latent_launches,
              paged_attention_cuda.latent_tree_launches)
    o = _latent_kernel(q, lat, lens, bt, 512, n_split, **kw)
    assert (paged_attention_cuda.latent_launches,
            paged_attention_cuda.latent_tree_launches) \
        == (before[0] + 1, before[1] + int(tree))
    _close(o, ops.paged_latent_attention(q, lat, lens, bt, v_rank=512,
                                         plain=True, **kw))
    _close(o, paged_attention_split_ref(q, lat, None, lens, bt, n_split,
                                        v_rank=512, **kw))
    assert (o[1] == 0).all() and (o[lens == 0] == 0).all()
    assert torch.equal(o, _latent_kernel(q, lat, lens, bt, 512, n_split,
                                         **kw))


@pytest.mark.parametrize("t,h", [(1, 16), (1, 32), (2, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_latent_16_row_blocks(cuda, t, h, dtype):
    """Latent rows at D = 576 in blocks of 16 (``WIDE_ROWS``): T*H = 16
    rows in one block, 32 in two (one head group a block, or one fed
    token a block at T = 2); each page staged once a block for its 16
    rows, the 512 value columns in pairs over 256 threads."""
    q, lat, lens, bt = _latent_case(cuda, 4, t, h, 576, dtype)
    o = ops.paged_latent_attention(q, lat, lens, bt, v_rank=512)
    _close(o, ops.paged_latent_attention(q, lat, lens, bt, v_rank=512,
                                         plain=True))
    assert (o[1] == 0).all() and (o[3, 0] == 0).all()


def test_int8_pool_and_deepseek_decode_steps_never_read_the_device_on_the_host(
        cuda):
    """A decode step of the reduced llama2-7b with the int8 pool (the int8
    mode) and of the reduced DeepSeek-V2 (the latent mode, the experts'
    axis) through the kernels read no tensor value on the host: no
    ``aten::_local_scalar_dense`` or ``aten::item`` in the profile."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as ttf
    bt = torch.tensor([[0, 1, 2, 3, 4, 5], [16] * 6], dtype=torch.int32,
                      device="cuda")
    pos = torch.tensor([5, 0], dtype=torch.int32, device="cuda")
    steps = []
    for cfg in (dataclasses.replace(get_config("llama2_7b", reduced=True),
                                    kv_cache_dtype="int8"),
                get_config("deepseek_v2_236b", reduced=True)):
        params = ttf.init_params(0, cfg, "cuda", compress=GQSAConfig())
        cache = ttf.init_paged_cache(cfg, 16, 4, device="cuda")
        ttf.prefill(params, cache, torch.tensor([[5, 6, 7, 1, 2], [0] * 5],
                                                device="cuda"),
                    torch.tensor([5, 0], device="cuda"), bt, cfg)
        steps.append((params, cache, cfg))
    before = (paged_attention_cuda.int8_launches,
              paged_attention_cuda.latent_launches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for params, cache, cfg in steps:
            ttf.decode_step(params, cache, torch.tensor([[1], [2]],
                                                        device="cuda"),
                            pos, cfg, bt, max_live_pages=2)
    torch.cuda.synchronize()
    assert paged_attention_cuda.int8_launches > before[0]
    assert paged_attention_cuda.latent_launches > before[1]
    reads = [e.key for e in prof.key_averages()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "deepseek_v2_236b"])
def test_moe_spec_rounds_never_read_the_device_on_the_host(cuda, arch):
    """A chain round (K = 3) and a tree round ((2, 2)) of the reduced MoE
    families through the kernels (GQSA target, w4l50 draft on the W4
    expert axis) read no tensor value on the host, and the tree round
    runs the tree mode (``moe``) or the latent mode with tree operands
    (``mla_moe``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.core.model_compress import draft_layers
    from repro_torch.engine.sampling import SamplingParams
    from repro_torch.engine.spec import spec_step_fns, tree_step_fns
    from repro_torch.kernels.w4_matmul import w4_matmul_experts_cuda
    from repro_torch.models import transformer as ttf
    cfg = get_config(arch, reduced=True)
    params, draft = ttf.init_params_and_draft(0, cfg, "w4l50", "cuda",
                                              compress=GQSAConfig())
    dl = draft_layers(cfg, "w4l50")
    bt = torch.tensor([[0, 1, 2, 3, 4, 5], [16] * 6], dtype=torch.int32,
                      device="cuda")
    cache = ttf.init_paged_cache(cfg, 16, 4, device="cuda")
    ttf.prefill(params, cache, torch.tensor([[5, 6, 7, 1, 2], [0] * 5],
                                            device="cuda"),
                torch.tensor([5, 0], device="cuda"), bt, cfg)
    args = [torch.tensor(v, dtype=torch.int32, device="cuda")
            for v in ([1, 2], [5, 0])]
    active = torch.tensor([1, 0], dtype=torch.int32, device="cuda")
    greedy = SamplingParams()
    rounds = [spec_step_fns(cfg, greedy, 3, dl),
              tree_step_fns(cfg, greedy, (2, 2), dl)[:2]]
    tree_count = (lambda: paged_attention_cuda.latent_tree_launches) \
        if cfg.family == "mla_moe" \
        else (lambda: paged_attention_cuda.tree_launches)
    before = (tree_count(), w4_matmul_experts_cuda.launches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for draft_fn, verify_fn in rounds:
            d = draft_fn(draft, cache, args[0], args[1], bt, 2)
            verify_fn(params, cache, args[0], d, args[1], bt, active,
                      active * 8, None, 2)
    torch.cuda.synchronize()
    # the tree round: one level call of the draft, the verify's layers
    assert tree_count() == before[0] + dl + cfg.n_layers
    assert w4_matmul_experts_cuda.launches > before[1]
    reads = [e.key for e in prof.key_averages()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads


def test_moe_w4_decode_step_never_reads_the_device_on_the_host(cuda):
    """A decode step of the reduced deepseek-moe-16b under dense W4 (the
    W4 expert axis, whose ``rows`` stay on the card) reads no tensor value
    on the host."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.w4_matmul import w4_matmul_experts_cuda
    from repro_torch.models import transformer as ttf
    cfg = get_config("deepseek_moe_16b", reduced=True)
    params = ttf.init_params(0, cfg, "cuda",
                             compress=QuantConfig(bits=4, group_size=16))
    cache = ttf.init_paged_cache(cfg, 16, 4, device="cuda")
    bt = torch.tensor([[0, 1, 2, 3, 4, 5], [16] * 6], dtype=torch.int32,
                      device="cuda")
    ttf.prefill(params, cache, torch.tensor([[5, 6, 7, 1, 2], [0] * 5],
                                            device="cuda"),
                torch.tensor([5, 0], device="cuda"), bt, cfg)
    pos = torch.tensor([5, 0], dtype=torch.int32, device="cuda")
    before = w4_matmul_experts_cuda.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ttf.decode_step(params, cache, torch.tensor([[1], [2]],
                                                    device="cuda"),
                        pos, cfg, bt, max_live_pages=2)
    torch.cuda.synchronize()
    assert w4_matmul_experts_cuda.launches == before + 3 * cfg.n_layers
    reads = [e.key for e in prof.key_averages()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads


def _kv_cache(cuda, b, s, kh=32, d=128):
    """A contiguous int8 cache of quantized random K/V: (k, k_scale, v,
    v_scale)."""
    from repro_torch.models.layers import quantize_kv
    (k8, ks), (v8, vs) = (quantize_kv(torch.randn((b, s, kh, d),
                                                  generator=cuda,
                                                  device="cuda"))
                          for _ in range(2))
    return k8, ks, v8, vs


@pytest.mark.parametrize("s,r,d", [(64, 1, 128), (1000, 1, 128),
                                   (4096, 1, 128), (37, 1, 128),
                                   (32768, 1, 128), (100, 4, 64)])
def test_kv_decode_attention_kernel_matches_plain(cuda, s, r, d):
    """The contiguous-cache kernel at the smoke's shapes, B=4 KH=32 R=1
    D=128 (S = 37 and 1000: a partial last chunk), and at R=4 D=64: a
    shared length, per-slot lengths with a row of 0 (exact zeros) and the
    full length; one launch a call, no paged-mode launch; repeats
    bit-identical."""
    b = 4
    q = torch.randn((b, 32, r, d), generator=cuda, device="cuda")
    cache = _kv_cache(cuda, b, s, d=d)
    for ln in (s - 7, [s, 0, s // 3, 5], s):
        ln = torch.tensor(ln, dtype=torch.int32, device="cuda")
        before = (kv_decode_attention_cuda.launches,
                  paged_attention_cuda.int8_launches)
        o = ops.kv_decode_attention(q, *cache, ln)
        assert (kv_decode_attention_cuda.launches,
                paged_attention_cuda.int8_launches) == (before[0] + 1,
                                                        before[1])
        _close(o, ops.kv_decode_attention(q, *cache, ln, plain=True))
        assert torch.equal(o, ops.kv_decode_attention(q, *cache, ln))
        if ln.ndim:
            assert (o[1] == 0).all()


@pytest.mark.parametrize("kh,r,s", [(8, 5, 4096), (8, 7, 4096), (2, 12, 4096),
                                    (8, 16, 4096), (2, 12, 1000),
                                    (8, 16, 1000)])
def test_kv_decode_attention_kernel_at_query_rows(cuda, kh, r, s):
    """The kernel past 8 query rows a KV head (the 16-row template; R = 5
    and 7 on the 8-row one) at D=128, B=4: qwen3-14b's (8, 5),
    yi-34b's (8, 7), starcoder2-3b's (2, 12) and the limit (8, 16); a
    shared length, per-slot lengths with a row of 0 and the full length;
    one launch a call, repeats bit-identical."""
    from repro_torch.kernels.kv_decode_attention import plan
    b = 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = plan(b, kh, s, r, 128, sms)
    assert p.heads == min(kh, 8) and p.smem <= 232448
    q = torch.randn((b, kh, r, 128), generator=cuda, device="cuda")
    cache = _kv_cache(cuda, b, s, kh=kh)
    for ln in (s - 7, [s, 0, s // 3, 5], s):
        ln = torch.tensor(ln, dtype=torch.int32, device="cuda")
        before = kv_decode_attention_cuda.launches
        o = ops.kv_decode_attention(q, *cache, ln)
        assert kv_decode_attention_cuda.launches == before + 1
        _close(o, ops.kv_decode_attention(q, *cache, ln, plain=True))
        assert torch.equal(o, ops.kv_decode_attention(q, *cache, ln))
        if ln.ndim:
            assert (o[1] == 0).all()


def test_kv_decode_attention_kernel_refuses_17_rows(cuda):
    """R = 17 raises NotImplementedError naming the limit, before any
    launch; nothing goes to the plain version."""
    q = torch.randn((2, 2, 17, 128), generator=cuda, device="cuda")
    cache = _kv_cache(cuda, 2, 64, kh=2)
    before = kv_decode_attention_cuda.launches
    with pytest.raises(NotImplementedError, match="R <= 16"):
        ops.kv_decode_attention(q, *cache, torch.tensor(64, device="cuda"))
    assert kv_decode_attention_cuda.launches == before


@pytest.mark.parametrize("heads,stages,n_split", [(8, 3, None), (4, 3, None),
                                                  (8, 2, 1), (4, 4, 3),
                                                  (2, 6, 40), (1, 2, None)])
def test_kv_decode_attention_kernel_options(cuda, heads, stages, n_split):
    """Every heads / stages / split setting the sweep takes gives the
    plain version's output (S = 1000: 32 chunks, so 40 splits leave some
    empty), and the kernel's split walk its plain version's
    (``kv_decode_split_ref``) at the same split count; an int64 length
    and a shared one; a row of 0 is zeros."""
    from repro_torch.kernels.kv_decode_attention import plan
    from repro_torch.kernels.ref import kv_decode_split_ref
    b, kh, s = 3, 8, 1000
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    q = torch.randn((b, kh, 1, 128), generator=cuda, device="cuda")
    cache = _kv_cache(cuda, b, s, kh=kh)
    for ln in ([s, 0, 617], 999):
        ln = torch.tensor(ln, device="cuda")
        o = kv_decode_attention_cuda(q, *cache, ln, heads=heads,
                                     stages=stages, n_split=n_split)
        ns = n_split or plan(b, kh, s, 1, 128, sms, heads, stages).n_split
        _close(o, ops.kv_decode_attention(q, *cache, ln, plain=True))
        _close(o, kv_decode_split_ref(q, *cache, ln, ns))
        if ln.ndim:
            assert (o[1] == 0).all()


def test_kv_decode_attention_kernel_on_a_layer_slice(cuda):
    """A layer's slice of an [L, B, S, KH, D] cache reaches the kernel as
    it is (16-byte aligned: nothing is copied), with R = 4 query rows a
    KV head."""
    k8, ks, v8, vs = _kv_cache(cuda, 3 * 2, 96, kh=4, d=64)
    k8, ks, v8, vs = (t.reshape((3, 2) + t.shape[1:]) for t in
                      (k8, ks, v8, vs))
    q = torch.randn((2, 4, 4, 64), generator=cuda, device="cuda")
    ln = torch.tensor([50, 96], device="cuda")
    before = kv_decode_attention_cuda.launches
    o = ops.kv_decode_attention(q, k8[1], ks[1], v8[1], vs[1], ln)
    assert kv_decode_attention_cuda.launches == before + 1
    _close(o, ops.kv_decode_attention(q, k8[1], ks[1], v8[1], vs[1], ln,
                                      plain=True))


def test_static_serve_step_never_reads_the_device_on_the_host(cuda):
    """The contiguous serve step of the reduced llama2-7b with an int8
    cache (``kv_decode_attention`` in every layer), shared and per-slot
    ``pos``, reads no tensor value on the host."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import transformer as ttf
    cfg = dataclasses.replace(get_config("llama2_7b", reduced=True),
                              kv_cache_dtype="int8")
    params = ttf.init_params(0, cfg, "cuda", compress=GQSAConfig())
    cache = ttf.init_cache(cfg, 2, 64, device="cuda")
    serve = build_serve_step(cfg)
    tok, _ = serve(params, cache, torch.tensor([[1], [2]], device="cuda"),
                   torch.tensor(0, device="cuda"))
    before = kv_decode_attention_cuda.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tok, _ = serve(params, cache, tok, torch.tensor(1, device="cuda"))
        serve(params, cache, tok, torch.tensor([2, 5], device="cuda"))
    torch.cuda.synchronize()
    assert kv_decode_attention_cuda.launches == before + 2 * cfg.n_layers
    reads = [e.key for e in prof.key_averages()
             if e.key in ("aten::_local_scalar_dense", "aten::item")]
    assert not reads, reads
