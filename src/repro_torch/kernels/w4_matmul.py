"""Dense grouped-dequant W4 matmul: the wrapper of the hand-written CUDA
kernel (``repro_torch/csrc/w4_matmul.cu``). Its plain PyTorch version is
``kernels/ref.py:w4_matmul_ref``; ``ref.py:w4_matmul_grouped_ref`` repeats
the tensor-core path's order of arithmetic.

Replaces the TPU kernel ``src/repro/kernels/w4_matmul.py:w4_matmul_pallas``
(body ``_kernel``), which every projection of the dense-W4 baseline
(``--compress w4``, the paper's W4A16 rows) reaches in prefill and decode.

Bound on the H100: bytes. At decode each code byte and each f32
scale/zero is used for a few multiply-adds; the floor is
(N*K/2 + 8*N*K/G + x + y) bytes over 3.35 TB/s (wq of llama2-7b at G16:
16.9 MB -> 5.0 us; wg/wu/wd: 45.1 MB -> 13.5 us).

Two paths, chosen here from shapes and pointers alone
(:func:`takes_tensor_cores`), never on a failure:

* Tensor cores: G in ``TC_GROUPS``, K a multiple of ``TC_K`` and every
  operand 16-byte aligned (every llama2-7b projection at G16). One
  ``mma.sync`` m16n8k16 is one G16 group of 16 weight rows against 8 x
  rows, on the raw codes; scale and zero apply to the f32 result. A block
  owns ``TC_ROWS`` rows and up to 64 x rows and streams its share of K
  through a ``cp.async`` ring; K is split over :func:`split_count` blocks
  and the partials are added in split order by the tile's last block
  (workspace and counters from here). Counted by ``tc_launches``.
* CUDA cores: any other shape (G = 6, K = 48, misaligned codes). A block
  owns 32 rows and at most 8 x rows and dequantises each lane's codes in
  registers for f32 dot products.

``launches`` counts both. The kernels mask the ragged edges of T, N and K
themselves: the wrapper pads and copies nothing.

The expert axis (:func:`w4_matmul_experts_cuda`) runs the routed experts
of an MoE layer packed as dense W4 (the reference's ``vmap`` of the same
Pallas kernel in ``src/repro/models/moe.py:_expert_ffn``) in one launch:
the expert is the grid's third axis, on the same two paths chosen the
same way, without a split of K. An expert's buffer rows at or past
``rows[e]`` come out as zeros and a tile with none is not read, so an idle
expert's weights never leave device memory. Its own counters are
``w4_matmul_experts_cuda.launches`` and ``.tc_launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import load, sm_count

VEC_K = 64          # K multiple (and 16-byte qw alignment) of the CUDA-core
                    # path's vector loads
TC_K = 128          # K elements a stage of the tensor-core path (its K step)
TC_ROWS = 64        # output rows a block of the tensor-core path
TC_GROUPS = (16, 32, 64, 128)   # group sizes it takes (a divisor of TC_K)
TC_WAVES = (3, 2)   # blocks aimed at per SM at <= 16 x rows, and above
                    # (5 fit at <= 8 bf16 rows, 2 at 64: 3 and 2 measured
                    # best)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("w4_matmul").w4_matmul_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _experts_launcher():
    fn = load("w4_matmul").w4_matmul_experts_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tc_launcher():
    fn = load("w4_matmul").w4_matmul_tc_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_COUNTERS = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """``n`` zero int32 counters of the split combine on ``device``; each
    launch leaves them at zero, so one buffer serves every launch of one
    stream."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def takes_tensor_cores(k: int, g: int, *pointers: int) -> bool:
    """Whether the tensor-core path takes a product with K = ``k``, group
    size ``g`` and operands at ``pointers`` (x, qw, scale, zero)."""
    return (g in TC_GROUPS and k % TC_K == 0
            and all(p % 16 == 0 for p in pointers))


def token_tiles(t: int) -> int:
    """n8 tiles of x rows a tensor-core block takes: 1, 2, 4 or 8 (a block
    reads its weights once for up to 64 x rows)."""
    for nt in (1, 2, 4):
        if t <= 8 * nt:
            return nt
    return 8


def split_count(t: int, n: int, k: int, sms: int) -> int:
    """Blocks K is split over, from host-known shapes only: the count
    nearest to ``TC_WAVES`` blocks (64 rows x a tile of x rows x a split)
    on each SM, at most one a ``TC_K`` stage. On 132 SMs at T <= 8: 6 for
    N = 4096 (384 blocks), 2 for N = 11008 (344 blocks); at T = 64: 4 and
    2."""
    nt = token_tiles(t)
    tiles = -(-n // TC_ROWS) * -(-t // (8 * nt))
    aim = TC_WAVES[0] if nt <= 2 else TC_WAVES[1]
    return max(1, min(k // TC_K, round(aim * sms / tiles)))


def plan(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
         zero: torch.Tensor, group_size: int) -> Tuple[str, int]:
    """(path, split count) of a launch on the card: ``("tc", S)`` for the
    tensor-core path, ``("simt", 1)`` for the CUDA-core one."""
    t, k = x.shape
    if not takes_tensor_cores(k, group_size, x.data_ptr(), qw.data_ptr(),
                              scale.data_ptr(), zero.data_ptr()):
        return "simt", 1
    return "tc", split_count(t, qw.shape[0], k, sm_count(x.device.index))


def _check_x(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be f32 or bf16, got {x.dtype}")


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"w4_matmul: {name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"w4_matmul: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"w4_matmul: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"w4_matmul: {name} must be contiguous")


def w4_matmul_cuda(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                   zero: torch.Tensor, group_size: int,
                   n_split: Optional[int] = None) -> torch.Tensor:
    """y [T, N] f32 = x [T, K] @ deq(qw).T on the card, any T >= 1.

    x: f32 or bf16; qw: uint8 [N, K/2]; scale/zero: f32 [N, K/G]; all
    contiguous on one card. G must be even and divide K. ``n_split``
    overrides :func:`split_count` on the tensor-core path (1 .. K/128)."""
    _check_x(x, "w4_matmul_cuda")
    t, k = x.shape
    n = qw.shape[0]
    g = group_size
    if t < 1 or g < 2 or g % 2 or k % g:
        raise ValueError(f"w4_matmul_cuda takes T >= 1 rows and an even "
                         f"group size dividing K, got T={t}, K={k}, G={g}")
    _check(x, "x", x.dtype, (t, k))
    _check(qw, "qw", torch.uint8, (n, k // 2))
    _check(scale, "scale", torch.float32, (n, k // g))
    _check(zero, "zero", torch.float32, (n, k // g))
    if len({x.device, qw.device, scale.device, zero.device}) != 1:
        raise ValueError("w4_matmul_cuda: operands lie on different cards")
    path, splits = plan(x, qw, scale, zero, g)
    if n_split is not None:
        if path != "tc" or not 1 <= n_split <= k // TC_K:
            raise ValueError(f"w4_matmul_cuda: n_split={n_split} needs the "
                             f"tensor-core path and 1 <= n_split <= "
                             f"K/{TC_K}")
        splits = n_split
    y = torch.empty((t, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bf16 = int(x.dtype == torch.bfloat16)
    if path == "tc":
        nt = token_tiles(t)
        work = counters = None
        if splits > 1:
            work = torch.empty(splits * t * n, dtype=torch.float32,
                               device=x.device)
            counters = _counters(x.device, -(-n // TC_ROWS)
                                 * -(-t // (8 * nt)))
        rc = _tc_launcher()(
            x.data_ptr(), bf16, qw.data_ptr(), scale.data_ptr(),
            zero.data_ptr(), y.data_ptr(),
            None if work is None else work.data_ptr(),
            None if counters is None else counters.data_ptr(), t, n, k, g,
            nt, splits, stream)
    else:
        vec = k % VEC_K == 0 and qw.data_ptr() % 16 == 0
        rc = _launcher()(x.data_ptr(), bf16, qw.data_ptr(),
                         scale.data_ptr(), zero.data_ptr(), y.data_ptr(),
                         t, n, k, g, int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"w4_matmul kernel launch failed: CUDA error {rc}")
    w4_matmul_cuda.launches += 1
    if path == "tc":
        w4_matmul_cuda.tc_launches += 1
    return y


w4_matmul_cuda.launches = 0      # both paths
w4_matmul_cuda.tc_launches = 0   # the tensor-core path


def w4_matmul_experts_cuda(x: torch.Tensor, qw: torch.Tensor,
                           scale: torch.Tensor, zero: torch.Tensor,
                           rows: Optional[torch.Tensor],
                           group_size: int) -> torch.Tensor:
    """y [E, C, N] f32 with y[e] = x[e] @ deq(qw[e], scale[e], zero[e]).T
    on the card, every expert and any C >= 1 in one launch.

    x: [E, C, K] f32 or bf16; qw: uint8 [E, N, K/2]; scale/zero: f32
    [E, N, K/G]; ``rows`` [E] int32 or None: rows at or past ``rows[e]``
    are written as zeros and a tile of x rows with none is not read (nor
    are its weights). All contiguous on one card. The path is
    :func:`takes_tensor_cores`'s, from shapes and pointers."""
    _check_x(x, "w4_matmul_experts_cuda")
    if x.dim() != 3:
        raise ValueError(f"w4_matmul_experts_cuda takes x [E, C, K], got "
                         f"{tuple(x.shape)}")
    e, c, k = x.shape
    n = qw.shape[-2]
    g = group_size
    if c < 1 or g < 2 or g % 2 or k % g:
        raise ValueError(f"w4_matmul_experts_cuda takes C >= 1 rows and an "
                         f"even group size dividing K, got C={c}, K={k}, "
                         f"G={g}")
    _check(x, "x", x.dtype, (e, c, k))
    _check(qw, "qw", torch.uint8, (e, n, k // 2))
    _check(scale, "scale", torch.float32, (e, n, k // g))
    _check(zero, "zero", torch.float32, (e, n, k // g))
    devices = {x.device, qw.device, scale.device, zero.device}
    if rows is not None:
        _check(rows, "rows", torch.int32, (e,))
        devices.add(rows.device)
    if len(devices) != 1:
        raise ValueError("w4_matmul_experts_cuda: operands lie on different "
                         "cards")
    tc = takes_tensor_cores(k, g, x.data_ptr(), qw.data_ptr(),
                            scale.data_ptr(), zero.data_ptr())
    vec = k % VEC_K == 0 and qw.data_ptr() % 16 == 0
    y = torch.empty((e, c, n), dtype=torch.float32, device=x.device)
    rc = _experts_launcher()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), qw.data_ptr(),
        scale.data_ptr(), zero.data_ptr(), y.data_ptr(),
        None if rows is None else rows.data_ptr(), e, c, n, k, g, int(tc),
        token_tiles(c), int(vec),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"w4_matmul experts kernel launch failed: CUDA "
                           f"error {rc}")
    w4_matmul_experts_cuda.launches += 1
    if tc:
        w4_matmul_experts_cuda.tc_launches += 1
    return y


w4_matmul_experts_cuda.launches = 0      # both paths
w4_matmul_experts_cuda.tc_launches = 0   # the tensor-core path
