"""int8-KV decode attention over a contiguous cache: the wrapper of the
hand-written CUDA kernel (``repro_torch/csrc/kv_decode_attention.cu``).
Its plain PyTorch version is ``kernels/ref.py:kv_decode_attention_ref``;
``ref.py:kv_decode_split_ref`` repeats the kernel's split and combine.

Replaces the TPU kernel ``src/repro/kernels/ops.py:kv_decode_attention``
(``paged_attention_pallas`` in int8 mode over the cache viewed as pages
under identity block tables), which the static-batch serve step reaches
in every layer.

Bound on the H100: bytes. Each live code and scale is read once; the
floor is 2 * B * length * KH * (D + 4) bytes over 3.35 TB/s (4 slots x
32768 positions x 32 heads of 128: 330.6 us). Each code pair feeds 4 R
flops, under the bf16 tensor cores' balance at every R up to 16; the
kernel's f32 multiply-adds on the CUDA cores outlast the bytes from R =
11 on (starcoder2-3b: 24 heads over 2 KV heads, R = 12).

Design (details in the CUDA source): one block per (split, group of
``heads`` KV heads, slot), a warp per head, lanes over the 32 positions
of a stage; a position's codes for the group are one contiguous run, its
scales one run, staged through a ring of ``stages`` ``cp.async`` stages.
Codes become f32 by a byte permute and one subtraction, not I2F. Each
slot's live length, read on the card, is cut into chunks of ``CHUNK``
positions shared out over the splits; :func:`plan` picks heads, stages
and the split count from shapes and the SM count alone, so nothing is
read on the host; a second small kernel merges the splits in order, so
repeats are bit-identical.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.build import load, sm_count

CHUNK = 32           # positions a stage (a lane each)
ROW_PAD = 16         # bytes after a staged position's codes
HEADS = 8            # KV heads a block, at most (a warp each)
MAX_ROWS = 16        # query rows a KV head
HEAD_DIMS = (16, 64, 128)  # the port's: reduced configs, tests, full
STAGES = 3           # ring stages
MAX_STAGES = 8
SPLIT_WAVES = 2      # resident blocks aimed at, per SM of the card
SMEM_LIMIT = 232448  # dynamic shared memory a block may take on sm_90
SMEM_PER_SM = 233472  # shared memory an SM holds (1 KB of it per block
#                       is the system's)


class Plan(NamedTuple):
    heads: int
    stages: int
    n_split: int
    smem: int


def smem_bytes(heads: int, r: int, d: int, stages: int) -> int:
    """Shared memory of a block, as the CUDA source lays it out: the ring
    (a stage: K and V codes [CHUNK][heads * D + ROW_PAD], K and V scales
    [CHUNK][heads] f32), q [heads][R][D] f32 and each warp's probabilities
    [rows][CHUNK] f32 (rows: R rounded up to a power of two)."""
    rows = 1 << (r - 1).bit_length()
    stage = 2 * CHUNK * (heads * d + ROW_PAD) + 2 * CHUNK * heads * 4
    return stages * stage + 4 * (heads * r * d + heads * rows * CHUNK)


def plan(b: int, khn: int, s: int, r: int, d: int, sms: int,
         heads: Optional[int] = None, stages: Optional[int] = None) -> Plan:
    """Heads a block (the largest power of two up to ``HEADS`` that
    divides KH, or ``heads``), ring stages (``STAGES`` or ``stages``,
    fewer if the block would not fit; if 2 stages still do not fit, half
    the heads, unless ``heads`` was given) and the split count, from
    shapes and the SM count alone: the (slot, head group) blocks times
    the splits come to at most ``SPLIT_WAVES`` x the blocks the card
    holds at once by shared memory, and a split has at least one chunk of
    the cache's S positions. At 4 slots x 32 KV heads of 128, R = 1, on
    132 SMs: 8 heads, 3 stages (210,944 bytes, one block an SM), 16
    splits, 256 blocks. At R = 16 with 8 KV heads: 8 heads, 2 stages
    (219,136 bytes)."""
    fixed = heads is not None
    if heads is None:
        heads = HEADS
        while khn % heads:
            heads //= 2
    depth = STAGES if stages is None else stages
    while True:
        stages = depth
        smem = smem_bytes(heads, r, d, stages)
        while smem > SMEM_LIMIT and stages > 2:
            stages -= 1
            smem = smem_bytes(heads, r, d, stages)
        if smem <= SMEM_LIMIT or fixed or heads == 1:
            break
        heads //= 2
    per_sm = max(1, SMEM_PER_SM // (smem + 1024))
    groups = b * (khn // heads)
    want = SPLIT_WAVES * sms * per_sm
    n_split = max(1, min(want // groups, -(-s // CHUNK)))
    return Plan(heads, stages, n_split, smem)


# kv_decode_attention_launch(q, k, k_scale, v, v_scale, length,
# len_stride, len_bytes, out, B, S, KH, R, D, heads, n_stages, n_split,
# smem, workspace, stream)
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] + [ctypes.c_int] * 8
                   + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = load("kv_decode_attention").kv_decode_attention_launch
    fn.argtypes = LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, align: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"kv_decode_attention: {name} must be a CUDA "
                         f"tensor")
    if t.dtype != dtype:
        raise TypeError(f"kv_decode_attention: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"kv_decode_attention: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"kv_decode_attention: {name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"kv_decode_attention: {name} must be {align}-byte "
                         f"aligned (cp.async copies)")


def kv_decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                             k_scale: torch.Tensor, v_cache: torch.Tensor,
                             v_scale: torch.Tensor, length,
                             heads: Optional[int] = None,
                             stages: Optional[int] = None,
                             n_split: Optional[int] = None) -> torch.Tensor:
    """out [B, KH, R, D] f32 on the card.

    q: [B, KH, R, D] f32; k/v_cache: int8 [B, S, KH, D]; k/v_scale: f32
    [B, S, KH]; length: [] or [B] int32/int64 on the card (or a Python
    int), the valid prefix. D in ``HEAD_DIMS``, R <= ``MAX_ROWS``.
    ``heads``, ``stages`` and ``n_split`` override :func:`plan` (the
    sweeps of ``scripts/ab_attention.py``). One launch a call, counted in
    ``launches``, whatever number of kernels it launches."""
    b, khn, r, d = q.shape
    s = k_cache.shape[1]
    if q.device.type != "cuda":
        raise ValueError("kv_decode_attention: q must be a CUDA tensor")
    if d not in HEAD_DIMS or not 1 <= r <= MAX_ROWS:
        raise NotImplementedError(
            f"kv_decode_attention_cuda takes D in {HEAD_DIMS} and 1 <= R "
            f"<= {MAX_ROWS}; got D={d}, R={r}")
    p = plan(b, khn, s, r, d, sm_count(
        q.device.index if q.device.index is not None
        else torch.cuda.current_device()), heads, stages)
    n_split = p.n_split if n_split is None else n_split
    if (p.heads not in (1, 2, 4, HEADS) or khn % p.heads
            or not 2 <= p.stages <= MAX_STAGES or p.smem > SMEM_LIMIT
            or n_split < 1):
        raise ValueError(f"kv_decode_attention_cuda: heads {p.heads} (a "
                         f"power of two <= {HEADS} dividing KH={khn}), "
                         f"stages {p.stages} (2..{MAX_STAGES}), shared "
                         f"memory {p.smem} (<= {SMEM_LIMIT}) and n_split "
                         f"{n_split} (>= 1) are not a launch the kernel "
                         f"takes")
    if q.data_ptr() % 16:                  # staged with 16-byte loads
        q = q.clone()
    _check(q, "q", torch.float32, (b, khn, r, d), 16)
    _check(k_cache, "k_cache", torch.int8, (b, s, khn, d), 16)
    _check(v_cache, "v_cache", torch.int8, (b, s, khn, d), 16)
    sc_align = min(16, 4 * p.heads)
    _check(k_scale, "k_scale", torch.float32, (b, s, khn), sc_align)
    _check(v_scale, "v_scale", torch.float32, (b, s, khn), sc_align)
    length = torch.as_tensor(length, device=q.device)
    if length.dtype not in (torch.int32, torch.int64) \
            or length.shape not in ((), (b,)):
        raise ValueError(f"kv_decode_attention: length must be int32 or "
                         f"int64 of shape [] or [{b}], got {length.dtype} "
                         f"{tuple(length.shape)}")
    length = length.contiguous()
    out = torch.empty((b, khn, r, d), dtype=torch.float32, device=q.device)
    work = torch.empty(b * khn * n_split * r * (d + 2), dtype=torch.float32,
                       device=q.device) if n_split > 1 else None
    rc = _launcher()(q.data_ptr(), k_cache.data_ptr(), k_scale.data_ptr(),
                     v_cache.data_ptr(), v_scale.data_ptr(),
                     length.data_ptr(), int(length.ndim == 1),
                     length.element_size(), out.data_ptr(), b, s, khn, r, d,
                     p.heads, p.stages, n_split, p.smem,
                     None if work is None else work.data_ptr(),
                     torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:     # 1: arguments the launcher refuses
        raise RuntimeError(
            f"kv_decode_attention kernel launch failed: CUDA error {rc}")
    kv_decode_attention_cuda.launches += 1
    return out


kv_decode_attention_cuda.launches = 0
