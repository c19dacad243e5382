"""Block-Sparse-Row storage for GQS layers (paper §3.2 + Figure 3).

Padded tensor form (what the model and the kernels consume):
    idx   [N, M] int32   -- kept group columns, sorted; -1 padding on ragged rows
    vals  [N, M, G/2] u8 -- packed nibbles; padding rows are zero
    scale [N, M] f32     -- 0 on padding (=> dequant contributes nothing)
    zero  [N, M] f32
M = max groups per row (== exact count in row_balanced mode). Stacked
layers add leading dims to every leaf ([L, N, M], ...).

The paper's exact ragged form (rowIndex, groups, values) is produced by
:func:`to_paper_bsr` for storage accounting.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.quant import (QuantConfig, group_minmax_params,
                                    pack_int4, quantize, unpack_int4)


@dataclasses.dataclass
class BSRMatrix:
    """Padded tensor form. Leaves are torch tensors on one device."""
    idx: torch.Tensor        # [..., N, M] int32 (-1 = padding)
    vals: torch.Tensor       # [..., N, M, G/2] uint8
    scale: torch.Tensor      # [..., N, M] float32
    zero: torch.Tensor       # [..., N, M] float32
    shape: Tuple[int, int]   # dense (N, K)
    group_size: int
    bits: int = 4

    def layer(self, i: int) -> "BSRMatrix":
        """Slice ``i`` of a stacked matrix (a view: each leaf stays
        contiguous when the stacked leaf is)."""
        return dataclasses.replace(self, idx=self.idx[i], vals=self.vals[i],
                                   scale=self.scale[i], zero=self.zero[i])

    def nbytes_packed(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.idx, self.vals, self.scale, self.zero))


def _kept_columns(gmask: torch.Tensor) -> torch.Tensor:
    """bool [N, K/G] -> [N, M] int32 sorted kept columns, -1 right-padded
    (M = max kept per row, >= 1)."""
    n, ngroups = gmask.shape
    m = max(int(gmask.sum(dim=1).max()) if n else 0, 1)
    col = torch.arange(ngroups, device=gmask.device, dtype=torch.int64)
    # kept columns sort first, in column order; dropped ones sort last
    key = torch.where(gmask, col, col + ngroups)
    cols = torch.sort(key, dim=1).values[:, :m]
    return torch.where(cols < ngroups, cols, -1).to(torch.int32)


def pack_dense(w: torch.Tensor, gmask: torch.Tensor,
               qcfg: QuantConfig) -> BSRMatrix:
    """Dense W [N, K] + group mask [N, K/G] -> padded BSR with per-group
    INT4 quantization of the surviving groups (on ``w``'s device)."""
    n, k = w.shape
    g = qcfg.group_size
    idx = _kept_columns(gmask)
    m = idx.shape[1]
    wg = w.float().reshape(n, k // g, g)
    safe = idx.clamp_min(0).long()
    taken = torch.gather(wg, 1, safe[..., None].expand(n, m, g))  # [N, M, G]
    qc = QuantConfig(bits=qcfg.bits, group_size=g)
    scale, zero = group_minmax_params(taken.reshape(n, m * g), qc)
    q = quantize(taken.reshape(n, m * g), scale, zero, qc).reshape(n, m, g)
    pad = idx < 0
    scale = torch.where(pad, 0.0, scale)
    zero = torch.where(pad, 0.0, zero)
    q = torch.where(pad[..., None], 0, q).to(torch.uint8)
    return BSRMatrix(idx=idx, vals=pack_int4(q), scale=scale.float(),
                     zero=zero.float(), shape=(n, k), group_size=g,
                     bits=qcfg.bits)


def dequant_groups(bsr: BSRMatrix) -> torch.Tensor:
    """[N, M, G] f32 dequantized kept groups ((q - zero) * scale)."""
    q = unpack_int4(bsr.vals).float()
    return (q - bsr.zero[..., None]) * bsr.scale[..., None]


def to_dense(bsr: BSRMatrix, dtype=torch.float32) -> torch.Tensor:
    """Decompress to dense [N, K] (pruned groups = 0)."""
    n, k = bsr.shape
    g = bsr.group_size
    deq = dequant_groups(bsr)
    out = torch.zeros((n, k // g, g), dtype=torch.float32,
                      device=deq.device)
    # scatter-add; padding slots have scale 0 => contribute 0 to group 0
    out.index_put_((torch.arange(n, device=deq.device)[:, None],
                    bsr.idx.clamp_min(0).long()), deq, accumulate=True)
    return out.reshape(n, k).to(dtype)


def to_paper_bsr(bsr: BSRMatrix):
    """Padded form -> the paper's exact (rowIndex, groups, values, scales,
    zeros) numpy arrays (storage accounting and format tests)."""
    idx = bsr.idx.cpu().numpy()
    vals = bsr.vals.cpu().numpy()
    scale = bsr.scale.cpu().numpy()
    zero = bsr.zero.cpu().numpy()
    n = idx.shape[0]
    keep = idx >= 0
    row_index = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=row_index[1:])
    # padded slots are right-aligned after the sorted kept columns, so a
    # row-major boolean gather preserves (row, sorted-col) order exactly
    groups = idx[keep].astype(np.int32)
    values = vals[keep]
    if values.size == 0:
        values = np.zeros((0, bsr.group_size // 2), np.uint8)
    return (row_index, groups, values,
            scale[keep].astype(np.float32), zero[keep].astype(np.float32))


# ---------------------------------------------------------------------------
# Task-centric work list (paper §3.5, Stream-K). The first CUDA kernel maps
# one warp to one output row and does not read it; it stays here for the
# Stream-K kernel of a later PR.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WorkList:
    """Flattened, equal-size work items ``(row_block, chunk, first)``: one
    item per [block_n rows, block_m group slots] tile that holds at least
    one kept group; ``first`` marks each row block's first item."""
    row_block: np.ndarray   # [W] int32
    chunk: np.ndarray       # [W] int32
    first: np.ndarray       # [W] int32
    n_items: int


def build_work_list(idx, block_n: int, block_m: int) -> WorkList:
    """idx: [N, M] padded kept-group columns (-1 pad). Static host build,
    done once at pack time like the paper's pre-processing."""
    idx_np = idx.cpu().numpy() if isinstance(idx, torch.Tensor) \
        else np.asarray(idx)
    n, m = idx_np.shape
    nrb = (n + block_n - 1) // block_n
    rows, chunks, firsts = [], [], []
    for r in range(nrb):
        blk = idx_np[r * block_n:(r + 1) * block_n]
        useful = int((blk >= 0).sum(axis=1).max()) if blk.size else 0
        nch = max(1, (useful + block_m - 1) // block_m)
        for c in range(nch):
            rows.append(r)
            chunks.append(c)
            firsts.append(1 if c == 0 else 0)
    return WorkList(row_block=np.asarray(rows, np.int32),
                    chunk=np.asarray(chunks, np.int32),
                    first=np.asarray(firsts, np.int32),
                    n_items=len(rows))
