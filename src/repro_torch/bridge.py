"""Carry a reference parameter tree over to the port.

Input: the tree as nested dicts of numpy arrays (stacked [L, ...] leaves
included), where each packed GQSA leaf is a dict ``{"idx", "vals",
"scale", "zero", "shape", "group_size", "bits"}`` instead of the
reference's matrix object. The caller produces that form (``np.asarray``
on every leaf); this module imports neither framework's reference package.
Output: the same tree as torch tensors on ``device``.

bf16 leaves arrive as numpy's extension dtype ``bfloat16``, which torch
cannot read directly: they are widened through f32 and narrowed back,
which is exact.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.bsr import BSRMatrix

BSR_KEYS = {"idx", "vals", "scale", "zero", "shape", "group_size", "bits"}


def to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    # a copy: the source may be a read-only view of another framework's
    # buffer
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device=None):
    """Nested dicts of numpy arrays (+ BSR dicts) -> the port's params."""
    dev = resolve_device(device)
    if isinstance(tree, dict) and set(tree) == BSR_KEYS:
        return BSRMatrix(idx=to_tensor(tree["idx"], dev).to(torch.int32),
                         vals=to_tensor(tree["vals"], dev),
                         scale=to_tensor(tree["scale"], dev),
                         zero=to_tensor(tree["zero"], dev),
                         shape=tuple(int(s) for s in tree["shape"]),
                         group_size=int(tree["group_size"]),
                         bits=int(tree["bits"]))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return to_tensor(tree, dev)


def bsr_to_numpy(b: BSRMatrix) -> Dict:
    """The port's packed leaf in the bridge's dict form (for comparisons)."""
    return {"idx": b.idx.cpu().numpy(), "vals": b.vals.cpu().numpy(),
            "scale": b.scale.cpu().numpy(), "zero": b.zero.cpu().numpy(),
            "shape": tuple(b.shape), "group_size": b.group_size,
            "bits": b.bits}
