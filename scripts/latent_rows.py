"""Sweep the latent mode's query rows per block of the paged-attention
kernel on one card.

    python3 scripts/latent_rows.py --rows 16,4,8,2,4,16

Builds one variant of ``src/repro_torch/csrc/paged_attention.cu`` per
distinct value of its ``kLatentRows`` constant (into the git-ignored
``build/exp/``), then, in the given order, binds each through the port's
wrapper, checks it against the plain version and times it
(``chip_smoke.Timer``: L2 flushed before every launch, 30 launches) at the
4-slot DeepSeek-V2 decode shape (H=128, D=576, v_rank 512, bf16 pages) at
serve lengths and at 256. Prints the registers of each variant and one
line per turn.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def build_variants(rows):
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import LAUNCH_ARGTYPES
    src = (build.CSRC / "paged_attention.cu").read_text()
    out = os.path.join(ROOT, "build", "exp")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for n in sorted(set(rows)):
        path = os.path.join(out, f"paged_attention_rows{n}.cu")
        with open(path, "w") as f:
            f.write(re.sub(r"constexpr int kLatentRows = \d+;",
                           f"constexpr int kLatentRows = {n};", src))
        lib = path[:-3] + ".so"
        procs[n] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for n, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(log)
        regs = [l.split(":", 1)[1].strip() for l in log.splitlines()
                if "registers" in l]
        print(f"rows {n}: latent instantiations {regs[-2:]}", flush=True)
        fn = ctypes.CDLL(lib).paged_attention_launch
        fn.argtypes = LAUNCH_ARGTYPES
        fn.restype = ctypes.c_int
        fns[n] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="16,4,8,2,4,16")
    rows = [int(r) for r in ap.parse_args(argv).rows.split(",")]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    fns = build_variants(rows)
    timer = cs.Timer()
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    b = 4
    cases = {}
    for label, lens in (("serve", [20, 25, 31, 29]), ("256", [256] * 4)):
        lq = torch.tensor(lens, dtype=torch.int32)[:, None]
        cases[label] = cs._latent_case(b, 1, lq, torch.bfloat16, g)
    for n in rows:
        pa._launcher = lambda fn=fns[n]: fn
        pa.LATENT_ROWS = n
        res = []
        for label, (q, lat, lq, bt) in cases.items():
            o = ops.paged_latent_attention(q, lat, lq, bt, v_rank=cs.DS_R)
            ref = ops.paged_latent_attention(q, lat, lq, bt, v_rank=cs.DS_R,
                                             plain=True)
            rel = ((o - ref).abs().max() / ref.abs().max()).item()
            lq2, live = ops.paged_query_prep(lq, bt, b, 1, lat.shape[1])
            qh = q.reshape(b, 1, cs.DS_H, cs.DS_D).contiguous()
            lat4 = lat[:, :, None, :]
            t = timer.ms(lambda: pa.paged_attention_cuda(
                qh, lat4, None, lq2, bt, live, 1, v_rank=cs.DS_R))
            res.append(f"{label} {t * 1e3:.1f}us rel {rel:.1e}")
        print(f"rows {n}: " + " | ".join(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
