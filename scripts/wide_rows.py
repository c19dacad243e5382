"""Sweep the query rows a block of the paged-attention kernel's latent mode
on one card.

    python3 scripts/wide_rows.py --rows 16,8,32,32,8,16

Builds one variant of ``src/repro_torch/csrc/paged_attention.cu`` per
distinct value of its ``kWideRows`` constant (the rows a block past a
value width of 256, which only the latent mode has) into the git-ignored
``build/exp/``, then, in the given order, binds each through the port's
wrapper (its split count computed for that row group), checks it against
the plain version and times it (``chip_smoke.Timer``: L2 flushed before
every launch, 100 launches) at the 4-slot DeepSeek-V2 decode shape (H=128,
D=576, v_rank 512, bf16 pages): serve lengths 20/25/31/29 with the
16-column table of 256-token slots and with the 3 live columns the engine
passes, 256 x 4, and the (2,2) verify block (T=7) at ~256. Prints the
registers of each variant and one ``ROWS`` line per case and turn.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def build_variants(rows):
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import LAUNCH_ARGTYPES
    src = (build.CSRC / "paged_attention.cu").read_text()
    line = "constexpr int kWideRows = "
    start = src.index(line)
    end = src.index(";", start)
    out = os.path.join(ROOT, "build", "exp")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for n in sorted(set(rows)):
        path = os.path.join(out, f"paged_attention_wide{n}.cu")
        with open(path, "w") as f:
            f.write(src[:start] + f"{line}{n}" + src[end:])
        lib = path[:-3] + ".so"
        procs[n] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for n, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(log)
        lines = log.splitlines()
        regs = [next(m for m in lines[i:] if "registers" in m)
                .split("Used")[1].split(",")[0].strip()
                for i, l in enumerate(lines)
                if "Compiling entry" in l and f"Li{n}ELi1ELi256E" in l]
        print(f"rows {n}: latent instantiations {regs}", flush=True)
        fn = ctypes.CDLL(lib).paged_attention_launch
        fn.argtypes = LAUNCH_ARGTYPES
        fn.restype = ctypes.c_int
        fns[n] = fn
    return fns


def cases():
    """(label, call(), plain output) at the DeepSeek-V2 decode shapes."""
    import torch
    import chip_smoke as cs
    from repro_torch.engine.spec import TreeTemplate
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 12)
    b, out = 4, []
    serve = [20, 25, 31, 29]
    for label, lens, cols, fanout in (
            ("serve", serve, None, None), ("serve, live table", serve, 3,
                                           None),
            ("256", [256] * 4, None, None),
            ("tree (2,2) ~256", [240, 235, 245, 230], None, (2, 2))):
        kw = {}
        if fanout is None:
            t = 1
            lq = torch.tensor(lens, dtype=torch.int32)[:, None]
        else:
            spec = TreeTemplate(fanout).verify_tree("cuda")
            t, win = spec["anc"].shape[0], spec["window"]
            base = torch.tensor(lens, dtype=torch.int32)
            lq = (base + win)[:, None].expand(b, t).contiguous()
            kw = dict(anc=spec["anc"][None].expand(b, t).contiguous(),
                      anc_base=base.to("cuda"), window=win)
        q, lat, lq, bt = cs._latent_case(b, t, lq, torch.bfloat16, g)
        if cols is not None:
            bt = bt[:, :cols].contiguous()
        lq2, live = ops.paged_query_prep(lq, bt, b, t, lat.shape[1])
        qh = q.reshape(b, 1, t * cs.DS_H, cs.DS_D).contiguous()
        ref = ops.paged_latent_attention(
            q, lat, lq, bt, v_rank=cs.DS_R, plain=True,
            **({} if not kw else dict(anc=kw["anc"], anc_base=kw["anc_base"],
                                      anc_window=kw["window"])))

        def call(qh=qh, lat=lat, lq2=lq2, bt=bt, live=live, t=t, kw=kw):
            return paged_attention_cuda(qh, lat[:, :, None, :], None, lq2,
                                        bt, live, t, v_rank=cs.DS_R, **kw)
        out.append((label, call, ref))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="16,8,32,32,8,16",
                    help="comma list: the order of the turns")
    rows = [int(r) for r in ap.parse_args(argv).rows.split(",")]
    import chip_smoke as cs
    from repro_torch.kernels import paged_attention as pa
    fns = build_variants(rows)
    timer = cs.Timer()
    todo = cases()
    for n in rows:
        pa._launcher = lambda fn=fns[n]: fn
        pa.WIDE_ROWS = n                # the split count of this row group
        for label, call, ref in todo:
            o = call().reshape(ref.shape)
            rel = ((o - ref).abs().max() / ref.abs().max()).item()
            if not rel <= cs.TOL:
                raise AssertionError(f"rows {n} {label}: rel {rel}")
            us = timer.ms(call, iters=100) * 1e3
            print(f"ROWS {n} {label} {us:.2f}us (rel {rel:.1e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
