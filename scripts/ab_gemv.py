"""Time ``gqsa_gemv``, its expert axis or ``w4_matmul`` of two checkouts in
turns on one card.

    python3 scripts/ab_gemv.py parent=/path/to/parent change=. \\
        --order parent,change,change,parent \\
        [--kernel {gqsa_gemv,gqsa_gemv_experts,w4_matmul}]

Each turn is a fresh process that imports the named checkout's
``repro_torch`` and ``chip_smoke.py`` (so each builds its own kernels) and
times one layer (``chip_smoke.Timer``: L2 flushed before every launch,
100-200 launches a shape), bf16 x:
  * ``--kernel gqsa_gemv`` (default): the 7 GQSA W4 S50 G16 projections
    of llama2-7b
    through ``ops.gqsa_gemv`` (the checkout's dispatcher, one launch or
    several) at T = 4 (decode, 4 slots), 64 (prefill rows) and 116 (a
    (4,2,2) tree verify of 4 slots), each beside ``torch.matmul`` on the
    dense bf16 W and the bound (the larger of the bytes over 3.35 TB/s and
    the multiply-adds, bf16 x by 4-bit codes, over the tensor cores' 989
    TFLOP/s); prints ``RESULT <name>
    gqsa_gemv T=<t> layer <us> matmul <us> bound <us>``;
  * ``--kernel gqsa_gemv_experts``: one MoE layer's three routed-expert
    projections (w_g, w_u, w_d) through ``ops.gqsa_gemv_experts`` (the
    checkout's dispatcher, one launch or several), for DeepSeek-V2 (160
    experts) and deepseek-moe-16b (64), at capacity C = 1 (one 4-slot
    decode step's routed rows), 7 and 30 (a prefill dispatch of ceil(C x
    E / 7.5) routed rows, top-6 distinct experts each), beside the bound
    (the occupied experts' payload, their filled x rows and the whole y
    over 3.35 TB/s, or the multiply-adds over 989 TFLOP/s); the operands
    come from a fixed seed, the same in both checkouts; prints ``RESULT
    <name> experts <model> C=<c> layer <us> bound <us>``;
  * ``--kernel w4_matmul``: llama2-7b's 7 dense W4 G16 projections at T = 4
    (decode) and T = 64 (prefill rows), each beside ``torch.matmul`` on the
    dequantized dense bf16 W and the byte bound; prints ``RESULT <name>
    w4 T=<t> layer <us> matmul <us> bound <us>``.
Comparing two versions inside one call on one card, in alternation, keeps
the card's power limit and neighbours out of the difference.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys


def _import(root: str):
    root = os.path.abspath(root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import chip_smoke as cs
    if not cs.__file__.startswith(root):
        raise RuntimeError(f"imported {cs.__file__}, not {root}")
    return cs


def time_layer(name: str, root: str) -> None:
    import torch
    cs = _import(root)
    from repro_torch.core.bsr import to_dense
    from repro_torch.kernels import ops
    timer = cs.Timer()
    g = torch.Generator(device="cuda").manual_seed(3)
    packed = {label: cs._packed(n, k, 4)
              for label, (n, k) in cs.SHAPES.items()}
    for rows in (4, 64, 116):
        tot = dict(kernel=0.0, matmul=0.0, bound=0.0)
        for label, bsr in packed.items():
            n, k = bsr.shape
            m = bsr.idx.shape[1]
            x = torch.randn((rows, k), generator=g, device="cuda",
                            dtype=torch.bfloat16)
            dense = to_dense(bsr).to(torch.bfloat16)
            nbytes = n * m * 20 + rows * k * 2 + rows * n * 4
            bound = 1e3 * max(nbytes / cs.HBM_BYTES_PER_S,
                              2 * rows * n * m * 16 / cs.BF16_TC_FLOP_PER_S)
            c = cs.PER_LAYER[label]
            t_k = timer.ms(lambda: ops.gqsa_gemv(x, bsr), iters=100)
            t_l = timer.ms(lambda: torch.matmul(x, dense.T), iters=100)
            for key, v in (("kernel", t_k), ("matmul", t_l),
                           ("bound", bound)):
                tot[key] += c * v
            print(f"  {name} T={rows} {label}: {t_k * 1e3:.2f}us "
                  f"(matmul {t_l * 1e3:.2f}us, bound {bound * 1e3:.2f}us)",
                  flush=True)
            del dense
        print(f"RESULT {name} gqsa_gemv T={rows} layer "
              f"{tot['kernel'] * 1e3:.2f}us matmul {tot['matmul'] * 1e3:.2f}us"
              f" bound {tot['bound'] * 1e3:.2f}us", flush=True)


EXPERT_MODELS = {
    "deepseek-v2": (160, {"wg/wu": (1536, 5120), "wd": (5120, 1536)}),
    "deepseek-moe-16b": (64, {"wg/wu": (1408, 2048), "wd": (2048, 1408)}),
}


def time_experts_layer(name: str, root: str) -> None:
    import math
    import torch
    cs = _import(root)
    from repro_torch.kernels import ops
    timer = cs.Timer()
    for model, (e, shapes) in EXPERT_MODELS.items():
        packed = {label: cs._experts_packed(n, k, 4, e)
                  for label, (n, k) in shapes.items()}
        for cap in (1, 7, 30):
            g = torch.Generator(device="cuda").manual_seed(3 + cap)
            tokens = 4 if cap == 1 else math.ceil(cap * e / 7.5)
            ids = torch.stack([torch.randperm(e, generator=g,
                                              device="cuda")[:6]
                               for _ in range(tokens)]).reshape(-1)
            rows = torch.bincount(ids, minlength=e).clamp(max=cap) \
                .to(torch.int32)
            keep = torch.arange(cap, device="cuda")[None, :] < rows[:, None]
            n_occ, n_rows = int((rows > 0).sum()), int(rows.sum())
            tot = dict(kernel=0.0, bound=0.0)
            for label, (n, k) in shapes.items():
                bsr = packed[label]
                m = bsr.idx.shape[-1]
                x = torch.randn((e, cap, k), generator=g, device="cuda",
                                dtype=torch.bfloat16) * keep[..., None]
                nbytes = n_occ * n * m * 20 + n_rows * k * 2 + e * cap * n * 4
                bound = 1e3 * max(nbytes / cs.HBM_BYTES_PER_S,
                                  2 * n_rows * n * m * 16
                                  / cs.BF16_TC_FLOP_PER_S)
                t_k = timer.ms(lambda: ops.gqsa_gemv_experts(x, bsr, rows),
                               iters=100)
                c = 2 if label == "wg/wu" else 1
                tot["kernel"] += c * t_k
                tot["bound"] += c * bound
                print(f"  {name} {model} C={cap} {label}: {t_k * 1e3:.2f}us "
                      f"(bound {bound * 1e3:.2f}us)", flush=True)
            print(f"RESULT {name} experts {model} C={cap} layer "
                  f"{tot['kernel'] * 1e3:.2f}us bound "
                  f"{tot['bound'] * 1e3:.2f}us ({n_occ} of {e} occupied, "
                  f"{n_rows} rows)", flush=True)
        del packed


def time_w4_layer(name: str, root: str) -> None:
    import torch
    cs = _import(root)
    from repro_torch.core.quant import QuantConfig, dequantize, unpack_int4
    from repro_torch.kernels.w4_matmul import w4_matmul_cuda
    timer = cs.Timer()
    g = torch.Generator(device="cuda").manual_seed(3)
    for rows in (4, 64):
        tot = dict(kernel=0.0, matmul=0.0, bound=0.0)
        for label, (n, k) in cs.SHAPES.items():
            p = cs._w4_packed(n, k, 4)
            args = (p["qw"], p["scale"], p["zero"], 16)
            x = torch.randn((rows, k), generator=g, device="cuda",
                            dtype=torch.bfloat16)
            dense = dequantize(unpack_int4(p["qw"]), p["scale"], p["zero"],
                               QuantConfig(group_size=16), torch.bfloat16)
            nbytes = (n * k // 2 + 8 * n * (k // 16) + rows * k * 2
                      + rows * n * 4)
            c = cs.PER_LAYER[label]
            t_k = timer.ms(lambda: w4_matmul_cuda(x, *args), iters=200)
            t_l = timer.ms(lambda: torch.matmul(x, dense.T), iters=200)
            bound = 1e3 * nbytes / cs.HBM_BYTES_PER_S
            for key, v in (("kernel", t_k), ("matmul", t_l),
                           ("bound", bound)):
                tot[key] += c * v
            print(f"  {name} T={rows} {label}: {t_k * 1e3:.2f}us "
                  f"(matmul {t_l * 1e3:.2f}us, bound {bound * 1e3:.2f}us)",
                  flush=True)
            del dense
        print(f"RESULT {name} w4 T={rows} layer {tot['kernel'] * 1e3:.2f}us "
              f"matmul {tot['matmul'] * 1e3:.2f}us bound "
              f"{tot['bound'] * 1e3:.2f}us", flush=True)


TIMERS = {"gqsa_gemv": time_layer, "gqsa_gemv_experts": time_experts_layer,
          "w4_matmul": time_w4_layer}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", metavar="NAME=PATH")
    ap.add_argument("--order", default=None,
                    help="comma list of names (default: each tree once)")
    ap.add_argument("--kernel", default="gqsa_gemv",
                    choices=tuple(TIMERS))
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.trees)
    if args.one is not None:
        TIMERS[args.kernel](args.one, trees[args.one])
        return 0
    order = args.order.split(",") if args.order else list(trees)
    smi = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    subprocess.run(smi, check=True)
    for name in order:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        *args.trees, "--kernel", args.kernel, "--one", name],
                       check=True)
    subprocess.run(smi, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
