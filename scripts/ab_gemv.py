"""Time ``gqsa_gemv`` of two checkouts in turns on one card.

    python3 scripts/ab_gemv.py parent=/path/to/parent change=. \\
        --order parent,change,change,parent,parent,change

Each turn is a fresh process that imports the named checkout's
``repro_torch`` and ``chip_smoke.py`` (so each builds its own kernels),
times one llama2-7b decode layer of GQSA W4 S50 G16 projections at 4
slots with bf16 x (``chip_smoke.Timer``: L2 flushed before every launch,
200 launches a shape) and prints ``RESULT <name> layer <us>``. Comparing
two versions inside one call on one card, in alternation, keeps the
card's power limit and neighbours out of the difference.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys


def time_layer(name: str, root: str) -> None:
    root = os.path.abspath(root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.gqsa_gemv import gqsa_gemv_cuda
    if not cs.__file__.startswith(root):
        raise RuntimeError(f"imported {cs.__file__}, not {root}")
    timer = cs.Timer()
    g = torch.Generator(device="cuda").manual_seed(3)
    total = 0.0
    for label, (n, k) in cs.SHAPES.items():
        bsr = cs._packed(n, k, 4)
        x = torch.randn((4, k), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        t = timer.ms(lambda: gqsa_gemv_cuda(x, bsr), iters=200)
        total += cs.PER_LAYER[label] * t
        print(f"  {name} {label}: {t * 1e3:.2f}us", flush=True)
    print(f"RESULT {name} layer {total * 1e3:.2f}us", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", metavar="NAME=PATH")
    ap.add_argument("--order", default=None,
                    help="comma list of names (default: each tree once)")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.trees)
    if args.one is not None:
        time_layer(args.one, trees[args.one])
        return 0
    order = args.order.split(",") if args.order else list(trees)
    for name in order:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        *args.trees, "--one", name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
