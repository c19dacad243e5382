"""Time ``paged_attention`` (bf16 pages, plain and tree modes) of two
checkouts in turns on one card.

    python3 scripts/ab_attention.py parent=/path/to/parent change=. \\
        --order parent,change,change,parent [--splits 1,2,4,8]

Each turn is a fresh process that imports the named checkout's
``repro_torch`` and ``chip_smoke.py`` (so each builds its own kernels) and
times the kernel wrapper alone, at 4 slots, KH=32, D=128, ps=16, on the
operands the dispatcher prepares (``chip_smoke.Timer``: L2 flushed before
every launch, 200 launches a case):
  * plain, T=1, lengths 20/25/31/29 (serve; with the 16-column table of
    256-token slots and with the 2 live columns the engine passes) and
    256 x 4;
  * tree, the (4,2,2) verify (T=29), lengths ~64 and ~256.
Inputs come from the same seed in every turn, and each turn checks its
output against the plain version first. ``--splits`` also times the named
split counts in turns whose wrapper takes ``n_split``. Prints ``RESULT
<name> <case> <us>`` lines. Comparing two versions inside one call on one
card, in alternation, keeps the card's power limit and neighbours out of
the difference.
"""
from __future__ import annotations

import argparse
import inspect
import os
import subprocess
import sys

# (label, tree fanout or None, lengths or window bases, table columns:
# None keeps the 16 of a 256-token slot, 2 is what the engine's decode
# step passes at serve lengths, its live width)
CASES = (("plain serve", None, [20, 25, 31, 29], None),
         ("plain serve, live table", None, [20, 25, 31, 29], 2),
         ("plain 256", None, [256] * 4, None),
         ("tree ~64", (4, 2, 2), [35, 40, 31, 38], None),
         ("tree ~256", (4, 2, 2), [227, 220, 225, 210], None))


def time_cases(name: str, root: str, splits) -> None:
    root = os.path.abspath(root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    if not cs.__file__.startswith(root):
        raise RuntimeError(f"imported {cs.__file__}, not {root}")
    from repro_torch.engine.spec import TreeTemplate
    takes_split = "n_split" in inspect.signature(
        paged_attention_cuda).parameters
    timer = cs.Timer()
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 12)
    b = 4
    for label, fanout, lens, cols in CASES:
        if fanout is None:           # lens are the lengths of T = 1 rows
            t, kw = 1, {}
            lq = torch.tensor(lens, dtype=torch.int32)[:, None]
        else:                        # lens are the slots' window bases
            spec = TreeTemplate(fanout).verify_tree("cuda")
            t, win = spec["anc"].shape[0], spec["window"]
            base = torch.tensor(lens, dtype=torch.int32)
            lq = (base + win)[:, None].expand(b, t).contiguous()
            kw = dict(anc=spec["anc"][None].expand(b, t).contiguous(),
                      anc_base=base.to("cuda"), window=win)
        q, kp, vp, lq, bt, _, _ = cs._attn_case(b, t, lq, torch.bfloat16, g)
        if cols is not None:
            bt = bt[:, :cols].contiguous()
        lq2, live = ops.paged_query_prep(lq, bt, b, t, kp.shape[1])
        qh = q.permute(0, 2, 1, 3).contiguous()         # [B, KH, T, D]

        def call(**extra):
            return paged_attention_cuda(qh, kp, vp, lq2, bt, live, t, **kw,
                                        **extra)

        o = call().reshape(b, 32, t, 128).permute(0, 2, 1, 3)
        ref = ops.paged_decode_attention(
            q, kp, vp, lq, bt, plain=True,
            **({} if fanout is None else dict(
                anc=kw["anc"], anc_base=kw["anc_base"],
                anc_window=kw["window"])))
        rel = ((o - ref).abs().max() / ref.abs().max()).item()
        if not rel <= cs.TOL:
            raise AssertionError(f"{name} {label}: rel {rel}")
        us = timer.ms(call, iters=200) * 1e3
        print(f"RESULT {name} {label} {us:.2f}us (rel {rel:.1e})",
              flush=True)
        for s in (splits if takes_split else ()):
            if s > bt.shape[1]:                 # at most a split a column
                continue
            us = timer.ms(lambda: call(n_split=s), iters=200) * 1e3
            print(f"RESULT {name} {label} S={s} {us:.2f}us", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", metavar="NAME=PATH")
    ap.add_argument("--order", default=None,
                    help="comma list of names (default: each tree once)")
    ap.add_argument("--splits", default="",
                    help="comma list of split counts to time as well")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.trees)
    splits = [int(s) for s in args.splits.split(",") if s]
    if args.one is not None:
        time_cases(args.one, trees[args.one], splits)
        return 0
    order = args.order.split(",") if args.order else list(trees)
    for name in order:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        *args.trees, "--splits", args.splits,
                        "--one", name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
