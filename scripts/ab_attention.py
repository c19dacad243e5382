"""Time ``paged_attention`` (plain, tree, int8 and latent modes) of two
checkouts in turns on one card.

    python3 scripts/ab_attention.py parent=/path/to/parent change=. \\
        --order parent,change,change,parent [--splits 1,2,4,8]

Each turn is a fresh process that imports the named checkout's
``repro_torch`` and ``chip_smoke.py`` (so each builds its own kernels) and
times the kernel wrapper alone, at 4 slots, ps=16, on the operands the
dispatcher prepares (``chip_smoke.Timer``: L2 flushed before every launch,
200 launches a case); each case also times SDPA on the same K/V gathered
(and dequantized) contiguous beforehand, as ``chip_smoke.py`` does, and
the plain version (30 launches):
  * plain (bf16 pages) and int8 (int8 pages + f32 scales), KH=32, D=128,
    T=1, lengths 20/25/31/29 (serve; with the 16-column table of 256-token
    slots and with the 2 live columns the engine passes) and 256 x 4;
  * tree, bf16, the (4,2,2) verify (T=29), lengths ~64 and ~256;
  * latent (DeepSeek-V2: H=128, D=576, v_rank 512, bf16), T=1 at the same
    serve lengths (both tables) and 256 x 4, and the (2,2) verify block
    (T=7) at ~256;
  * contiguous (``kv_decode_attention`` over a contiguous int8 cache:
    its own kernel, ``kv_decode_attention_cuda``, or in an older checkout
    the paged kernel's int8 mode over the cache viewed as pages of 64
    under identity tables), KH=32, R=1, D=128, full lengths 4096 and
    32768, and KH=8 at R=4 and R=7 (``CONTIGUOUS_HEADS``), 32768 (a
    checkout without the route skips them); ``--heads 4,8
    --stages 2,3,4`` also times those heads a block and ring depths of
    the kernel (each at its plan's split count).
``--cases`` keeps the cases whose label starts with one of its comma
list of prefixes.
Inputs come from the same seed in every turn, and each turn checks its
output against the plain version first. ``--splits`` also times the named
split counts in turns whose wrapper takes ``n_split`` in that mode (a
checkout whose int8 and latent modes ran the older walk ignores it there).
Prints ``RESULT <name> <case> <us>`` lines, a latent case with its bound
(:func:`latent_bound`). Comparing two versions inside one call on one
card, in alternation, keeps the card's power limit and neighbours out of
the difference.

    python3 scripts/ab_attention.py --bounds

prints the latent cases' bounds alone, from their shapes (no card).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

# (label, mode, tree fanout or None, lengths or window bases, table
# columns: None keeps the 16 of a 256-token slot, 2 is what the engine's
# decode step passes at serve lengths, its live width)
SERVE = [20, 25, 31, 29]
CASES = (("plain serve", "plain", None, SERVE, None),
         ("plain serve, live table", "plain", None, SERVE, 2),
         ("plain 256", "plain", None, [256] * 4, None),
         ("tree ~64", "plain", (4, 2, 2), [35, 40, 31, 38], None),
         ("tree ~256", "plain", (4, 2, 2), [227, 220, 225, 210], None),
         ("int8 serve", "int8", None, SERVE, None),
         ("int8 serve, live table", "int8", None, SERVE, 2),
         ("int8 256", "int8", None, [256] * 4, None),
         ("latent serve", "latent", None, SERVE, None),
         ("latent serve, live table", "latent", None, SERVE, 2),
         ("latent 256", "latent", None, [256] * 4, None),
         ("latent tree (2,2) ~256", "latent", (2, 2), [240, 235, 245, 230],
          None),
         ("contiguous 4096", "contiguous", None, [4096] * 4, None),
         ("contiguous 32768", "contiguous", None, [32768] * 4, None),
         ("contiguous R=4 32768", "contiguous", None, [32768] * 4, None),
         ("contiguous R=7 32768", "contiguous", None, [32768] * 4, None))
# (KV heads, query rows a KV head) of a contiguous case: llama2-7b's, or
# mistral-nemo-12b's and yi-34b's
CONTIGUOUS_HEADS = {"contiguous R=4 32768": (8, 4),
                    "contiguous R=7 32768": (8, 7)}


def _contiguous(cs, lens, g, kh=32, r=1):
    """The ``_operands`` of a contiguous int8 cache of max(lens)
    positions (``kh`` KV heads of ``r`` query rows), plus the count of
    columns ``--splits`` may take: through
    ``kv_decode_attention_cuda`` (32-position chunks), or, in a checkout
    without it, through the paged kernel's int8 mode over the cache
    viewed as pages of 64 (``ops.contiguous_pages``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    b = len(lens)
    q, k8, ks, v8, vs = cs._kv_cache_case(g, max(lens), b, kh, r)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if hasattr(ops, "contiguous_pages"):
        from repro_torch.kernels.paged_attention import paged_attention_cuda
        kp, ksp, vp, vsp, tables = ops.contiguous_pages(k8, ks, v8, vs)
        lq, live = ops.paged_query_prep(ln, tables, b, 1, kp.shape[1])
        cols = tables.shape[1]

        def call(**extra):
            return paged_attention_cuda(q, kp, vp, lq, tables, live, 1, ksp,
                                        vsp, contiguous=True, **extra)
    else:
        from repro_torch.kernels.kv_decode_attention import (
            CHUNK, kv_decode_attention_cuda)
        cols = -(-max(lens) // CHUNK)

        def call(**extra):
            return kv_decode_attention_cuda(q, k8, ks, v8, vs, ln, **extra)

    def plain():
        return ops.kv_decode_attention(q, k8, ks, v8, vs, ln, plain=True)
    kk, vv = ((c.float() * sc[..., None]).to(torch.bfloat16)
              .permute(0, 2, 1, 3).contiguous()
              for c, sc in ((k8, ks), (v8, vs)))
    qs = q.to(torch.bfloat16)
    return call, plain(), plain, lambda: F.scaled_dot_product_attention(
        qs, kk, vv), cols


def latent_bound(cs, fanout, lens):
    """(us, "bytes" or "operations", us at the f32 rate): the least time
    of a latent case on the card. Bytes: each live latent row once
    (bf16), q and the output once (f32). Operations: a score and a value
    product (D + v_rank multiply-adds) for every position a query row
    sees (the slot's base, plus its ancestors in a tree block), at the
    bf16 tensor cores' rate of ``chip_smoke``, and beside it at its f32
    rate, the rate of the kernel's CUDA-core products."""
    from repro_torch.engine.spec import TreeTemplate
    h, d, r = cs.DS_H, cs.DS_D, cs.DS_R
    if fanout is None:
        t, seen, rows = 1, sum(lens), sum(lens)
    else:
        spec = TreeTemplate(fanout).verify_tree("cpu")
        t = spec["anc"].shape[0]
        anc = sum(bin(int(a)).count("1") for a in spec["anc"])
        seen = t * sum(lens) + len(lens) * anc
        rows = sum(lens) + len(lens) * spec["window"]
    nbytes = rows * d * 2 + len(lens) * t * h * (d + r) * 4
    flops = 2 * h * seen * (d + r)
    return (1e3 * cs._bound_ms(nbytes, flops), cs._bound_by(nbytes, flops),
            1e3 * cs._bound_ms(nbytes, flops, cs.F32_FLOP_PER_S))


def _operands(cs, mode, fanout, lens, cols, g):
    """(call(**extra), plain output, plain call, SDPA call) of one case:
    the kernel wrapper on the dispatcher's operands, its output in the
    dispatcher's layout."""
    import torch
    import torch.nn.functional as F
    from repro_torch.engine.spec import TreeTemplate
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.layers import ancestor_mask
    b = 4
    if fanout is None:               # lens are the lengths of T = 1 rows
        t, kw = 1, {}
        lq = torch.tensor(lens, dtype=torch.int32)[:, None]
    else:                            # lens are the slots' window bases
        spec = TreeTemplate(fanout).verify_tree("cuda")
        t, win = spec["anc"].shape[0], spec["window"]
        base = torch.tensor(lens, dtype=torch.int32)
        lq = (base + win)[:, None].expand(b, t).contiguous()
        kw = dict(anc=spec["anc"][None].expand(b, t).contiguous(),
                  anc_base=base.to("cuda"), window=win)
    pkw = {} if fanout is None else dict(
        anc=kw["anc"], anc_base=kw["anc_base"], anc_window=kw["window"])
    latent = mode == "latent"
    if latent:
        q, kp, lq, bt = cs._latent_case(b, t, lq, torch.bfloat16, g)
        vp = ks = vs = None
        h, d, dv, khn = cs.DS_H, cs.DS_D, cs.DS_R, 1
    else:
        q, kp, vp, lq, bt, ks, vs = cs._attn_case(
            b, t, lq, torch.int8 if mode == "int8" else torch.bfloat16, g)
        h, d, dv, khn = 32, 128, 128, 32
    if cols is not None:
        bt = bt[:, :cols].contiguous()
    lq2, live = ops.paged_query_prep(lq, bt, b, t, kp.shape[1])
    qh = q.reshape(b, t, khn, h // khn, d).permute(0, 2, 1, 3, 4) \
          .reshape(b, khn, -1, d).contiguous()
    pages = kp[:, :, None, :] if latent else kp

    def call(**extra):
        o = paged_attention_cuda(qh, pages, vp, lq2, bt, live, t, ks, vs,
                                 v_rank=dv if latent else 0, **kw, **extra)
        return o.reshape(b, khn, t, h // khn, dv).permute(0, 2, 1, 3, 4) \
                .reshape(b, t, h, dv)

    def plain():
        if latent:
            return ops.paged_latent_attention(q, kp, lq, bt, v_rank=dv,
                                              plain=True, **pkw)
        return ops.paged_decode_attention(q, kp, vp, lq, bt, ks, vs,
                                          plain=True, **pkw)
    ref = plain()
    # SDPA on K/V gathered (and dequantized) contiguous beforehand
    smax = int(lq.max())
    bti = bt.clamp(max=kp.shape[0] - 1).long()

    def gathered(pg, sc):
        x = pg[bti].float()
        if sc is not None:
            x = x * sc[bti][..., None]
        return x.reshape(b, -1, khn, d)[:, :smax].permute(0, 2, 1, 3) \
                .to(torch.bfloat16).contiguous()
    kk = gathered(pages, ks)
    vv = kk[..., :dv].contiguous() if latent else gathered(vp, vs)
    qs = qh.to(torch.bfloat16)
    if fanout is None:
        mask = (torch.arange(smax, device="cuda")[None, :]
                < lq.to("cuda"))[:, None, None, :]
    else:
        mask = ancestor_mask(lq, pkw["anc"], pkw["anc_base"],
                             pkw["anc_window"], b, t, smax)[:, None]
        if latent:                   # rows are (t, h): repeat t's mask
            mask = mask.repeat_interleave(h, dim=2)

    def sdpa():
        return F.scaled_dot_product_attention(qs, kk, vv, attn_mask=mask)
    return call, ref, plain, sdpa


def _sweep(name, label, call, lens, timer, sweep):
    """Time ``kv_decode_attention_cuda`` at every (heads, stages) of
    ``sweep``, as :func:`plan` takes them (too deep a ring is cut to what
    fits), each at the plan's split count."""
    import torch
    from repro_torch.kernels.kv_decode_attention import plan
    from repro_torch.kernels.build import sm_count
    heads, stages = sweep
    sms = sm_count(torch.cuda.current_device())
    for h in heads:
        for st in stages:
            p = plan(len(lens), 32, max(lens), 1, 128, sms, h, st)
            if p.stages != st:
                continue
            us = timer.ms(lambda: call(heads=h, stages=st), iters=200) * 1e3
            print(f"RESULT {name} {label} heads={h} stages={st} "
                  f"S={p.n_split} {us:.2f}us (smem {p.smem})", flush=True)


def time_cases(name: str, root: str, splits, prefixes=(),
               sweep=None) -> None:
    root = os.path.abspath(root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    if not cs.__file__.startswith(root):
        raise RuntimeError(f"imported {cs.__file__}, not {root}")
    # a wrapper with WIDE_ROWS takes n_split in every mode; the older one
    # in the plain and tree modes only
    every_mode = hasattr(pa, "WIDE_ROWS")
    timer = cs.Timer()
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 12)
    for label, mode, fanout, lens, cols in CASES:
        if prefixes and not label.startswith(tuple(prefixes)):
            continue
        if mode == "contiguous":
            if not hasattr(cs, "_kv_cache_case"):
                continue
            call, ref, plain, sdpa, cols = _contiguous(
                cs, lens, g, *CONTIGUOUS_HEADS.get(label, (32, 1)))
        else:
            call, ref, plain, sdpa = _operands(cs, mode, fanout, lens, cols,
                                               g)
        o = call()
        rel = ((o - ref).abs().max() / ref.abs().max()).item()
        if not rel <= cs.TOL:
            raise AssertionError(f"{name} {label}: rel {rel}")
        us = timer.ms(call, iters=200) * 1e3
        sd = timer.ms(sdpa, iters=200) * 1e3
        pl = timer.ms(plain, iters=30) * 1e3
        bound = ""
        if mode == "latent":
            bound = ("; bound %.2fus by %s (f32 rate %.2fus)"
                     % latent_bound(cs, fanout, lens))
        print(f"RESULT {name} {label} {us:.2f}us (rel {rel:.1e}; sdpa "
              f"{sd:.2f}us; plain {pl:.1f}us{bound})", flush=True)
        if mode == "contiguous" and sweep and not hasattr(
                ops, "contiguous_pages"):
            _sweep(name, label, call, lens, timer, sweep)
        if mode not in ("plain", "contiguous") and not every_mode:
            continue
        for s in splits:
            if s > (cols or 16):                # at most a split a column
                continue
            us = timer.ms(lambda: call(n_split=s), iters=200) * 1e3
            print(f"RESULT {name} {label} S={s} {us:.2f}us", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", metavar="NAME=PATH")
    ap.add_argument("--bounds", action="store_true",
                    help="print the latent cases' bounds and stop")
    ap.add_argument("--order", default=None,
                    help="comma list of names (default: each tree once)")
    ap.add_argument("--splits", default="",
                    help="comma list of split counts to time as well")
    ap.add_argument("--cases", default="",
                    help="comma list of case-label prefixes to time")
    ap.add_argument("--heads", default="",
                    help="contiguous cases: comma list of heads a block "
                         "to sweep (with --stages)")
    ap.add_argument("--stages", default="",
                    help="contiguous cases: comma list of ring stages")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.bounds:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        sys.path[:0] = [os.path.join(root, "src"), root]
        import chip_smoke as cs
        for label, mode, fanout, lens, _ in CASES:
            if mode == "latent":
                print("BOUND %s %.2fus by %s (f32 rate %.2fus)"
                      % ((label,) + latent_bound(cs, fanout, lens)))
        return 0
    trees = dict(t.split("=", 1) for t in args.trees)
    splits = [int(s) for s in args.splits.split(",") if s]
    prefixes = [c for c in args.cases.split(",") if c]
    sweep = None
    if args.heads or args.stages:
        sweep = ([int(h) for h in (args.heads or "8").split(",")],
                 [int(t) for t in (args.stages or "3").split(",")])
    if args.one is not None:
        time_cases(args.one, trees[args.one], splits, prefixes, sweep)
        return 0
    order = args.order.split(",") if args.order else list(trees)
    for name in order:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        *args.trees, "--splits", args.splits,
                        "--cases", args.cases, "--heads", args.heads,
                        "--stages", args.stages,
                        "--one", name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
