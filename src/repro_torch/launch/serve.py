"""Serving CLI: a thin wrapper over the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --compress gqsa --slots 4 --requests 8 --max-new 32 --max-seq 256

``--compress w4`` serves the quantization-only baseline (dense W4, the
paper's W4A16 rows) instead of GQSA; ``none`` the FP model.

``--spec K`` (chain) or ``--spec-tree F1,F2,..`` (token tree, optionally
``--spec-adaptive``) serves with self-speculative decoding: a draft
profile (``--draft-profile``) of the same drawn weights drafts, the
target verifies; greedy output equals the output without speculation.

``--prefix-cache`` turns on shared-prefix KV reuse: admissions map a
prompt's cached full-page prefix onto existing pages and prefill only the
unshared tail; a ``[prefix]`` line of its counters follows the summary.
The CLI's own prompts (4-15 tokens) fill no page of 16, so here it shows
misses only; hits come with longer shared prompts through the engine.

``--chunked-prefill N`` splits every admitted prompt longer than N tokens
into N-token chunks fed between decode steps instead of one prefill
(greedy output is the same as without it).

Runs on the card (``--device cuda``, the default; it raises when there is
none) or, when asked, on the CPU (``--device cpu``) through the kernels'
plain versions. Requests are admitted in FIFO order into a fixed pool of
batch slots backed by a paged KV cache; prompts are prefilled in one
batched call and decode runs one fused per-slot-position step with
device-side token feedback. Prints tokens/s, TTFT, TPOT and p50/p99
latency, then a ``[digest]`` of the generated tokens.
"""
from __future__ import annotations

import argparse
import hashlib
import time
from typing import List

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, list_draft_profiles
from repro_torch.core.model_compress import draft_layers
from repro_torch.core.gqs_layer import GQSAConfig
from repro_torch.core.pruning import PruneConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.engine import (EngineConfig, InferenceEngine,
                                SamplingParams, Telemetry)
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import init_params_and_draft


def make_requests(n, vocab, rng, lo=4, hi=16):
    lens = rng.integers(lo, hi, size=n)
    return [rng.integers(0, vocab, size=l).astype(np.int32) for l in lens]


def compressed_params(cfg, args, device, spec: bool = False):
    """Seeded params; with ``--compress gqsa`` or ``w4`` packed layer by
    layer as they are drawn (the full f32 model never exists). With
    ``spec`` the draft profile ``--draft-profile`` is packed from the same
    draws: returns ``(params, draft_params or None)``."""
    t0 = time.time()
    compress = None
    if args.compress == "gqsa":
        compress = GQSAConfig(
            quant=QuantConfig(bits=4, group_size=args.group_size),
            prune=PruneConfig(sparsity=args.sparsity,
                              group_size=args.group_size))
    elif args.compress == "w4":
        compress = QuantConfig(bits=4, group_size=args.group_size)
    draft = None
    if spec:
        params, draft = init_params_and_draft(
            args.seed, cfg, args.draft_profile, device, compress=compress,
            group_size=args.group_size)
    else:
        params = get_model(cfg).init_params(args.seed, cfg, device,
                                            compress=compress)
    if args.compress == "gqsa":
        print(f"packed GQSA W4 S{int(args.sparsity*100)}% "
              f"G{args.group_size} in {time.time()-t0:.1f}s")
    elif args.compress == "w4":
        print(f"packed W4 in {time.time()-t0:.1f}s")
    if spec:
        print(f"packed draft profile {args.draft_profile} "
              f"({draft_layers(cfg, args.draft_profile)}/{cfg.n_layers} "
              f"layers) from the same weights")
    return params, draft


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2_7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="full-scale params (default: reduced config)")
    ap.add_argument("--compress", default="gqsa",
                    choices=["none", "w4", "gqsa"])
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--group-size", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="KV page pool size (default: slots*max_seq worth)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="shared-prefix KV reuse (DESIGN.md §13): radix "
                         "cache of full-page prompt blocks; admissions "
                         "map cached prefixes to existing pages "
                         "(refcounted, copy-on-write) and prefill only "
                         "the unshared tail; lossless for greedy")
    ap.add_argument("--chunked-prefill", type=int, default=0, metavar="N",
                    help="chunked prefill (DESIGN.md §14): split admitted "
                         "prompts into N-token chunks fed between decode "
                         "steps instead of one monolithic prefill; bounds "
                         "the stall a prefill puts on co-resident decodes; "
                         "lossless for greedy (0 = off)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--spec", type=int, default=0, metavar="K",
                    help="speculative decoding: draft K tokens per round "
                         "(0 = off); lossless — output matches non-spec")
    ap.add_argument("--spec-tree", default=None, metavar="F1,F2,..",
                    help="token-TREE drafting: top-k fanout per draft "
                         "depth (e.g. 4,2,2 = 28 nodes / depth 3); one "
                         "tree-attention verify call per round; implies "
                         "--spec; lossless like the chain")
    ap.add_argument("--spec-adaptive", action="store_true",
                    help="retune the tree online from the observed "
                         "acceptance rate (per-slot EWMA: thrash shrinks "
                         "to a chain K=1, sustained acceptance widens "
                         "back to the full --spec-tree profile)")
    ap.add_argument("--draft-profile", default="w4s75",
                    choices=list_draft_profiles(),
                    help="draft compression of the same weights")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu "
                         "(the kernels' plain versions)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record phase spans + per-request flow events "
                         "and export Chrome trace-event JSON; also prints "
                         "the phase breakdown after the run")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    metavar="SEC",
                    help="print a one-line engine stats snapshot every "
                         "SEC seconds of serving (0 = off)")
    args = ap.parse_args(argv)

    spec_fanout = None
    if args.spec_tree:
        try:
            spec_fanout = tuple(int(f) for f in args.spec_tree.split(","))
        except ValueError:
            ap.error(f"--spec-tree wants a comma list of fanouts, "
                     f"got {args.spec_tree!r}")
    spec_on = args.spec > 0 or spec_fanout is not None
    if args.spec_adaptive and spec_fanout is None:
        ap.error("--spec-adaptive requires --spec-tree")

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    params, draft_params = compressed_params(cfg, args, device, spec_on)
    if spec_fanout is not None:
        print(f"token-tree drafting: fanout {spec_fanout}"
              + (" (adaptive)" if args.spec_adaptive else ""))
    telemetry = Telemetry(trace=args.trace is not None,
                          stats_interval_s=args.stats_interval)
    engine = InferenceEngine(
        cfg, params,
        EngineConfig(num_slots=args.slots, max_seq=args.max_seq,
                     page_size=args.page_size, num_pages=args.num_pages,
                     prefix_cache=args.prefix_cache,
                     prefill_chunk_tokens=args.chunked_prefill,
                     seed=args.seed, device=str(device), spec_k=args.spec,
                     spec_draft_layers=(draft_layers(cfg, args.draft_profile)
                                        if spec_on else None),
                     spec_fanout=spec_fanout,
                     spec_adaptive=args.spec_adaptive),
        SamplingParams(temperature=args.temperature, top_k=args.top_k,
                       top_p=args.top_p),
        draft_params=draft_params, telemetry=telemetry)

    nprng = np.random.default_rng(args.seed)
    # prompts must leave room for the generation budget within max_seq
    maxlen = args.max_seq - args.max_new
    if maxlen < 1:
        ap.error(f"--max-new {args.max_new} leaves no prompt room "
                 f"within --max-seq {args.max_seq}")
    lo = min(4, maxlen)
    hi = max(lo + 1, min(16, maxlen + 1))
    prompts: List[np.ndarray] = make_requests(args.requests, cfg.vocab,
                                              nprng, lo=lo, hi=hi)
    for p in prompts:
        engine.submit(p, args.max_new)
    out = engine.run()

    m = out["metrics"]
    print(engine.metrics.format_summary()
          + f" ({args.slots} slots, {m['decode_steps']} decode steps)")
    # results digest: sha256 over (rid, tokens) in rid order
    h = hashlib.sha256()
    for r in sorted(out["results"], key=lambda d: d["rid"]):
        h.update(np.int64(r["rid"]).tobytes())
        h.update(np.asarray(r["tokens"], np.int32).tobytes())
    print(f"[digest] {h.hexdigest()}")
    if args.prefix_cache:
        reg = telemetry.registry
        print("[prefix] hits="
              f"{int(reg.counter('prefix.hits').value)} "
              f"misses={int(reg.counter('prefix.misses').value)} "
              f"hit_tokens={int(reg.counter('prefix.hit_tokens').value)} "
              f"cow={int(reg.counter('prefix.cow_copies').value)} "
              f"evicted={int(reg.counter('prefix.evicted_pages').value)} "
              f"cached={int(reg.gauge('prefix.cached_pages').value)}")
    if args.trace is not None:
        path = telemetry.tracer.export(args.trace)
        totals = telemetry.tracer.phase_totals()
        print(f"wrote trace ({len(telemetry.tracer.events)} events) -> "
              f"{path}")
        for name, d in sorted(totals.items(), key=lambda kv: -kv[1]["ms"]):
            print(f"  {name:16s} {d['ms']:9.2f}ms  x{d['count']}")
    return dict(m, requests=int(m["requests"]), tokens=int(m["tokens"]),
                results=out["results"])


if __name__ == "__main__":
    main()
