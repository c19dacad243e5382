"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line is printed):
  1. the card's name and power limit;
  2. build every hand-written kernel (one nvcc per source, in parallel)
     and print the ptxas report (registers, shared memory, spills);
  3. gqsa_gemv against its plain version at the full llama2-7b shapes and
     a ragged packing, T in {1, 4, 8, 9, 20, 64, 116}, bf16 and f32 x, one
     launch a call, repeats bit-identical;
  4. paged attention against its plain version at full width, in plain
     mode (bf16/f32 pages) and in int8 mode (int8 pages + f32 scales),
     at the default split count and at S in {1, 2, the table's width},
     with length-0 rows exact zeros and repeats bit-identical;
  5. w4_matmul against its plain version at the full llama2-7b shapes,
     T in {1, 4, 8, 64, 200}, plus an unaligned small case and a G128 case,
     each with its path (tensor or CUDA cores) and split count, repeats
     bit-identical;
  6. timing of every kernel at the full-width decode shapes (CUDA events,
     L2 flushed before every launch, as the decode loop finds it cold),
     beside the plain version, a library yardstick and the bound;
     gqsa_gemv also at T = 64 (prefill rows) and T = 116 (a tree verify),
     w4_matmul also at T = 64, and the launch floor (a w4_matmul launch
     at T = 1, N = 32, K = 64);
  7. full-width llama2-7b (GQSA W4 S50 G16, random seeded weights, packed
     on the card layer by layer): one batched prefill + 4 decode steps
     through the kernels and through the plain versions, compared in f32
     and in bf16 compute, with the bf16 pool and with the int8 pool; a
     profiled bf16 decode step; then the int8-pool main path: the engine
     serves 8 requests x 32 new tokens on 4 slots;
  8. the same model check for the dense-W4 baseline (packed on the card),
     and a profiled bf16 W4 decode step;
  9. the main paths of the serve CLI at full width, 4 slots, 8 requests x
     32 new tokens: ``--compress gqsa``, then ``--compress w4``;
 10. the tree mode of paged attention against its plain version at full
     width (bf16, f32 and int8 pages; the verify blocks of fanouts
     (4, 2, 2), (2, 2, 2, 2), the chain (1, 1, 1, 1) and (1,), the
     draft's level calls, a window narrower than T; slots of length 0;
     each at S in {1, 2, the table's width} too; the (4, 2, 2) block and
     its level calls also at deepseek-moe-16b's 16 KV heads), and its
     timing at the verify shape (B=4, T=29, lengths ~64 and ~256);
 11. speculation against no speculation at full width in f32 compute, in
     the engine (GQSA target): chain K=4 with draft w4s50, tree (4, 2, 2)
     with w4s50 and with w4l25; greedy tokens equal, where they differ
     only at a top-2 margin under the stated bound;
 12. the speculative main paths of the serve CLI at full width, bf16:
     ``--spec 4 --draft-profile w4s75``, ``--spec-tree 4,2,2
     --draft-profile w4l25`` and ``--spec-tree 4,2,2 --spec-adaptive
     --draft-profile w4s75``;
 13. the latent mode of paged attention against its plain version at
     DeepSeek-V2 width (B=4 slots plus two of length 0, H=128, D=576,
     v_rank 512, ps=16; bf16 and f32 pages; serve lengths, 256, the T=2
     staircase, the (2, 2) and (4, 2, 2) tree blocks and the (4, 2, 2)
     draft's level calls; each at S in {1, 2, the table's width} too,
     repeats bit-identical), and the expert axis of gqsa_gemv at the
     DeepSeek-V2 (160 experts) and deepseek-moe-16b (64) expert shapes, C
     in {1, 2, 3, 5, 7, 9, 13, 30}, with and without ``rows``: one launch
     a call,
     idle rows exact zeros, repeats bit-identical, and idle experts with
     NaN scales (x NaN past every expert's rows) leaving the output equal
     to the plain version's; both timed: the expert axis for a DeepSeek-V2
     and a deepseek-moe-16b decode layer and three prefill dispatches (C =
     3, 7, 30), and single-matrix gqsa_gemv at DeepSeek-V2's kv_a;
 14. DeepSeek-V2 (``deepseek_v2_236b``) at full width and 8 of its 60
     layers, GQSA W4 S50 G16 packed on the card expert by expert: kernel
     vs plain logits on 2 of the 8 layers (prefill + 4 decode steps, f32
     and bf16), a profiled decode step, and its main path: the engine
     serves 8 requests x 32 new tokens on 4 slots;
 15. the expert axis of w4_matmul against its plain version at the
     deepseek-moe-16b (64 experts) and DeepSeek-V2 (160) expert shapes,
     C in {1, 2, 3, 5, 8, 13, 20}, bf16 and f32 x, with and without
     ``rows``, and a
     CUDA-core shape: one launch a call, idle rows exact zeros, repeats
     bit-identical, and idle experts with NaN scales (x NaN past every
     expert's rows) leaving every output finite; then one decode layer's
     three expert projections timed, for both models;
 16. deepseek-moe-16b (``deepseek_moe_16b``, the ``moe`` family) at full
     width and all 28 layers, under GQSA W4 S50 G16 and under dense W4
     G16, packed on the card expert by expert: kernel vs plain logits on
     its first 4 layers, a profiled bf16 decode step of all 28; then its
     main paths, the serve CLI with ``--compress gqsa`` and ``--compress
     w4`` (4 slots, 8 requests x 32 new tokens);
 17. DeepSeek-V2 under dense W4 G16 at 4 of its 60 layers: kernel vs
     plain logits on 2 layers and the engine serving 8 requests x 32 new
     tokens on 4 slots;
 18. the static-batch contiguous path: kv_decode_attention (its own
     kernel over the contiguous int8 cache) against its plain version at
     B=4 KH=32 R=1 D=128, S in {64, 1000, 4096, 32768}, shared, per-slot
     (a row of 0: exact zeros) and full lengths, one launch a call,
     repeats bit-identical; timed at 4096 and 32768 beside the plain
     version, SDPA and the bound; llama2-7b at
     full width and depth (GQSA W4 S50 G16): the serve step through the
     kernels against the plain versions on an int8 cache of 4096
     positions (f32 and bf16), f32 serve steps against the prefill
     step's forward at every prompt position, the main path (bf16, int8
     cache of 32768 positions, 4 sequences x 32 greedy tokens after their
     teacher-forced prompts) and a profiled decode step at 32704
     positions of synthetic history;
 19. speculation on the MoE families: (a) against no speculation in the
     f32 engine, dropless (capacity factor 11 / 27), GQSA target, 8
     requests x 32 tokens on 4 slots: deepseek-moe-16b at full width and
     all 28 layers, chain K=4 (draft w4s50) and tree (4, 2, 2) (draft
     w4l25), and DeepSeek-V2 at full width and 4 layers, tree (4, 2, 2)
     (draft w4l25); greedy tokens equal, where they differ only at a
     top-2 margin under the stated bound; (b) the served paths, bf16, the
     configs' capacity factor: the serve CLI on deepseek-moe-16b (28
     layers) with ``--compress gqsa --spec 4 --draft-profile w4s75``,
     ``--compress gqsa --spec-tree 4,2,2 --draft-profile w4l25`` and
     ``--compress w4 --spec-tree 4,2,2 --draft-profile w4l25``, and the
     engine on DeepSeek-V2 at 8 layers, GQSA, tree (4, 2, 2), draft
     w4l25; every run's launches of every kernel equal the count its
     rounds, prefills and layer structure give (the tree mode on
     deepseek-moe-16b, the latent mode with tree operands on DeepSeek-V2,
     the GQSA expert axis in every verify, the W4 expert axis on the
     tensor cores in every w4l25 draft call); a profiled (4, 2, 2)
     verify step of deepseek-moe-16b; (c) timing at those shapes, each
     kernel beside its plain version: the tree mode at KH=16, the latent
     mode on a (4, 2, 2) block (T=29), ~64 and ~256 each (the kernel's
     output required to agree with the plain version's), and both expert
     axes at verify capacities (deepseek-moe-16b C = 2 and 13,
     DeepSeek-V2 C = 5) with the buffer rows of a verify dispatch
     recorded on the served paths of (b);
 20. gqsa_gemv at group sizes 8, 32, 64 and 128 (phases 3-19 run at 16,
     the paper's; above 32 a kept group is g / 32 parts of 32 codes): (a)
     against its plain version as phase 3 holds it (the llama2-7b shapes
     and a ragged packing, T in GEMV_ROWS, bf16 and f32 x, one launch a
     call, repeats bit-identical; at 128 also DeepSeek-V2's kv_a); (b)
     its expert axis as phase 13 holds it, at the DeepSeek-V2 and
     deepseek-moe-16b expert shapes, C in {1, 5, 13, 30}, with and
     without ``rows``, NaN-poisoned idle experts; (c) a llama2-7b layer
     at T = 4, 64 and 116 and a deepseek-moe-16b expert layer at C = 1
     (at 128 also kv_a at T = 4) timed beside the plain version, the
     library call and the bound; (d) llama2-7b at full width and depth,
     GQSA W4 S50 at g: prefill + 4 decode steps through the kernels
     against the plain versions, f32 (greedy tokens equal) and bf16; (e)
     the serve CLI with ``--compress gqsa --group-size g`` on llama2-7b
     and deepseek-moe-16b at full width and depth, ``--group-size {32,
     128} --spec 4 --draft-profile w4s75`` on llama2-7b, its launches
     held to the count its rounds, prefills and layers give, and
     ``--compress w4 --group-size 128`` on llama2-7b (the dense W4 G128
     baseline, on the tensor cores);
 21. the reference's four other dense configs, yi-34b (56 heads over 8
     KV heads: R = 7), starcoder2-3b (GELU MLP, R = 12), qwen3-14b
     (qk_norm, R = 5) and mistral-nemo-12b (heads x head_dim != d_model,
     R = 4): (a) paged attention's plain and int8 modes at each config's
     (KV heads, R), D=128, T in {1, 4}, and the tree mode on a (4, 2, 2)
     verify block at yi-34b's and starcoder2-3b's, each with its split
     sweep; kv_decode_attention at R in {4, 5, 7, 12, 16}; gqsa_gemv on
     one yi-34b and one starcoder2-3b layer (T in {1, 4, 64, 116}) and
     w4_matmul on one starcoder2-3b layer, each against its plain version;
     (b) each config at full width and 4 layers: prefill + 4 decode steps
     through the kernels against the plain versions, f32 (greedy tokens
     equal) and bf16; (c) the main paths at full width and depth: the
     serve CLI under GQSA W4 S50 G16 for each, ``--compress w4`` on
     starcoder2-3b, the int8 pool through the engine on qwen3-14b, the
     tree serve ``--spec-tree 4,2,2 --draft-profile w4l25`` on
     starcoder2-3b (launches held to the layer structure's count) and,
     in f32 at 4 layers, its tokens against no speculation; profiled
     decode steps of yi-34b and starcoder2-3b; (d) starcoder2-3b's static
     int8 contiguous path as phase 18 runs llama2-7b's (kernel vs plain on
     4096 positions, 4 sequences x 32768 positions, a profiled step);
     (e) timings: gqsa_gemv on a yi-34b and a starcoder2-3b layer at T = 4
     and 64, the plain mode at (8, 7) and (2, 12), kv_decode_attention at
     (2, 12) and (8, 16) over 4 x 4096 and 4 x 32768. Every kernel must launch on
     each config's path that runs it; the kernels line's ``dense_configs``
     holds those launches by config;
 22. the shared-prefix KV cache and its ragged tail prefill: (a) paged
     attention's plain (bf16, f32 pages) and int8 modes on the tail feed,
     B=4, KH=32, D=128, ps=16, T=64 query rows a slot on the staircase
     over (shared base, fed rows) (1024, 17), (1040, 64), (1008, 33) and
     a slot fed nothing: every row finite, padding included, within the
     bar of the plain version, repeats bit-identical; the plain mode
     timed there beside its plain version, SDPA under the same staircase
     mask and the bound; (b) the main path, llama2-7b at full width and
     depth, GQSA W4 S50 G16, bf16, the engine with the prefix cache on, 4
     slots, max_seq 2048: 8 requests x 32 new tokens, seven sharing a
     1024-token prefix with tails of 8-48 tokens, the last exactly the
     prefix (a page-aligned full hit: copy on write); hits, misses and hit
     tokens as the admission order implies, every kernel's launches equal
     to the count the batched prefills, tail dispatches, decode steps and
     layers give, TTFT of the misses and the hits; (c) f32 at full width
     and 4 layers: greedy tokens with the cache on equal to off on (b)'s
     requests, and again on a pool small enough to evict; (d) the serve
     CLI with ``--prefix-cache`` at full width and depth: its ``[prefix]``
     line with misses=8 (its 4-15-token prompts fill no page);
 23. chunked prefill: (a) paged attention's plain (bf16, f32 pages), int8
     and latent (DeepSeek-V2 widths, bf16 pages) modes on the chunk feed,
     B=4, T=64 query rows a slot on the staircase over (base, fed rows)
     (0, 64), (960, 64), (1024, 17) and a slot fed nothing, each table
     exposed only up to base + fed: every row finite, padding included,
     within the bar of the plain version, repeats bit-identical; the
     latent mode timed there beside its plain version, SDPA under the same
     staircase mask and the bound; (b) the main path, llama2-7b at full
     width and depth, GQSA W4 S50 G16, bf16, the engine with
     ``prefill_chunk_tokens=64`` and without it, 4 slots, max_seq 2048:
     four short prompts with 24, 48, 72 and 96 new tokens, then four of
     1024-1536 tokens with 32 each, admitted while other slots decode;
     chunk tokens as the prompts imply, no chunk over the budget and only
     mid-prompt slots fed, a decode step between two chunk dispatches
     whenever a slot decodes, every kernel's launches as the batched
     prefills, chunk dispatches, decode steps and layers give; the
     longest device-side decode stall while a long prompt is admitted,
     the co-resident requests' TPOT and the long prompts' TTFT, chunking
     on and off; (c) f32 at full width and 4 layers: greedy tokens with
     chunking on equal to off on (b)'s requests at budgets 64 and 100,
     and on phase 22's prefix requests with the cache on at budget 16;
     (d) DeepSeek-V2 at full width and 2 layers, f32, dropless: 200-400-
     token prompts with chunking on and off, tokens equal, the latent
     mode launched on every chunk dispatch; (e) the serve CLI with
     ``--chunked-prefill 3 --trace`` at full width and depth: its trace's
     ``prefill_chunk`` spans complete all 8 requests.
Each main path is driven with every kernel's launch count set to 0 just
before it and read just after. The line before the last is a JSON object
with every kernel's numbers; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12      # H100 SXM bf16 on the tensor cores, dense
TOL = 1e-4                       # max-abs error, relative to max |plain|
# whole-model logits, relative to max |plain|: f32 compute differs only in
# summation order; in bf16 a one-ulp rounding flip is amplified through 32
# random layers (measured 1.7% on an H100)
LOGITS_TOL_F32 = 1e-3
LOGITS_TOL_BF16 = 5e-2
# with the int8 pool, f32 compute: the two paths' f32 K/V differ in the
# last bits, and where one lies on a rounding boundary its int8 code flips
# by one step (1/127 of the row's amax), which 32 random layers amplify
# (measured 1.0e-3 on an H100); bf16 keeps its bar
LOGITS_TOL_INT8_F32 = 1e-2
# speculative vs plain greedy tokens (f32 compute): the verify feeds up to
# 29 rows where plain decode feeds one, so sums run in another order; a
# token may differ only where the plain run's top-2 logit margin is under
# twice the f32 logits bar (the near-tie rule of the CPU tests, scaled to
# the logits' magnitude)
SPEC_MARGIN_REL = 2 * LOGITS_TOL_F32
SEED = 0


def log(msg: str = "") -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


class Timer:
    """Device time of one call, averaged: each launch is bracketed by CUDA
    events right after an L2 flush (a 1 GiB write, ~0.3 ms, which also
    keeps the card busy while the host enqueues the call, so host overhead
    under that is not counted)."""

    def __init__(self):
        self.flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 30, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        end = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        for i in range(iters):
            self.flush.fill_(i & 0xFF)
            start[i].record()
            fn()
            end[i].record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in zip(start, end)) / iters


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"[device] {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    log(f"[nvidia-smi] {smi.splitlines()[0]}")
    return name, smi.splitlines()[0]


def phase_build():
    from repro_torch.kernels.build import SOURCES, build_all, library_path
    fresh = sum(not library_path(name).exists() for name in SOURCES)
    t0 = time.time()
    logs = build_all(SOURCES)
    log(f"[build] {fresh} of {len(SOURCES)} sources compiled in "
        f"{time.time() - t0:.1f}s (ptxas reports below, kept with each "
        f"library)")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "smem",
                                       "Compiling entry")):
                log(f"[ptxas {name}] {line.strip()}")


def _gqsa(gs=16):
    """GQSA W4 S50 at group size ``gs`` (16: the paper's G16)."""
    from repro_torch.core.gqs_layer import GQSAConfig
    from repro_torch.core.pruning import PruneConfig
    from repro_torch.core.quant import QuantConfig
    return GQSAConfig(quant=QuantConfig(bits=4, group_size=gs),
                      prune=PruneConfig(sparsity=0.5, group_size=gs))


def _packed(n, k, seed, gs=16):
    from repro_torch.core.model_compress import pack_linear
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((n, k), generator=g, device="cuda") / k ** 0.5
    return pack_linear(w, _gqsa(gs))


SHAPES = {"wq/wk/wv/wo": (4096, 4096), "wg/wu": (11008, 4096),
          "wd": (4096, 11008)}
PER_LAYER = {"wq/wk/wv/wo": 4, "wg/wu": 2, "wd": 1}


GEMV_ROWS = (1, 4, 8, 9, 20, 64, 116)   # x rows of the gqsa_gemv checks


def _gemv_case(x, bsr, label):
    """One ops.gqsa_gemv call against its plain version: one launch,
    finite, within TOL, a repeat bit-identical. Returns the max-abs
    error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.gqsa_gemv import gqsa_gemv_cuda
    before = gqsa_gemv_cuda.launches
    y = ops.gqsa_gemv(x, bsr)
    require(gqsa_gemv_cuda.launches == before + 1,
            "gqsa_gemv: one launch a call")
    ref = ops.gqsa_gemv(x, bsr, plain=True)
    again = ops.gqsa_gemv(x, bsr)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    log(f"[gemv check] {label} G={bsr.group_size} T={x.shape[0]} "
        f"x={str(x.dtype)[6:]}: max_abs_err {err:.3e} rel {rel:.3e}")
    require(y.shape == (x.shape[0], bsr.shape[0])
            and bool(torch.isfinite(y).all()),
            "gqsa_gemv output shape/finite")
    require(rel <= TOL, f"gqsa_gemv disagrees: rel {rel}")
    require(torch.equal(y, again), "gqsa_gemv repeat differs")
    return err


def phase_gemv_check(gs=16):
    """gqsa_gemv at group size ``gs``: the llama2-7b shapes and a ragged
    packing, every row count of GEMV_ROWS, bf16 and f32 x
    (:func:`_gemv_case`). Returns the worst max-abs error."""
    from repro_torch.core.bsr import pack_dense
    from repro_torch.core.quant import QuantConfig
    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for label, (n, k) in SHAPES.items():
        bsr = _packed(n, k, SEED, gs)
        for b in GEMV_ROWS:
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((b, k), generator=g, device="cuda").to(dt)
                worst = max(worst, _gemv_case(x, bsr, f"{label} N={n} "
                                                      f"K={k}"))
    # ragged packing: unequal kept groups per row (-1 padding)
    n, k = 1024, 4096
    w = torch.randn((n, k), generator=g, device="cuda")
    mask = torch.rand((n, k // gs), generator=g, device="cuda") < 0.4
    bsr = pack_dense(w, mask, QuantConfig(bits=4, group_size=gs))
    require(bool((bsr.idx < 0).any()), "ragged packing has padding")
    for b in GEMV_ROWS:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((b, k), generator=g, device="cuda").to(dt)
            worst = max(worst, _gemv_case(
                x, bsr, f"ragged N={n} K={k} M={bsr.idx.shape[1]}"))
    return worst


def _attn_case(b, t, lens, dtype, g, kh=32, d=128, ps=16, mp=16, r=1):
    """Full-width attention instance over a shuffled pool, ``r`` query
    heads a KV head: slot i owns ceil(max len / ps) pages in table order,
    the rest are sentinels. int8 pages are random codes with positive
    per-token scales."""
    num_pages = b * mp
    q = torch.randn((b, t, kh * r, d), generator=g, device="cuda")
    ks = vs = None
    if dtype == torch.int8:
        kp, vp = (torch.randint(-127, 128, (num_pages, ps, kh, d),
                                generator=g, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((num_pages, ps, kh), generator=g,
                             device="cuda") / 64 + 1e-3 for _ in range(2))
    else:
        kp = torch.randn((num_pages, ps, kh, d), generator=g,
                         device="cuda").to(dtype)
        vp = torch.randn((num_pages, ps, kh, d), generator=g,
                         device="cuda").to(dtype)
    perm = torch.randperm(num_pages, generator=g, device="cuda")
    bt = torch.full((b, mp), num_pages, dtype=torch.int32, device="cuda")
    for i in range(b):
        occ = -(-int(lens[i].max()) // ps)
        bt[i, :occ] = perm[i * mp:i * mp + occ].to(torch.int32)
    return q, kp, vp, lens.to("cuda"), bt, ks, vs


def split_note(b, kh, tr, mp, dv):
    """The page walk's plan for these shapes (pages of 16): its split
    count and workspace, as the wrapper picks them from the shapes
    alone."""
    from repro_torch.kernels.paged_attention import (split_count,
                                                     workspace_floats)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = split_count(b, kh, tr, mp, sms, 16, dv)
    return f"split S={n} workspace {4 * workspace_floats(b, kh, tr, dv, n)} B"


def split_sweep(o, call, ref, mp, label):
    """The walk at S in {1, 2, the table's width} against the plain
    output ``ref``, slots 3 and 4 (length 0) exact zeros at each S, and
    two launches at the default S bit-identical (``call(n_split)`` returns
    the dispatcher's layout; ``o`` is its default-S output). Returns the
    worst max-abs error."""
    worst = 0.0
    for n in sorted({1, 2, mp}):
        on = call(n)
        torch.cuda.synchronize()
        err = (on - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        worst = max(worst, err)
        require(rel <= TOL, f"{label} at S={n} disagrees: rel {rel}")
        require(bool((on[3:5] == 0).all()), f"{label} at S={n}: length-0 "
                                            f"rows are zeros")
    require(torch.equal(o, call(None)), f"{label}: repeat not bit-identical")
    log(f"[split sweep] {label}: S in {sorted({1, 2, mp})} worst max_abs_err "
        f"{worst:.3e}; repeat bit-identical")
    return worst


def _paged_at(q, kp, vp, lq, bt, ks=None, vs=None, anc=None, anc_base=None,
              anc_window=0):
    """``call(n_split)`` for :func:`split_sweep`: the wrapper on the
    dispatcher's operands, output in the dispatcher's layout."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    b, t, h, d = q.shape
    khn = kp.shape[2]
    lq2, live = ops.paged_query_prep(lq, bt, b, t, kp.shape[1])
    qh = q.reshape(b, t, khn, h // khn, d).permute(0, 2, 1, 3, 4) \
          .reshape(b, khn, -1, d).contiguous()
    if anc is not None:
        anc = anc.to(torch.int32).expand(b, t).contiguous()
        anc_base = anc_base.to(torch.int32).contiguous()

    def call(n_split):
        o = paged_attention_cuda(qh, kp, vp, lq2, bt, live, t, ks, vs,
                                 anc=anc, anc_base=anc_base,
                                 window=anc_window, n_split=n_split)
        return o.reshape(b, khn, t, h // khn, d).permute(0, 2, 1, 3, 4) \
                .reshape(b, t, h, d)
    return call


def _attn_check(dtype, t, g, kh=32, r=1):
    """The plain (bf16/f32 pages) or int8 mode against its plain version
    at ``kh`` KV heads of ``r`` query heads, D=128, T = ``t``, with its
    split sweep; returns the worst max-abs error."""
    from repro_torch.kernels import ops
    mode = "int8" if dtype == torch.int8 else "plain"
    # ragged staircase lengths; slot 3 is all-sentinel with length 0 and
    # slot 4 has a real table row but length 0
    base = torch.tensor([1, 37, 256 - t, 0, 0, 129])
    lens = base[:, None] + torch.arange(t)[None, :]
    lens[3:5] = 0
    lens = lens.to(torch.int32)
    q, kp, vp, lq, bt, ks, vs = _attn_case(6, t, lens, dtype, g, kh=kh, r=r)
    bt[4, :2] = bt[1, :2]
    o = ops.paged_decode_attention(q, kp, vp, lq, bt, ks, vs)
    ref = ops.paged_decode_attention(q, kp, vp, lq, bt, ks, vs, plain=True)
    torch.cuda.synchronize()
    require(bool((o[3:5] == 0).all()), "length-0 rows are zeros")
    require(bool(torch.isfinite(o).all()), "attention finite")
    err = (o - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    log(f"[attn check] pages={str(dtype)[6:]} T={t} KH={kh} R={r} D=128 "
        f"ps=16 ({split_note(6, kh, t * r, bt.shape[1], 128)}): "
        f"max_abs_err {err:.3e} rel {rel:.3e} (bar rel {TOL:.0e})")
    require(rel <= TOL, f"paged_attention ({mode}) disagrees: rel {rel}")
    return max(err, split_sweep(
        o, _paged_at(q, kp, vp, lq, bt, ks, vs), ref, bt.shape[1],
        f"attn pages={str(dtype)[6:]} T={t} KH={kh} R={r}"))


def phase_attention_check():
    """Both modes; returns the worst max-abs error of (plain, int8)."""
    worst = {"plain": 0.0, "int8": 0.0}
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        mode = "int8" if dtype == torch.int8 else "plain"
        for t in (1, 4):
            worst[mode] = max(worst[mode], _attn_check(dtype, t, g))
    return worst


def _w4_packed(n, k, seed, group_size=16):
    from repro_torch.core.gqs_layer import pack_w4
    from repro_torch.core.quant import QuantConfig
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((n, k), generator=g, device="cuda") / k ** 0.5
    return pack_w4(w, QuantConfig(bits=4, group_size=group_size))


def phase_w4_check():
    """w4_matmul at the full-width shapes, T from decode to prefill rows,
    bf16 and f32 x; then K = 48 (not a multiple of 64: the byte path of the
    CUDA cores), ragged N, and G = 128. Each case logs its path and split
    count, and a second launch must give the same bits."""
    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    cases = [(label, n, k, 16, (1, 4, 8, 64, 200))
             for label, (n, k) in SHAPES.items()]
    cases += [("unaligned", 100, 48, 16, (1, 5, 13)),
              ("G128", 4096, 4096, 128, (1, 4, 64))]
    for label, n, k, gs, ts in cases:
        p = _w4_packed(n, k, SEED, gs)
        for t in ts:
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((t, k), generator=g, device="cuda").to(dt)
                worst = max(worst, _w4_case(x, p, gs, label,
                                            tc=label != "unaligned"))
    return worst


def _w4_case(x, p, gs, label, tc=True):
    """One ops.w4_matmul call against its plain version: finite, within
    TOL, a repeat bit-identical, on the tensor cores where ``tc``.
    Returns the max-abs error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.w4_matmul import plan
    t, n, k = x.shape[0], p["qw"].shape[0], x.shape[1]
    args = (p["qw"], p["scale"], p["zero"])
    y = ops.w4_matmul(x, *args, group_size=gs)
    again = ops.w4_matmul(x, *args, group_size=gs)
    ref = ops.w4_matmul(x, *args, group_size=gs, plain=True)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    path, splits = plan(x, *args, gs)
    log(f"[w4 check] {label} N={n} K={k} G={gs} T={t} x={str(x.dtype)[6:]} "
        f"path={path} S={splits}: max_abs_err {err:.3e} rel {rel:.3e} (bar "
        f"rel {TOL:.0e})")
    require(y.shape == (t, n) and torch.isfinite(y).all(),
            "w4_matmul output shape/finite")
    require(rel <= TOL, f"w4_matmul disagrees: rel {rel}")
    require(torch.equal(y, again), "w4_matmul repeat differs")
    require(path == "tc" or not tc,
            "the G16/G128 shapes take the tensor cores")
    return err


def _bound_ms(nbytes, flops, flop_rate=BF16_TC_FLOP_PER_S):
    """The least time of a kernel on the card: the larger of its bytes
    over the memory rate and its operations over ``flop_rate`` (the bf16
    tensor cores' peak: every kernel here takes bf16 or int8 operands)."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / flop_rate)


def _bound_by(nbytes, flops, flop_rate=BF16_TC_FLOP_PER_S):
    return ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / flop_rate
            else "operations")


def _attn_bound(nbytes, flops):
    """(bound, bound_by, the bound at the f32 rate) of an attention
    kernel, which multiplies on the CUDA cores in f32: its bound counts
    the tensor cores' rate, and the f32 one is shown beside it."""
    return (_bound_ms(nbytes, flops), _bound_by(nbytes, flops),
            _bound_ms(nbytes, flops, F32_FLOP_PER_S))


def w4_layer(timer, g, t, shapes=None, per_layer=None):
    """One llama2-7b layer of w4_matmul (7 projections at G16, bf16 x with
    ``t`` rows; another model's layer by ``shapes`` and ``per_layer``):
    kernel, plain, ``torch.matmul`` on the dequantized dense bf16 W and
    the bound (its products are bf16 on the tensor cores), summed over
    the layer."""
    from repro_torch.core.quant import QuantConfig, dequantize, unpack_int4
    from repro_torch.kernels import ops
    from repro_torch.kernels.w4_matmul import plan, w4_matmul_cuda
    shapes, per_layer = shapes or SHAPES, per_layer or PER_LAYER
    w4 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for label, (n, k) in shapes.items():
        p = _w4_packed(n, k, SEED + 4)
        args = (p["qw"], p["scale"], p["zero"])
        x = torch.randn((t, k), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        # library yardstick: the dequantized weight as a dense bf16 matrix
        dense = dequantize(unpack_int4(p["qw"]), p["scale"], p["zero"],
                           QuantConfig(group_size=16), torch.bfloat16)
        nbytes = n * k // 2 + 8 * n * (k // 16) + t * k * 2 + t * n * 4
        bound = _bound_ms(nbytes, 2 * t * n * k)
        t_k = timer.ms(lambda: w4_matmul_cuda(x, *args, 16))
        t_p = timer.ms(lambda: ops.w4_matmul(x, *args, group_size=16,
                                             plain=True))
        t_l = timer.ms(lambda: torch.matmul(x, dense.T))
        path, splits = plan(x, *args, 16)
        log(f"[w4 time] {label} N={n} K={k} G=16 T={t} bf16 path={path} "
            f"S={splits}: kernel {t_k * 1e3:.1f}us plain {t_p * 1e3:.1f}us "
            f"torch.matmul(dense bf16) {t_l * 1e3:.1f}us bound "
            f"{bound * 1e3:.2f}us ({nbytes / 1e6:.1f} MB) -> "
            f"{bound / t_k:.0%} of bound")
        c = per_layer[label]
        for key, v in zip(("ms", "plain_ms", "library_ms", "bound_ms"),
                          (t_k, t_p, t_l, bound)):
            w4[key] += c * v
        del dense
    log(f"[w4 time] one layer ({sum(per_layer.values())} projections, "
        f"T={t}): kernel "
        f"{w4['ms']:.4f}ms plain {w4['plain_ms']:.4f}ms matmul "
        f"{w4['library_ms']:.4f}ms bound {w4['bound_ms']:.4f}ms "
        f"({w4['bound_ms'] / w4['ms']:.0%} of bound)")
    return w4


def w4_launch_floor(timer):
    """The Timer's reading for the smallest w4_matmul launch (T = 1, N =
    32, K = 64): the fixed cost of any launch after the L2 flush."""
    from repro_torch.kernels.w4_matmul import w4_matmul_cuda
    p = _w4_packed(32, 64, SEED + 6)
    x = torch.randn((1, 64), device="cuda", dtype=torch.bfloat16)
    return timer.ms(lambda: w4_matmul_cuda(x, p["qw"], p["scale"],
                                           p["zero"], 16), iters=100)


def gemv_layer(timer, g, t, gs=16, shapes=None, per_layer=None):
    """One llama2-7b layer of gqsa_gemv (7 projections, bf16 x with ``t``
    rows, group size ``gs``; another model's layer by ``shapes`` and
    ``per_layer``): kernel, plain, ``torch.matmul`` on the dense
    bf16 W and the bound (the larger of the payload, gs/2 + 12 bytes a
    kept group, x and y over 3.35 TB/s and the multiply-adds of the kept
    groups, bf16 x by exact 4-bit codes, over the tensor cores' 989
    TFLOP/s; the kernel runs them on CUDA cores in f32, which the bound
    does not assume), summed over the layer."""
    from repro_torch.core.bsr import to_dense
    from repro_torch.kernels import ops
    from repro_torch.kernels.gqsa_gemv import (gqsa_gemv_cuda,
                                               payload_bytes, plan)
    from repro_torch.kernels.build import sm_count
    shapes, per_layer = shapes or SHAPES, per_layer or PER_LAYER
    gemv = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    by_bytes = by_ops = 0.0
    for label, (n, k) in shapes.items():
        bsr = _packed(n, k, SEED + 4, gs)
        x = torch.randn((t, k), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        dense = to_dense(bsr).to(torch.bfloat16)
        m = bsr.idx.shape[1]
        nbytes = n * m * payload_bytes(gs) + t * k * 2 + t * n * 4
        flops = 2 * t * n * m * gs
        bound = _bound_ms(nbytes, flops)
        t_k = timer.ms(lambda: gqsa_gemv_cuda(x, bsr))
        t_p = timer.ms(lambda: ops.gqsa_gemv(x, bsr, plain=True))
        t_l = timer.ms(lambda: torch.matmul(x, dense.T))
        p = plan(t, n, k, gs, 2, sm_count(0))
        log(f"[gemv time] {label} N={n} K={k} M={m} G={gs} T={t} bf16 (tile "
            f"{p.tile}, {p.blocks} blocks): kernel "
            f"{t_k * 1e3:.1f}us plain {t_p * 1e3:.1f}us torch.matmul(dense "
            f"bf16) {t_l * 1e3:.1f}us bound {bound * 1e3:.2f}us "
            f"({nbytes / 1e6:.1f} MB) -> {bound / t_k:.0%} of bound")
        c = per_layer[label]
        for key, v in zip(("ms", "plain_ms", "library_ms", "bound_ms"),
                          (t_k, t_p, t_l, bound)):
            gemv[key] += c * v
        by_bytes += c * nbytes / HBM_BYTES_PER_S
        by_ops += c * flops / BF16_TC_FLOP_PER_S
        del dense
    gemv["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    log(f"[gemv time] one layer ({sum(per_layer.values())} projections, "
        f"G={gs}, T={t}): kernel "
        f"{gemv['ms']:.4f}ms plain {gemv['plain_ms']:.4f}ms matmul "
        f"{gemv['library_ms']:.4f}ms bound {gemv['bound_ms']:.4f}ms "
        f"({gemv['bound_ms'] / gemv['ms']:.0%} of bound)")
    return gemv


def phase_timing(timer):
    """Every kernel at the full-width decode shapes (4 slots)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    b = 4
    out = {"gqsa_gemv": gemv_layer(timer, g, b)}
    out["gqsa_gemv"]["rows"] = {str(t): gemv_layer(timer, g, t)
                                for t in (64, 116)}

    out["w4_matmul"] = w4_layer(timer, g, b)
    w4_layer(timer, g, 64)
    floor = w4_launch_floor(timer)
    log(f"[w4 time] launch floor (T=1 N=32 K=64, G16, bf16): "
        f"{floor * 1e3:.2f}us a launch, {7 * floor * 1e3:.1f}us for a "
        f"layer's 7 launches (not subtracted from the times above)")
    out["w4_matmul"]["launch_floor_ms"] = floor

    for mode, dtype in (("paged_attention", torch.bfloat16),
                        ("paged_attention_int8", torch.int8)):
        for label, lens in (("serve", [20, 25, 31, 29]),
                            ("max_seq", [256, 256, 256, 256])):
            row = attn_time(timer, g, dtype, label, lens)
            if mode not in out:
                out[mode] = row
    return out


def attn_time(timer, g, dtype, label, lens, kh=32, r=1):
    """One layer's decode attention (T = 1) at 4 slots of ``lens``, ``kh``
    KV heads of ``r`` query heads, D=128, ``dtype`` pages: the kernel
    alone on the dispatcher's operands, the plain version, SDPA on K/V
    gathered (dequantized, repeated over the query heads) beforehand and
    the bound (live K/V read once)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    b, d = len(lens), 128
    lq = torch.tensor(lens, dtype=torch.int32)[:, None]
    q, kp, vp, lq, bt, ks, vs = _attn_case(b, 1, lq, dtype, g, kh=kh, r=r)
    q = q.to(torch.bfloat16)
    tot = int(sum(lens))
    if dtype == torch.int8:
        kv_bytes = 2 * tot * kh * (d + 4)     # codes + scales
    else:
        kv_bytes = 2 * tot * kh * d * 2
    nbytes = kv_bytes + 2 * b * kh * r * d * 4
    bound, by, bound_f32 = _attn_bound(nbytes, 4 * tot * kh * r * d)
    smax = max(lens)

    def gathered(pages, scales):
        bti = bt.clamp(max=kp.shape[0] - 1).long()
        v = pages[bti].float()
        if scales is not None:
            v = v * scales[bti][..., None]
        return v.reshape(b, -1, kh, d)[:, :smax].permute(0, 2, 1, 3) \
            .repeat_interleave(r, dim=1).to(torch.bfloat16).contiguous()

    # library yardstick: SDPA on K/V gathered (and dequantized) contiguous
    # beforehand
    kk, vv = gathered(kp, ks), gathered(vp, vs)
    mask = (torch.arange(smax, device="cuda")[None, :]
            < lq.to("cuda"))[:, None, None, :]
    qs = q.permute(0, 2, 1, 3).contiguous()
    # the kernel alone, on the operands the dispatcher prepares
    lq2, live = ops.paged_query_prep(lq, bt, b, 1, kp.shape[1])
    qh = q.reshape(b, kh, r, d).float().contiguous()
    t_k = timer.ms(lambda: paged_attention_cuda(qh, kp, vp, lq2, bt, live,
                                                1, ks, vs))
    t_p = timer.ms(lambda: ops.paged_decode_attention(q, kp, vp, lq, bt, ks,
                                                      vs, plain=True))
    t_l = timer.ms(lambda: F.scaled_dot_product_attention(qs, kk, vv,
                                                          attn_mask=mask))
    log(f"[attn time] {label} lengths={lens} B={b} KH={kh} R={r} D=128 "
        f"{str(dtype)[6:]} pages ({split_note(b, kh, r, bt.shape[1], d)}): "
        f"kernel {t_k * 1e3:.1f}us plain {t_p * 1e3:.1f}us sdpa "
        f"{t_l * 1e3:.1f}us bound {bound * 1e3:.2f}us by {by} (f32 rate "
        f"{bound_f32 * 1e3:.2f}us; {nbytes / 1e6:.2f} MB) -> "
        f"{bound / t_k:.0%} of bound")
    return dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bound,
                bound_by=by, bound_f32_ms=bound_f32)


def check_model(params, full, label, tol_f32=LOGITS_TOL_F32, on_run=None,
                tokens_equal=False):
    """Full-width prefill + 4 decode steps, kernels vs plain versions, in
    f32 compute (strict: the two differ only in f32 summation order; with
    the int8 pool, ``tol_f32`` allows for one-step code flips) and in bf16,
    the serving dtype (loose: a one-ulp bf16 rounding flip that the
    summation order decides is amplified by 32 random layers).
    ``on_run(dtype, plain)`` is called before each of the four runs.
    ``tokens_equal``: the f32 runs' greedy tokens must be equal at every
    step (not only where the top-2 margin is clear)."""
    import dataclasses
    from repro_torch.models import transformer as tf
    rng = np.random.default_rng(SEED)
    b, ps, mp = 4, 16, 16
    lens = np.array([7, 12, 4, 15], np.int32)
    toks = np.zeros((b, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, full.vocab, n)
    bt = torch.arange(b * mp, dtype=torch.int32, device="cuda").reshape(b, mp)
    toks_d = torch.from_numpy(toks).cuda()
    lens_d = torch.from_numpy(lens).cuda()

    def run(cfg, plain, feed=None):
        if on_run is not None:
            on_run(cfg.dtype, plain)
        cache = tf.init_paged_cache(cfg, b * mp, ps, device="cuda")
        logits, _ = tf.prefill(params, cache, toks_d, lens_d, bt, cfg,
                               plain=plain)
        out = [logits[:, -1].float()]
        fed = []
        pos = lens_d.clone()
        for step in range(4):
            tok = (out[-1].argmax(-1) if feed is None else feed[step])
            fed.append(tok)
            logits, _ = tf.decode_step(params, cache, tok[:, None].int(),
                                       pos, cfg, bt, max_live_pages=2,
                                       plain=plain)
            out.append(logits[:, -1].float())
            pos = pos + 1
        torch.cuda.synchronize()
        return out, fed

    for dtype, tol in (("float32", tol_f32), ("bfloat16", LOGITS_TOL_BF16)):
        cfg = dataclasses.replace(full, dtype=dtype)
        t0 = time.time()
        kern, fed = run(cfg, plain=False)
        t_k = time.time() - t0
        # the plain run is fed the kernel run's tokens (teacher forcing)
        plain, _ = run(cfg, plain=True, feed=fed)
        for i, (a, p) in enumerate(zip(kern, plain)):
            compare_logits(a, p, tol, f"model {label} {dtype}",
                           "prefill" if i == 0 else f"decode {i}")
            if tokens_equal and dtype == "float32":
                require(torch.equal(a.argmax(-1), p.argmax(-1)),
                        f"model {label} f32: greedy tokens differ")
        log(f"[model {label} {dtype}] kernel path prefill + 4 decode steps "
            f"{t_k:.2f}s wall (first calls, eager)")
    return toks_d, lens_d, bt, b * mp, ps


def compare_logits(a, p, tol, label, step):
    """Kernel-path logits ``a`` [B, V] against the plain path's ``p``:
    finite, max-abs difference within ``tol`` of max |p|, argmax equal
    wherever p's top-2 margin exceeds twice that difference."""
    require(bool(torch.isfinite(a).all()) and a.shape == p.shape,
            "logits finite, [B, V]")
    err = (a - p).abs().max().item()
    scale = p.abs().max().item()
    top2 = p.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * err
    agree = a.argmax(-1) == p.argmax(-1)
    log(f"[{label}] {step}: logits max_abs_diff {err:.4e} (max |logit| "
        f"{scale:.3f}, rel {err / scale:.2e}), argmax agrees "
        f"{int(agree.sum())}/{a.shape[0]}")
    require(err <= tol * scale,
            f"kernel vs plain logits differ by {err} ({label})")
    require(bool(agree[clear].all()),
            "argmax differs where the top-2 margin is clear")


def reset_launches():
    from repro_torch.kernels.gqsa_gemv import (gqsa_gemv_cuda,
                                               gqsa_gemv_experts_cuda)
    from repro_torch.kernels.kv_decode_attention import \
        kv_decode_attention_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels.w4_matmul import (w4_matmul_cuda,
                                               w4_matmul_experts_cuda)
    gqsa_gemv_cuda.launches = 0
    gqsa_gemv_experts_cuda.launches = 0
    paged_attention_cuda.launches = 0
    paged_attention_cuda.int8_launches = 0
    paged_attention_cuda.tree_launches = 0
    paged_attention_cuda.latent_launches = 0
    paged_attention_cuda.latent_tree_launches = 0
    kv_decode_attention_cuda.launches = 0
    w4_matmul_cuda.launches = 0
    w4_matmul_cuda.tc_launches = 0
    w4_matmul_experts_cuda.launches = 0
    w4_matmul_experts_cuda.tc_launches = 0


def read_launches():
    from repro_torch.kernels.gqsa_gemv import (gqsa_gemv_cuda,
                                               gqsa_gemv_experts_cuda)
    from repro_torch.kernels.kv_decode_attention import \
        kv_decode_attention_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels.w4_matmul import (w4_matmul_cuda,
                                               w4_matmul_experts_cuda)
    return {"gqsa_gemv": gqsa_gemv_cuda.launches,
            "paged_attention": paged_attention_cuda.launches,
            "w4_matmul": w4_matmul_cuda.launches,
            "w4_matmul_tc": w4_matmul_cuda.tc_launches,
            "paged_attention_int8": paged_attention_cuda.int8_launches,
            "paged_attention_tree": paged_attention_cuda.tree_launches,
            "gqsa_gemv_experts": gqsa_gemv_experts_cuda.launches,
            "paged_attention_latent": paged_attention_cuda.latent_launches,
            "paged_attention_latent_tree":
                paged_attention_cuda.latent_tree_launches,
            "w4_matmul_experts": w4_matmul_experts_cuda.launches,
            "w4_matmul_experts_tc": w4_matmul_experts_cuda.tc_launches,
            "kv_decode_attention": kv_decode_attention_cuda.launches}


def phase_model_gqsa():
    """The GQSA model with the bf16 and the int8 pool; the profiled decode
    step; and the int8-pool main path, the engine on the same weights."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core.gqs_layer import GQSAConfig
    from repro_torch.models import transformer as tf
    full = get_config("llama2_7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = tf.init_params(SEED, full, "cuda", compress=GQSAConfig())
    torch.cuda.synchronize()
    packed = sum(leaf["bsr"].nbytes_packed()
                 for blk in ("attn", "mlp")
                 for leaf in params["layers"][blk].values())
    log(f"[model] llama2-7b full width, GQSA W4 S50 G16 packed on the card "
        f"in {time.time() - t0:.1f}s: {packed / 1e9:.3f} GB of packed "
        f"linears")
    toks, lens, bt, num_pages, ps = check_model(params, full, "gqsa")
    check_model(params, dataclasses.replace(full, kv_cache_dtype="int8"),
                "gqsa int8-kv", LOGITS_TOL_INT8_F32)
    log(f"[model] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB")
    profile_decode(params, full, toks, lens, bt, num_pages, ps)
    launches = engine_int8(params, full)
    del params
    return launches


def engine_int8(params, full):
    """The int8-pool main path: the engine serves 8 requests x 32 new
    tokens on 4 slots, max_seq 256, greedy (the reference has no serve
    flag for an int8 pool: it is reached through the engine)."""
    import dataclasses
    from repro_torch.engine import EngineConfig, InferenceEngine
    from repro_torch.launch.serve import make_requests
    cfg = dataclasses.replace(full, kv_cache_dtype="int8")
    prompts = make_requests(8, cfg.vocab, np.random.default_rng(SEED))
    reset_launches()
    t0 = time.time()
    eng = InferenceEngine(cfg, params, EngineConfig(
        num_slots=4, max_seq=256, seed=SEED, device="cuda"))
    require(eng.kv.data["k_pages"].dtype == torch.int8, "int8 pool")
    for p in prompts:
        eng.submit(p, 32)
    res = eng.run()
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[engine int8-kv] {eng.metrics.format_summary()}")
    log(f"[engine int8-kv] wall {time.time() - t0:.1f}s; launches "
        f"{launches}")
    require(len(res["results"]) == 8, "all 8 requests answered")
    require(all(len(r["tokens"]) == 32 for r in res["results"]),
            "every request got 32 tokens")
    require(launches["paged_attention_int8"] > 0
            and launches["gqsa_gemv"] > 0,
            "the int8 mode and gqsa_gemv launched on the int8-pool path")
    require(launches["paged_attention"] == 0,
            "no plain-mode attention on the int8-pool path")
    return launches


def phase_model_w4():
    from repro_torch.configs.registry import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models import transformer as tf
    full = get_config("llama2_7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = tf.init_params(SEED, full, "cuda",
                            compress=QuantConfig(bits=4, group_size=16))
    torch.cuda.synchronize()
    packed = sum(t.numel() * t.element_size()
                 for blk in ("attn", "mlp")
                 for leaf in params["layers"][blk].values()
                 for t in leaf.values())
    log(f"[model] llama2-7b full width, dense W4 G16 packed on the card in "
        f"{time.time() - t0:.1f}s: {packed / 1e9:.3f} GB of packed linears")
    toks, lens, bt, num_pages, ps = check_model(params, full, "w4")
    log(f"[model] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB")
    profile_decode(params, full, toks, lens, bt, num_pages, ps,
                   label="W4 bf16 decode step at 4 slots")
    del params

def profile_decode(params, cfg, toks, lens, bt, num_pages, ps, steps=8,
                   label="bf16 decode step at 4 slots"):
    """:func:`profile_steps` of full-width bf16 decode steps on the paged
    pool after a batched prefill of ``toks``."""
    from repro_torch.models import transformer as tf
    cache = tf.init_paged_cache(cfg, num_pages, ps, device="cuda")
    logits, _ = tf.prefill(params, cache, toks, lens, bt, cfg)
    tok = logits[:, -1].argmax(-1).int()[:, None]
    pos = lens.clone()

    def step():
        nonlocal pos
        tf.decode_step(params, cache, tok, pos, cfg, bt, max_live_pages=2)
        pos = pos + 1

    profile_steps(step, steps, label)


def profile_steps(step, steps, label):
    """Where a decode step's time goes: wall time per step (host clock
    around synchronised steps, no profiler), then device time by kernel
    from a torch.profiler trace of as many steps; the device's busy share
    is device time over wall time. Only the trace's kernel events are
    summed: a CPU-side op's device time repeats the time of the kernels it
    launched. ``step()`` runs one step; it is called 2 * steps + 1
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import ops
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    # the expert axis (both packings) under one profiler range: its kernel
    # shares a name with the single-matrix path's (w4_matmul) or not
    # (gqsa_gemv), so the range, not the name, tells its device time
    inner = {n: getattr(ops, n) for n in ("gqsa_gemv_experts",
                                          "w4_matmul_experts")}

    def ranged(fn):
        def call(*args, **kwargs):
            with record_function("expert axis"):
                return fn(*args, **kwargs)
        return call
    for n, fn in inner.items():
        setattr(ops, n, ranged(fn))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    finally:
        for n, fn in inner.items():
            setattr(ops, n, fn)
    # the range also shows as a device-side annotation spanning its
    # kernel: not a kernel of its own
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    axis = [e for e in device if e.key == "expert axis"]
    rows = sorted((e.self_device_time_total / steps / 1e3,
                   e.count // steps, e.key)
                  for e in device if e.key != "expert axis")[::-1]
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log(f"[profile] {label}: wall {wall * 1e3:.2f} "
            f"ms; the profiler traced no kernel: device time not measured")
        return
    log(f"[profile] {label}: wall {wall * 1e3:.2f} ms, "
        f"device busy {busy:.2f} ms ({busy / (wall * 1e3):.0%}), "
        f"{sum(r[1] for r in rows)} kernels per step")
    for ms, n, name in rows[:12]:
        # drop the anonymous namespace of a kernel of the port's csrc
        short = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d+", "", name)
        log(f"[profile]   {ms:8.3f} ms  x{n:<5d} {short[:70]}")
    for family in ("paged_attention", "gqsa_gemv", "w4_matmul",
                   "kv_decode"):
        fam = [(ms, n) for ms, n, name in rows if family in name]
        if fam:
            ms = sum(a[0] for a in fam)
            log(f"[profile]   {family}, every kernel: {ms:.3f} ms "
                f"x{sum(a[1] for a in fam)} ({ms / busy:.0%} of device "
                f"busy)")
    if axis:
        ms = sum(e.self_device_time_total for e in axis) / steps / 1e3
        log(f"[profile]   expert axis (its profiler range): {ms:.3f} ms "
            f"x{sum(e.count for e in axis) // steps} ({ms / busy:.0%} of "
            f"device busy)")


def phase_serve(compress, arch="llama2_7b", group_size=16, extra=(),
                out=None):
    """A main path: the serve CLI at full width (and depth), ``arch``
    under ``compress`` at ``group_size`` (``--group-size``; 16 is the
    CLI's default), with the flags ``extra``; ``out``, a list, gets the
    CLI's printed output."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    moe = get_config(arch).moe is not None
    tag = {"llama2_7b": compress, "deepseek_moe_16b":
           f"deepseek-moe {compress}"}.get(arch, f"{arch} {compress}")
    if group_size != 16:
        tag += f" g{group_size}"
    tag = " ".join([tag, *extra])
    argv = ["--arch", arch, "--full", "--compress", compress, "--slots",
            "4", "--requests", "8", "--max-new", "32", "--max-seq", "256",
            "--seed", str(SEED), "--group-size", str(group_size), *extra]
    buf = io.StringIO()
    reset_launches()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        res = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    if out is not None:
        out.append(buf.getvalue())
    for line in buf.getvalue().splitlines():
        log(f"[serve {tag}] {line}")
    log(f"[serve {tag}] wall {wall:.1f}s (init + pack + serve); "
        f"launches {launches}")
    require(len(res["results"]) == 8, "all 8 requests answered")
    require(all(len(r["tokens"]) == 32 for r in res["results"]),
            "every request got 32 tokens")
    linear = "gqsa_gemv" if compress == "gqsa" else "w4_matmul"
    other = "w4_matmul" if compress == "gqsa" else "gqsa_gemv"
    require(launches[linear] > 0 and launches["paged_attention"] > 0,
            f"{linear} and paged attention launched on the main path")
    require((launches[f"{linear}_experts"] > 0) == moe,
            f"{linear}'s expert axis launched exactly on the MoE path")
    require(compress == "gqsa" or (launches["w4_matmul_tc"] > 0 and (
        not moe or launches["w4_matmul_experts_tc"] > 0)),
            "w4_matmul (and its expert axis) took the tensor cores on the "
            "w4 path")
    require(launches[other] == 0 and launches[f"{other}_experts"] == 0
            and launches["paged_attention_int8"] == 0
            and launches["paged_attention_tree"] == 0
            and launches["paged_attention_latent"] == 0,
            f"no {other}, int8-, tree- or latent-mode launch on the {tag} "
            f"path")
    return launches


def _tree_case(b, fanout, lvl, dtype, g, window=None, kh=32, r=1):
    """Full-width tree block: the verify block of ``fanout`` (lvl 0) or
    the draft's level-``lvl`` call, over the pool of :func:`_attn_case`
    with ``kh`` KV heads of ``r`` query heads. Slot bases are ragged; slot 3 is all-sentinel
    with length 0, slot 4 has a real table row but length 0. ``window``
    overrides the block's window (narrower than T)."""
    from repro_torch.engine.spec import TreeTemplate
    tpl = TreeTemplate(fanout)
    spec = tpl.level_tree(lvl, "cuda") if lvl else tpl.verify_tree("cuda")
    t = spec["anc"].shape[0]
    win = spec["window"] if window is None else window
    base = torch.tensor([1, 37, 255 - win, 0, 0, 129][:b],
                        dtype=torch.int32)
    lens = (base + win)[:, None].expand(b, t).contiguous()
    if b > 4:
        lens[3:5] = 0
    q, kp, vp, lq, bt, ks, vs = _attn_case(b, t, lens, dtype, g, kh=kh, r=r)
    if b > 4:
        bt[4, :2] = bt[1, :2]
    anc = spec["anc"][None].expand(b, t).contiguous()
    return q, kp, vp, lq, bt, ks, vs, anc, base.to("cuda"), win


# (fanout, level (0: the verify block), window override, KV heads): 32
# is llama2-7b's, 16 deepseek-moe-16b's
TREE_CASES = [((4, 2, 2), 0, None, 32), ((4, 2, 2), 1, None, 32),
              ((4, 2, 2), 2, None, 32), ((2, 2, 2, 2), 0, None, 32),
              ((1, 1, 1, 1), 0, None, 32), ((1,), 0, None, 32),
              ((1, 1, 1, 1), 0, 3, 32), ((4, 2, 2), 0, None, 16),
              ((4, 2, 2), 1, None, 16), ((4, 2, 2), 2, None, 16)]


def phase_tree_check():
    """The tree mode against its plain version at full width (KH=32 and,
    for the (4, 2, 2) verify block and its level calls, KH=16; D=128,
    ps=16): T in {2, 4, 5, 8, 29, 31}, windows equal to T, wider (the
    draft's level calls) and narrower; every page type. Returns the worst
    max-abs error."""
    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        for fanout, lvl, window, kh in TREE_CASES:
            worst = max(worst, _tree_check(dtype, fanout, lvl, window, kh,
                                           g))
    return worst


def _tree_check(dtype, fanout, lvl, window, kh, g, r=1):
    """One tree block (:func:`_tree_case`) against its plain version, one
    launch, with its split sweep; returns the worst max-abs error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    q, kp, vp, lq, bt, ks, vs, anc, base, win = _tree_case(
        6, fanout, lvl, dtype, g, window, kh, r)
    before = paged_attention_cuda.tree_launches
    o = ops.paged_decode_attention(q, kp, vp, lq, bt, ks, vs, anc=anc,
                                   anc_base=base, anc_window=win)
    ref = ops.paged_decode_attention(q, kp, vp, lq, bt, ks, vs, anc=anc,
                                     anc_base=base, anc_window=win,
                                     plain=True)
    torch.cuda.synchronize()
    require(paged_attention_cuda.tree_launches == before + 1,
            "one tree-mode launch")
    require(bool((o[3:5] == 0).all()), "length-0 rows are zeros")
    require(bool(torch.isfinite(o).all()), "tree attention finite")
    err = (o - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    t = q.shape[1]
    log(f"[tree check] pages={str(dtype)[6:]} fanout={fanout} "
        f"{'verify' if lvl == 0 else f'level {lvl}'} T={t} window={win} "
        f"KH={kh} R={r} D=128 ps=16 ({t * r} rows a KV head): max_abs_err "
        f"{err:.3e} rel {rel:.3e} (bar rel {TOL:.0e})")
    require(rel <= TOL, f"paged_attention (tree) disagrees: rel {rel}")
    return max(err, split_sweep(
        o, _paged_at(q, kp, vp, lq, bt, ks, vs, anc=anc, anc_base=base,
                     anc_window=win),
        ref, bt.shape[1], f"tree pages={str(dtype)[6:]} fanout={fanout} "
                          f"lvl={lvl} T={t} KH={kh} R={r}"))


def phase_tree_timing(timer, kh=32):
    """The tree mode at the verify shape of fanout (4, 2, 2): B=4, ``kh``
    KV heads (32: llama2-7b; 16: deepseek-moe-16b), D=128, ps=16, T=29,
    bf16 pages, lengths (base + 29) about 64 and 256; beside it the same
    slots at T=16, the plain version, SDPA with the boolean ancestor mask
    on pre-gathered K/V, and the bound; at each length the kernel's
    output must agree with the plain version's. Returns the ~64 numbers,
    with both lengths' under "lengths"."""
    import torch.nn.functional as F
    from repro_torch.engine.spec import TreeTemplate
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.layers import ancestor_mask
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    b, d = 4, 128
    tpl = TreeTemplate((4, 2, 2))
    spec = tpl.verify_tree("cuda")
    t, win = spec["anc"].shape[0], spec["window"]
    out = None
    for label, bases in (("~64", [35, 40, 31, 38]),
                         ("~256", [227, 220, 225, 210])):
        base = torch.tensor(bases, dtype=torch.int32)
        lens = (base + win)[:, None].expand(b, t).contiguous()
        q, kp, vp, lq, bt, _, _ = _attn_case(b, t, lens, torch.bfloat16, g,
                                             kh=kh)
        base = base.to("cuda")
        anc = spec["anc"][None].expand(b, t).contiguous()
        tot = int(lens[:, 0].sum())
        nbytes = (2 * tot * kh * d * 2 + 2 * b * t * kh * d * 4
                  + b * t * 8 + b * 4)
        bound, by, bound_f32 = _attn_bound(nbytes, 4 * t * tot * kh * d)
        o = ops.paged_decode_attention(q, kp, vp, lq, bt, anc=anc,
                                       anc_base=base, anc_window=win)
        ref = ops.paged_decode_attention(q, kp, vp, lq, bt, anc=anc,
                                         anc_base=base, anc_window=win,
                                         plain=True)
        err = (o - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        require(rel <= TOL, f"paged_attention (tree, KH={kh}, lengths "
                            f"{label}) disagrees: rel {rel}")
        lq2, live = ops.paged_query_prep(lq, bt, b, t, kp.shape[1])
        qh = q.permute(0, 2, 1, 3).contiguous()        # [B, KH, T, D]
        t_k = timer.ms(lambda: paged_attention_cuda(
            qh, kp, vp, lq2, bt, live, t, anc=anc, anc_base=base,
            window=win))
        q16 = qh[:, :, :16].contiguous()
        t_16 = timer.ms(lambda: paged_attention_cuda(
            q16, kp, vp, lq2[:, :16].contiguous(), bt, live, 16,
            anc=anc[:, :16].contiguous(), anc_base=base, window=win))
        t_p = timer.ms(lambda: ops.paged_decode_attention(
            q, kp, vp, lq, bt, anc=anc, anc_base=base, anc_window=win,
            plain=True))
        smax = int(lens.max())
        bti = bt.clamp(max=kp.shape[0] - 1).long()
        kk, vv = (pg[bti].reshape(b, -1, kh, d)[:, :smax].permute(0, 2, 1, 3)
                  .contiguous() for pg in (kp, vp))
        mask = ancestor_mask(lq, anc, base, win, b, t, smax)[:, None]
        qs = qh.to(torch.bfloat16)
        t_l = timer.ms(lambda: F.scaled_dot_product_attention(
            qs, kk, vv, attn_mask=mask))
        log(f"[tree time] verify (4,2,2) T={t} lengths {label} "
            f"({lens[:, 0].tolist()}) B=4 KH={kh} D=128 bf16 pages "
            f"({split_note(b, kh, t, bt.shape[1], d)}): kernel "
            f"{t_k * 1e3:.1f}us (T=16: {t_16 * 1e3:.1f}us) "
            f"plain {t_p * 1e3:.1f}us sdpa(mask) {t_l * 1e3:.1f}us bound "
            f"{bound * 1e3:.2f}us by {by} (f32 rate {bound_f32 * 1e3:.2f}"
            f"us; {nbytes / 1e6:.2f} MB) -> {bound / t_k:.0%} of bound; "
            f"kernel vs plain max_abs_err {err:.3e} rel {rel:.3e}")
        row = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bound,
                   bound_by=by, bound_f32_ms=bound_f32, max_abs_err=err)
        if out is None:
            out = dict(row, lengths={})
        out["lengths"][label] = row
    return out


def greedy_margin(params, cfg, prompt, tokens, at):
    """Top-2 logit margin and max |logit| of the plain (non-speculative)
    path at generated token ``at`` of ``tokens`` after ``prompt``,
    teacher-forced through prefill and decode steps."""
    from repro_torch.models import transformer as tf
    n_pages = -(-(len(prompt) + len(tokens)) // 16)
    cache = tf.init_paged_cache(cfg, n_pages, 16, device="cuda")
    bt = torch.arange(n_pages, dtype=torch.int32, device="cuda")[None]
    logits, _ = tf.prefill(params, cache,
                           torch.from_numpy(prompt)[None].to("cuda"),
                           torch.tensor([len(prompt)], device="cuda"), bt,
                           cfg)
    for i in range(at):
        logits, _ = tf.decode_step(
            params, cache, torch.tensor([[int(tokens[i])]], device="cuda"),
            torch.tensor([len(prompt) + i], dtype=torch.int32,
                         device="cuda"), cfg, bt)
    row = logits[0, -1].float()
    top2 = row.topk(2).values
    return float(top2[0] - top2[1]), float(row.abs().max())


def _engine_run(cfg, params, draft=None, **spec):
    from repro_torch.engine import EngineConfig, InferenceEngine
    from repro_torch.launch.serve import make_requests
    prompts = make_requests(8, cfg.vocab, np.random.default_rng(SEED))
    reset_launches()
    t0 = time.time()
    eng = InferenceEngine(cfg, params, EngineConfig(
        num_slots=4, max_seq=256, seed=SEED, device="cuda", **spec),
        draft_params=draft)
    rids = [eng.submit(p, 32) for p in prompts]
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    by = {r["rid"]: r["tokens"] for r in res["results"]}
    require(len(by) == 8 and all(len(by[r]) == 32 for r in rids),
            "8 requests x 32 tokens")
    return prompts, [by[r] for r in rids], eng, read_launches(), wall


SPEC_ENGINE_RUNS = [("chain K=4, draft w4s50", "w4s50", dict(spec_k=4)),
                    ("tree (4,2,2), draft w4s50", "w4s50",
                     dict(spec_fanout=(4, 2, 2))),
                    ("tree (4,2,2), draft w4l25", "w4l25",
                     dict(spec_fanout=(4, 2, 2)))]


def phase_spec_engine(arch="llama2_7b", n_layers=None,
                      runs=SPEC_ENGINE_RUNS):
    """Speculation against no speculation, full-width GQSA W4 S50 G16 in
    f32 compute, in the engine (8 requests x 32 tokens, 4 slots): each of
    ``runs`` on ``arch`` (at ``n_layers`` layers, default all)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core.gqs_layer import GQSAConfig
    from repro_torch.core.model_compress import draft_layers
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    plain = None
    for label, profile, spec in runs:
        params, draft = tf.init_params_and_draft(
            SEED, cfg, profile, "cuda", compress=GQSAConfig())
        if plain is None:
            prompts, plain, _, _, wall = _engine_run(cfg, params)
            log(f"[spec engine f32] no speculation: wall {wall:.1f}s")
        _, got, eng, launches, wall = _engine_run(
            cfg, params, draft, spec_draft_layers=draft_layers(cfg, profile),
            **spec)
        m = eng.metrics.summary()
        mism, worst = 0, 0.0
        for i, (a, b) in enumerate(zip(got, plain)):
            diff = np.flatnonzero(a != b)
            if len(diff) == 0:
                continue
            mism += 1
            at = int(diff[0])
            margin, scale = greedy_margin(params, cfg, prompts[i], b, at)
            worst = max(worst, margin / scale)
            log(f"[spec engine f32] {label}: request {i} first differs at "
                f"token {at}: plain top-2 margin {margin:.4e} (max |logit| "
                f"{scale:.3f}, rel {margin / scale:.2e})")
            require(margin <= SPEC_MARGIN_REL * scale,
                    f"{label}: tokens differ at a clear top-2 margin "
                    f"(rel {margin / scale:.2e} > {SPEC_MARGIN_REL})")
        log(f"[spec engine f32] {label}: {mism} of 8 requests differ from "
            f"no speculation (margin bound {SPEC_MARGIN_REL:.0e} x max "
            f"|logit|); acceptance {m['acceptance_rate']:.1%}, "
            f"{m['spec_rounds']} rounds, accepted drafts per slot-round "
            f"{m['accepted_len_mean']:.2f}; wall {wall:.1f}s; launches "
            f"{launches}")
        tree = "spec_fanout" in spec
        require((launches["paged_attention_tree"] > 0) == tree,
                "tree mode launched exactly on the tree runs")
        require(launches["gqsa_gemv"] > 0, "gqsa_gemv launched")
        del params, draft, eng
        torch.cuda.empty_cache()


SPEC_SERVE = {
    "chain serve": ["--spec", "4", "--draft-profile", "w4s75"],
    "tree serve": ["--spec-tree", "4,2,2", "--draft-profile", "w4l25"],
    "adaptive tree serve": ["--spec-tree", "4,2,2", "--spec-adaptive",
                            "--draft-profile", "w4s75"],
}


def phase_serve_spec(label, flags=None, counted=None, arch="llama2_7b"):
    """A speculative main path: the serve CLI at full width, bf16, GQSA
    target, 4 slots, 8 requests x 32 new tokens, with the spec flags
    ``flags`` (default ``SPEC_SERVE[label]``), on ``arch``. ``counted`` =
    (compress, draft profile, spec): every kernel's launches are held to
    :func:`spec_launches`' count."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    flags = SPEC_SERVE[label] if flags is None else flags
    argv = ["--arch", arch, "--full", "--compress", "gqsa", "--slots", "4",
            "--requests", "8", "--max-new", "32", "--max-seq", "256",
            "--seed", str(SEED)] + flags
    buf = io.StringIO()
    reset_launches()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        res = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    for line in buf.getvalue().splitlines():
        log(f"[{label}] {line}")
    rounds = max(res["spec_rounds"], 1)
    log(f"[{label}] {' '.join(flags)}: wall {wall:.1f}s (init + "
        f"pack + serve); acceptance {res['acceptance_rate']:.1%}; "
        f"launches {launches} ({launches['gqsa_gemv'] / rounds:.0f} "
        f"gqsa_gemv, {launches['w4_matmul'] / rounds:.0f} w4_matmul, "
        f"{launches['paged_attention_tree'] / rounds:.0f} tree-mode and "
        f"{launches['paged_attention'] / rounds:.0f} plain-mode attention "
        f"per round)")
    require(len(res["results"]) == 8, "all 8 requests answered")
    require(all(len(r["tokens"]) == 32 for r in res["results"]),
            "every request got 32 tokens")
    require(res["spec_rounds"] > 0, "speculative rounds ran")
    require(launches["gqsa_gemv"] > 0, "gqsa_gemv launched")
    if "--spec" in flags:
        require(launches["paged_attention"] > 0
                and launches["paged_attention_tree"] == 0,
                "the chain runs the plain mode, no tree mode")
    else:
        require(launches["paged_attention_tree"] > 0,
                "the tree mode launched on the tree path")
    if "w4l25" in flags:
        require(launches["w4_matmul"] > 0
                and launches["w4_matmul_tc"] > 0,
                "the dense-W4 draft ran w4_matmul on the tensor cores")
    if counted is not None:
        compress, profile, spec = counted
        check_spec_launches(label, get_config(arch), compress,
                            profile, spec, launches, res)
    return launches


# ---------------------------------------------------------------------------
# DeepSeek-V2 (mla_moe): the latent mode and the expert axis
# ---------------------------------------------------------------------------

DS_H, DS_D, DS_R = 128, 576, 512      # heads, latent row, value rank
DS_EXPERT_SHAPES = {"wg/wu": (1536, 5120), "wd": (5120, 1536)}
DS_KV_A = (576, 5120)     # DeepSeek-V2's kv_a projection (N, K)


def _latent_case(b, t, lens, dtype, g, ps=16, mp=16):
    """Full-width latent pool over a shuffled table: slot i owns
    ceil(max len / ps) pages in table order, the rest are sentinels."""
    num_pages = b * mp
    q = torch.randn((b, t, DS_H, DS_D), generator=g, device="cuda")
    lat = torch.randn((num_pages, ps, DS_D), generator=g,
                      device="cuda").to(dtype)
    perm = torch.randperm(num_pages, generator=g, device="cuda")
    bt = torch.full((b, mp), num_pages, dtype=torch.int32, device="cuda")
    for i in range(b):
        occ = -(-int(lens[i].max()) // ps)
        bt[i, :occ] = perm[i * mp:i * mp + occ].to(torch.int32)
    return q, lat, lens.to("cuda"), bt


def phase_latent_check():
    """The latent mode at full width: 6 slots (slot 3 all-sentinel with
    length 0, slot 4 a real table row but length 0), serve lengths, 256,
    the T=2 staircase, the (2,2) and (4,2,2) tree verify blocks (T=7 and
    29) and the (4,2,2) draft's level calls (T=4 and 8, windows 5 and 13,
    wider than T). Returns the worst max-abs error."""
    from repro_torch.engine.spec import TreeTemplate
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    t422 = TreeTemplate((4, 2, 2))
    trees = {"tree (2,2)": TreeTemplate((2, 2)).verify_tree("cuda"),
             "tree (4,2,2)": t422.verify_tree("cuda"),
             "level 1 of (4,2,2)": t422.level_tree(1, "cuda"),
             "level 2 of (4,2,2)": t422.level_tree(2, "cuda")}
    cases = [("serve", 1, [20, 25, 31, 0, 0, 29]),
             ("256", 1, [256, 256, 256, 0, 0, 256]),
             ("staircase", 2, [1, 37, 254, 0, 0, 129]),
             ("tree (2,2)", 7, [9, 40, 250, 0, 0, 120]),
             ("tree (4,2,2)", 29, [31, 64, 250, 0, 0, 120]),
             ("level 1 of (4,2,2)", 4, [6, 64, 250, 0, 0, 120]),
             ("level 2 of (4,2,2)", 8, [14, 64, 250, 0, 0, 120])]
    for dtype in (torch.bfloat16, torch.float32):
        for label, t, base in cases:
            base = torch.tensor(base)
            spec = trees.get(label)
            if spec is not None:
                require(spec["anc"].shape[0] == t, "tree block width")
                lens = base[:, None].expand(6, t).contiguous()
            else:
                lens = base[:, None] + torch.arange(t)[None, :]
                lens[:, :] = torch.where(base[:, None] > 0, lens, 0)
            lens = lens.to(torch.int32)
            q, lat, lq, bt = _latent_case(6, t, lens, dtype, g)
            bt[4, :2] = bt[1, :2]
            kw = {}
            if spec is not None:
                win = spec["window"]
                anc = spec["anc"][None].expand(6, t).contiguous()
                kw = dict(anc=anc, anc_base=(lq[:, 0] - win).clamp_min(0),
                          anc_window=win)
            before = paged_attention_cuda.latent_launches
            o = ops.paged_latent_attention(q, lat, lq, bt, v_rank=DS_R,
                                           **kw)
            ref = ops.paged_latent_attention(q, lat, lq, bt, v_rank=DS_R,
                                             plain=True, **kw)
            torch.cuda.synchronize()
            require(paged_attention_cuda.latent_launches == before + 1,
                    "one latent-mode launch")
            require(o.shape == (6, t, DS_H, DS_R), "latent output shape")
            require(bool((o[3:5] == 0).all()), "length-0 rows are zeros")
            require(bool(torch.isfinite(o).all()), "latent attention finite")
            err = (o - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            worst = max(worst, err)
            log(f"[latent check] pages={str(dtype)[6:]} {label} T={t} "
                f"H={DS_H} D={DS_D} v_rank={DS_R} ps=16 ("
                f"{split_note(6, 1, t * DS_H, bt.shape[1], DS_R)}): "
                f"max_abs_err {err:.3e} rel {rel:.3e}")
            require(rel <= TOL, f"paged_attention (latent) disagrees: "
                                f"rel {rel}")
            worst = max(worst, split_sweep(
                o, _latent_at(q, lat, lq, bt, **kw), ref, bt.shape[1],
                f"latent pages={str(dtype)[6:]} {label} T={t}"))
    return worst


def _latent_at(q, lat, lq, bt, anc=None, anc_base=None, anc_window=0):
    """``call(n_split)`` for :func:`split_sweep` in the latent mode."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    b, t, h, d = q.shape
    lq2, live = ops.paged_query_prep(lq, bt, b, t, lat.shape[1])
    qh = q.reshape(b, 1, t * h, d).contiguous()
    if anc is not None:
        anc = anc.to(torch.int32).contiguous()
        anc_base = anc_base.to(torch.int32).contiguous()

    def call(n_split):
        return paged_attention_cuda(
            qh, lat[:, :, None, :], None, lq2, bt, live, t, anc=anc,
            anc_base=anc_base, window=anc_window, v_rank=DS_R,
            n_split=n_split).reshape(b, t, h, DS_R)
    return call


def _experts_packed(n, k, seed, e=160, gs=16):
    """E experts of GQSA W4 S50 at group size ``gs`` stacked [E, ...],
    packed on the card one expert at a time (random N(0, 1/K) weights)."""
    from repro_torch.core.model_compress import StackedPacker, slice_packer
    g = torch.Generator(device="cuda").manual_seed(seed)
    packer = StackedPacker(e, slice_packer(_gqsa(gs)))
    for i in range(e):
        packer.put(i, torch.randn((n, k), generator=g, device="cuda")
                   / k ** 0.5)
    return packer.result((e,))["bsr"]


def _dispatch_rows(g, e, tokens, top_k=6):
    """(rows [E], capacity C) of one dispatch of ``tokens`` routed rows
    (``models/moe.py``): each token's top-6 distinct experts, C = max(1,
    int(tokens * 6 / E * 1.25)), rows = min(count, C)."""
    cap = max(1, int(tokens * top_k / e * 1.25))
    ids = torch.stack([torch.randperm(e, generator=g, device="cuda")[:top_k]
                       for _ in range(tokens)]).reshape(-1)
    return (torch.bincount(ids, minlength=e).clamp(max=cap)
            .to(torch.int32), cap)


# C of the expert-axis checks: decode (1), prefill (3, 7, 9, 30) and the
# verify capacities of speculation at 4 slots (2: a chain K=4 verify of
# deepseek-moe-16b; 5 and 13: a (4,2,2) tree verify of DeepSeek-V2 and of
# deepseek-moe-16b)
EXPERT_CAPS = (1, 2, 3, 5, 7, 9, 13, 30)
W4_EXPERT_CAPS = (1, 2, 3, 5, 8, 13, 20)


def phase_experts_check(gs=16, caps=EXPERT_CAPS):
    """The expert axis of gqsa_gemv against its plain version at the
    DeepSeek-V2 (160 experts) and deepseek-moe-16b (64 experts) expert
    shapes at group size ``gs``, C in ``caps``, bf16 and f32 x, ``rows``
    absent and given (a third of the experts idle, partly filled
    buffers): one launch a call at every C, idle rows exact zeros,
    repeats bit-identical. Then
    the idle experts' scales set to NaN and x set to NaN past every
    expert's rows: the output stays finite and equal to the plain
    version's on the clean operands, so nothing idle was read. Returns
    the worst max-abs error."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.kernels.gqsa_gemv import gqsa_gemv_experts_cuda
    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    cases = [(f"deepseek-v2 {label}", 160, n, k)
             for label, (n, k) in DS_EXPERT_SHAPES.items()]
    cases += [(f"deepseek-moe {label}", MOE_EXPERTS, n, k)
              for label, (n, k) in MOE_EXPERT_SHAPES.items()]
    for label, e, n, k in cases:
        bsr = _experts_packed(n, k, SEED + 10, e, gs)
        for c in caps:
            rows = torch.randint(0, c + 1, (e,), generator=g, device="cuda",
                                 dtype=torch.int32)
            rows[:e // 3] = 0
            rows[-1] = c
            idle = torch.arange(c, device="cuda")[None, :] >= rows[:, None]
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((e, c, k), generator=g,
                                device="cuda").to(dt)
                for r in (None, rows):
                    before = gqsa_gemv_experts_cuda.launches
                    y = ops.gqsa_gemv_experts(x, bsr, r)
                    again = ops.gqsa_gemv_experts(x, bsr, r)
                    ref = ops.gqsa_gemv_experts(x, bsr, r, plain=True)
                    torch.cuda.synchronize()
                    require(gqsa_gemv_experts_cuda.launches == before + 2,
                            "one expert-axis launch a call")
                    require(y.shape == (e, c, n)
                            and bool(torch.isfinite(y).all()),
                            "experts output shape/finite")
                    require(torch.equal(y, again), "experts repeat differs")
                    if r is not None:
                        require(bool((y[idle] == 0).all()),
                                "idle expert rows are exact zeros")
                    err = (y - ref).abs().max().item()
                    rel = err / ref.abs().max().item()
                    worst = max(worst, err)
                    log(f"[experts check] {label} E={e} N={n} K={k} G={gs} "
                        f"C={c} x={str(dt)[6:]} rows="
                        f"{'none' if r is None else int(r.sum())}: "
                        f"max_abs_err {err:.3e} rel {rel:.3e}")
                    require(rel <= TOL, f"gqsa_gemv experts disagree: "
                                        f"rel {rel}")
            x = torch.randn((e, c, k), generator=g, device="cuda",
                            dtype=torch.bfloat16)
            ref = ops.gqsa_gemv_experts(x, bsr, rows, plain=True)
            poisoned = dataclasses.replace(bsr, scale=bsr.scale.clone())
            poisoned.scale[rows == 0] = float("nan")
            x[idle] = float("nan")
            y = ops.gqsa_gemv_experts(x, poisoned, rows)
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            log(f"[experts check] {label} G={gs} C={c}: "
                f"{int((rows == 0).sum())} idle experts with NaN scales, x "
                f"NaN past every expert's rows: output finite "
                f"{bool(torch.isfinite(y).all())}, max_abs_err {err:.3e}")
            require(bool(torch.isfinite(y).all()),
                    "an idle expert or row was read")
            require(bool((y[idle] == 0).all()) and err <= TOL * ref.abs()
                    .max().item(), "the poisoned call disagrees")
            del poisoned
        del bsr
    return worst


def phase_mla_moe_timing(timer):
    """Both kernels at the 4-slot DeepSeek-V2 decode shapes: the latent
    mode at serve lengths and at 256 (bf16 pages), the expert axis for one
    layer's three expert projections at C = 1 with one decode step's
    occupied experts. Bound: the larger of the bytes the function must
    move over 3.35 TB/s and its operations over their type's peak: the
    latent mode's f32 over 67 TFLOP/s, the expert axis's bf16 x by 4-bit
    codes over the tensor cores' 989 TFLOP/s."""
    import torch.nn.functional as F
    from repro_torch.core.bsr import to_dense
    from repro_torch.kernels import ops
    from repro_torch.kernels.gqsa_gemv import gqsa_gemv_experts_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    b = 4
    out = {}
    for label, lens in (("serve", [20, 25, 31, 29]),
                        ("256", [256, 256, 256, 256])):
        lq = torch.tensor(lens, dtype=torch.int32)[:, None]
        q, lat, lq, bt = _latent_case(b, 1, lq, torch.bfloat16, g)
        tot = int(sum(lens))
        nbytes = tot * DS_D * 2 + b * DS_H * DS_D * 4 + b * DS_H * DS_R * 4
        flops = 2 * DS_H * tot * (DS_D + DS_R)
        bound, by, bound_f32 = _attn_bound(nbytes, flops)
        lq2, live = ops.paged_query_prep(lq, bt, b, 1, lat.shape[1])
        qh = q.reshape(b, 1, DS_H, DS_D).contiguous()
        lat4 = lat[:, :, None, :]
        t_k = timer.ms(lambda: paged_attention_cuda(
            qh, lat4, None, lq2, bt, live, 1, v_rank=DS_R))
        t_p = timer.ms(lambda: ops.paged_latent_attention(
            q, lat, lq, bt, v_rank=DS_R, plain=True))
        # library yardstick: SDPA on the latent rows gathered contiguous
        # beforehand, the 128 heads as 128 query rows of the one KV head
        smax = max(lens)
        kk = lat[bt.clamp(max=lat.shape[0] - 1).long()].reshape(
            b, -1, DS_D)[:, None, :smax].contiguous()
        vv = kk[..., :DS_R].contiguous()
        mask = (torch.arange(smax, device="cuda")[None, :]
                < lq.to("cuda"))[:, None, None, :]
        qs = qh.to(torch.bfloat16)
        t_l = timer.ms(lambda: F.scaled_dot_product_attention(
            qs, kk, vv, attn_mask=mask))
        log(f"[latent time] {label} lengths={lens} B=4 H=128 D=576 "
            f"v_rank=512 bf16 pages "
            f"({split_note(b, 1, DS_H, bt.shape[1], DS_R)}): kernel "
            f"{t_k * 1e3:.1f}us plain "
            f"{t_p * 1e3:.1f}us sdpa {t_l * 1e3:.1f}us bound "
            f"{bound * 1e3:.2f}us by {by} (f32 rate {bound_f32 * 1e3:.2f}us; "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP) -> "
            f"{bound / t_k:.0%} of bound")
        if "paged_attention_latent" not in out:
            out["paged_attention_latent"] = dict(
                ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bound,
                bound_by=by, bound_f32_ms=bound_f32)

    out["gqsa_gemv_kv_a"] = kv_a_time(timer, g)
    ex = experts_layer(timer, g, "deepseek-v2", 160, DS_EXPERT_SHAPES, 4)
    ex["deepseek_moe_layer"] = experts_layer(
        timer, g, "deepseek-moe-16b", MOE_EXPERTS, MOE_EXPERT_SHAPES, 4)
    ex["prefill"] = [
        experts_layer(timer, g, name, e, shapes, tokens, plain=False)
        for name, e, shapes, tokens in (
            ("deepseek-v2", 160, DS_EXPERT_SHAPES, 64),
            ("deepseek-moe-16b", MOE_EXPERTS, MOE_EXPERT_SHAPES, 64),
            ("deepseek-moe-16b", MOE_EXPERTS, MOE_EXPERT_SHAPES, 256))]
    out["gqsa_gemv_experts"] = ex
    return out


def kv_a_time(timer, g, t=4, gs=16):
    """Single-matrix gqsa_gemv at DeepSeek-V2's kv_a projection (N = 576 =
    kv_lora_rank 512 + rope 64, K = 5120), T = 4 decode rows, bf16 x, at
    group size ``gs``: kernel, plain, ``torch.matmul`` on the dense bf16 W
    and the bound, as :func:`gemv_layer` counts it."""
    from repro_torch.core.bsr import to_dense
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.gqsa_gemv import (gqsa_gemv_cuda,
                                               payload_bytes, plan)
    n, k = DS_KV_A
    bsr = _packed(n, k, SEED + 17, gs)
    x = torch.randn((t, k), generator=g, device="cuda", dtype=torch.bfloat16)
    dense = to_dense(bsr).to(torch.bfloat16)
    m = bsr.idx.shape[1]
    nbytes = n * m * payload_bytes(gs) + t * k * 2 + t * n * 4
    flops = 2 * t * n * m * gs
    bound = _bound_ms(nbytes, flops)
    t_k = timer.ms(lambda: gqsa_gemv_cuda(x, bsr))
    t_p = timer.ms(lambda: ops.gqsa_gemv(x, bsr, plain=True))
    t_l = timer.ms(lambda: torch.matmul(x, dense.T))
    p = plan(t, n, k, gs, 2, sm_count(0))
    by = _bound_by(nbytes, flops)
    log(f"[gemv time] deepseek-v2 kv_a N={n} K={k} M={m} G={gs} T={t} "
        f"bf16 (tile {p.tile}, {p.blocks} blocks): kernel {t_k * 1e3:.1f}us plain "
        f"{t_p * 1e3:.1f}us torch.matmul(dense bf16) {t_l * 1e3:.1f}us "
        f"bound {bound * 1e3:.2f}us by {by} ({nbytes / 1e6:.2f} MB) -> "
        f"{bound / t_k:.0%} of bound")
    return dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bound,
                bound_by=by)


def experts_layer(timer, g, name, e, shapes, tokens, plain=True,
                  dispatch=None, gs=16):
    """One MoE layer's three expert projections (w_g, w_u, w_d) through
    the gqsa_gemv expert axis, bf16 x, with the buffer rows of one
    dispatch of ``tokens`` routed rows (4: a 4-slot decode step, C = 1;
    64 or 256: a prefill): drawn by :func:`_dispatch_rows`, or the
    ``(rows, C)`` of a recorded ``dispatch``. Kernel (one launch a
    projection), plain (when ``plain``), ``torch.bmm`` on the occupied
    experts' dense bf16 weights
    gathered beforehand, and the bound: the larger of the bytes the
    function must move (the occupied experts' payload, gs/2 + 12 bytes a
    kept group at group size ``gs``, their filled x rows and the whole y)
    over 3.35 TB/s and its multiply-adds (bf16 x by 4-bit codes) over the
    tensor cores' 989 TFLOP/s."""
    from repro_torch.core.bsr import to_dense
    from repro_torch.kernels import ops
    from repro_torch.kernels.gqsa_gemv import (gqsa_gemv_experts_cuda,
                                               payload_bytes)
    rows, cap = dispatch or _dispatch_rows(g, e, tokens)
    occ = torch.nonzero(rows).flatten()
    n_occ = int(occ.numel())
    n_rows = int(rows.sum())
    keep = torch.arange(cap, device="cuda")[None, :] < rows[:, None]
    ex = dict(ms=0.0, plain_ms=0.0 if plain else None, library_ms=0.0,
              bound_ms=0.0)
    nbytes_all = flops_all = 0
    for label, (n, k) in shapes.items():
        bsr = _experts_packed(n, k, SEED + 12, e, gs)
        x = (torch.randn((e, cap, k), generator=g, device="cuda",
                         dtype=torch.bfloat16) * keep[..., None])
        m = bsr.idx.shape[-1]
        nbytes = (n_occ * n * m * payload_bytes(gs) + n_rows * k * 2
                  + e * cap * n * 4)
        flops = 2 * n_rows * n * m * gs
        bound = _bound_ms(nbytes, flops)
        # library yardstick: torch.bmm over the occupied experts' dense
        # bf16 weights, gathered beforehand
        dense = torch.stack([to_dense(bsr.layer(int(i))).to(torch.bfloat16)
                             for i in occ])
        xo = x[occ].contiguous()
        before = gqsa_gemv_experts_cuda.launches
        gqsa_gemv_experts_cuda(x, bsr, rows)
        require(gqsa_gemv_experts_cuda.launches == before + 1,
                "one expert-axis launch a projection")
        t_k = timer.ms(lambda: gqsa_gemv_experts_cuda(x, bsr, rows))
        t_p = timer.ms(lambda: ops.gqsa_gemv_experts(
            x, bsr, rows, plain=True), iters=3) if plain else None
        t_l = timer.ms(lambda: torch.bmm(xo, dense.transpose(1, 2)))
        p_note = "-" if t_p is None else f"{t_p * 1e3:.1f}us"
        log(f"[experts time] {name} {label} E={e} N={n} K={k} M={m} "
            f"G={gs} C={cap} ({tokens} routed rows: {n_occ} occupied experts, "
            f"{n_rows} filled rows), bf16 x, one launch: kernel "
            f"{t_k * 1e3:.1f}us plain {p_note} "
            f"torch.bmm(dense bf16, occupied) {t_l * 1e3:.1f}us bound "
            f"{bound * 1e3:.2f}us ({nbytes / 1e6:.1f} MB) -> "
            f"{bound / t_k:.0%} of bound")
        c = 2 if label == "wg/wu" else 1
        for key, v in zip(("ms", "plain_ms", "library_ms", "bound_ms"),
                          (t_k, t_p, t_l, bound)):
            if v is not None:
                ex[key] += c * v
        nbytes_all += c * nbytes
        flops_all += c * flops
        del bsr, dense
    ex["bound_by"] = ("bytes" if nbytes_all / HBM_BYTES_PER_S
                      >= flops_all / BF16_TC_FLOP_PER_S else "operations")
    ex.update(model=name, capacity=cap, routed_rows=tokens, occupied=n_occ,
              filled_rows=n_rows, launches=3, group_size=gs)
    plain_note = ("-" if ex["plain_ms"] is None
                  else f"{ex['plain_ms']:.4f}ms")
    log(f"[experts time] {name}: one layer (3 expert projections, G={gs}, "
        f"C={cap}, {n_occ} of {e} occupied, {n_rows} filled rows): kernel "
        f"{ex['ms']:.4f}ms plain {plain_note} bmm {ex['library_ms']:.4f}ms "
        f"bound {ex['bound_ms']:.4f}ms by {ex['bound_by']} "
        f"({ex['bound_ms'] / ex['ms']:.0%} of bound)")
    return ex


DS_LAYERS = 8           # of the published 60: 2.36 GB of experts a layer
DS_CHECK_LAYERS = 2     # the kernel-vs-plain check's depth


def _route_gaps(gaps, forced):
    """A wrapper of ``moe.route`` that records, per call, the smallest gap
    between the k-th and (k+1)-th router probability of any row (where a
    tiny difference between two paths can swap an expert). With
    ``forced["mode"]`` "record" it also keeps each call's expert ids; with
    "replay" it routes to the recorded ids instead of its own (gates from
    its own probabilities at those ids) and counts in ``forced["moved"]``
    the rows whose own choice differed, of ``forced["rows"]``."""
    from repro_torch.models import moe
    inner = moe.route

    def spy(router_p, x, cfg_moe, aux=True):
        gates, ids, loss = inner(router_p, x, cfg_moe, aux)
        probs = torch.softmax(x.float() @ router_p["w"].float().T, dim=-1)
        top = probs.topk(cfg_moe.top_k + 1, dim=-1).values
        gaps.append((top[:, -2] - top[:, -1]).min().item())
        if forced["mode"] == "record":
            forced["ids"].append(ids)
        elif forced["mode"] == "replay":
            want = forced["ids"].pop(0)
            forced["moved"] += int((ids.sort(-1).values
                                    != want.sort(-1).values).any(-1).sum())
            forced["rows"] += ids.shape[0]
            vals = probs.gather(1, want)
            gates = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
            ids = want
        return gates, ids, loss
    return inner, spy


def phase_model_deepseek():
    """DeepSeek-V2 at full width and 8 layers: the kernel-vs-plain logits
    check on its first 2 layers (the plain experts dequantize 160 experts
    per projection per step), the profiled decode step, and the main path:
    the engine serves 8 requests x 32 new tokens on 4 slots."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core.gqs_layer import GQSAConfig
    from repro_torch.models import transformer as tf
    full = dataclasses.replace(get_config("deepseek_v2_236b"),
                               n_layers=DS_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = tf.init_params(SEED, full, "cuda", compress=GQSAConfig())
    torch.cuda.synchronize()
    packed = _packed_bytes(params["layers"])
    log(f"[model] deepseek-v2-236b full width, {DS_LAYERS} of 60 layers, "
        f"GQSA W4 S50 G16 packed on the card expert by expert in "
        f"{time.time() - t0:.1f}s: {packed / 1e9:.3f} GB of packed linears; "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    toks, lens, bt, num_pages, ps = check_routed(
        params, full, DS_CHECK_LAYERS,
        f"deepseek {DS_CHECK_LAYERS} of {DS_LAYERS} layers")
    log(f"[model] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB")
    profile_decode(params, full, toks, lens, bt, num_pages, ps,
                   label=f"deepseek bf16 decode step at 4 slots, "
                         f"{DS_LAYERS} layers")
    launches = engine_deepseek(params, full)
    del params
    return launches


def check_routed(params, full, n_check, label):
    """:func:`check_model` on the first ``n_check`` layers of an MoE model
    (the plain experts dequantize every expert of every projection per
    step), logging the smallest gap between the k-th and the next router
    probability: where a tiny difference between the two paths can swap
    an expert. In bf16 the plain run routes every token to the experts
    the kernel run chose, as it is fed the kernel run's tokens: a one-ulp
    bf16 difference flips a near-tie routing and swaps a whole expert's
    output, which no logits bar can tell from a fault; the flips it would
    have made are counted and logged. f32 runs route on their own."""
    import dataclasses
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    cut = dataclasses.replace(full, n_layers=n_check)
    sub = dict(params, layers=tf.layer_params(params["layers"],
                                              slice(0, n_check)))
    gaps = []
    forced = dict(mode=None, ids=[], moved=0, rows=0)
    inner, spy = _route_gaps(gaps, forced)

    def on_run(dtype, plain):
        if not plain:
            require(not forced["ids"], "the plain run replayed every routing")
        forced["mode"] = (None if dtype == "float32"
                          else "replay" if plain else "record")

    def log_gaps(when):
        log(f"[model {label}] smallest gap between the k-th and next "
            f"router probability {when}: "
            f"{min(gaps, default=float('nan')):.3e} "
            f"({sum(x < 1e-5 for x in gaps)} of {len(gaps)} routings under "
            f"1e-5); the bf16 plain run would have routed "
            f"{forced['moved']} of {forced['rows']} tokens to other "
            f"experts than the kernel run (it took the kernel run's)")

    moe.route = spy
    try:
        toks, lens, bt, num_pages, ps = check_model(sub, cut, label,
                                                    on_run=on_run)
    except AssertionError:
        log_gaps("in the failing check")
        raise
    finally:
        moe.route = inner
    log_gaps("over the check")
    require(not forced["ids"], "the plain run replayed every routing")
    return toks, lens, bt, num_pages, ps


def engine_deepseek(params, full, compress="gqsa"):
    """The DeepSeek-V2 main path: the engine serves 8 requests (4-15
    prompt tokens, 32 new) on 4 slots, max_seq 256, greedy, bf16, its
    linears packed by ``compress`` ("gqsa" or "w4")."""
    from repro_torch.engine import EngineConfig, InferenceEngine
    from repro_torch.launch.serve import make_requests
    prompts = make_requests(8, full.vocab, np.random.default_rng(SEED))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    eng = InferenceEngine(full, params, EngineConfig(
        num_slots=4, max_seq=256, seed=SEED, device="cuda"))
    require(set(eng.kv.data) == {"lat_pages"}, "one latent pool")
    for p in prompts:
        eng.submit(p, 32)
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    tag = "deepseek" if compress == "gqsa" else f"deepseek {compress}"
    log(f"[engine {tag}] {eng.metrics.format_summary()}")
    log(f"[engine {tag}] {full.n_layers} of 60 layers (host work is a "
        f"larger share of a step than at full depth); wall {wall:.1f}s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"launches {launches}")
    require(len(res["results"]) == 8, "all 8 requests answered")
    require(all(len(r["tokens"]) == 32 for r in res["results"]),
            "every request got 32 tokens")
    require(all(0 <= int(t) < full.vocab for r in res["results"]
                for t in r["tokens"]), "tokens in the vocabulary")
    linear = "gqsa_gemv" if compress == "gqsa" else "w4_matmul"
    other = "w4_matmul" if compress == "gqsa" else "gqsa_gemv"
    require(launches[f"{linear}_experts"] > 0
            and launches["paged_attention_latent"] > 0
            and launches[linear] > 0,
            f"the expert axis, the latent mode and {linear} launched on "
            f"the DeepSeek path")
    require(launches["paged_attention"] == 0
            and launches["paged_attention_int8"] == 0
            and launches["paged_attention_tree"] == 0
            and launches[other] == 0 and launches[f"{other}_experts"] == 0,
            f"no other attention mode and no {other} on the DeepSeek path")
    return launches


# ---------------------------------------------------------------------------
# deepseek-moe-16b (moe) and the expert axis of w4_matmul
# ---------------------------------------------------------------------------

MOE_EXPERTS = 64
MOE_EXPERT_SHAPES = {"wg/wu": (1408, 2048), "wd": (2048, 1408)}
MOE_CHECK_LAYERS = 4    # of the 28, the kernel-vs-plain check's depth
DS_W4_LAYERS = 4        # of the 60: 3.8 GB of W4 experts a layer


def _w4_experts_packed(e, n, k, seed):
    """E experts of dense W4 G16 stacked [E, ...], packed on the card one
    expert at a time (random N(0, 1/K) weights)."""
    from repro_torch.core.model_compress import StackedPacker, slice_packer
    from repro_torch.core.quant import QuantConfig
    g = torch.Generator(device="cuda").manual_seed(seed)
    packer = StackedPacker(e, slice_packer(QuantConfig(bits=4,
                                                       group_size=16)))
    for i in range(e):
        packer.put(i, torch.randn((n, k), generator=g, device="cuda")
                   / k ** 0.5)
    return packer.result((e,))


def phase_w4_experts_check():
    """The expert axis of w4_matmul against its plain version at the
    deepseek-moe-16b (64 experts) and DeepSeek-V2 (160 experts) expert
    shapes and a CUDA-core one (K = 48), C in W4_EXPERT_CAPS, bf16 and f32
    x, ``rows`` absent and given (a third of the experts idle): one launch
    a call, idle rows exact zeros, repeats bit-identical. Then the idle
    experts' scales set to NaN and x set to NaN past every expert's rows:
    every output stays finite, so nothing idle was read. Returns the worst
    max-abs error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.w4_matmul import (takes_tensor_cores,
                                               w4_matmul_experts_cuda)
    worst = 0.0
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    cases = [(f"deepseek-moe {label}", MOE_EXPERTS, n, k)
             for label, (n, k) in MOE_EXPERT_SHAPES.items()]
    cases += [(f"deepseek-v2 {label}", 160, n, k)
              for label, (n, k) in DS_EXPERT_SHAPES.items()]
    cases.append(("CUDA cores", 8, 100, 48))
    for label, e, n, k in cases:
        p = _w4_experts_packed(e, n, k, SEED + 14)
        args = (p["qw"], p["scale"], p["zero"])
        path = "tc" if takes_tensor_cores(
            k, 16, *(t.data_ptr() for t in args)) else "simt"
        require(path == ("simt" if label == "CUDA cores" else "tc"),
                "the expert shapes take the tensor cores")
        for c in W4_EXPERT_CAPS:
            rows = torch.randint(0, c + 1, (e,), generator=g, device="cuda",
                                 dtype=torch.int32)
            rows[:e // 3] = 0
            rows[-1] = c
            idle = torch.arange(c, device="cuda")[None, :] >= rows[:, None]
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((e, c, k), generator=g, device="cuda").to(dt)
                for r in (None, rows):
                    before = w4_matmul_experts_cuda.launches
                    y = ops.w4_matmul_experts(x, *args, r, group_size=16)
                    again = ops.w4_matmul_experts(x, *args, r, group_size=16)
                    ref = ops.w4_matmul_experts(x, *args, r, group_size=16,
                                                plain=True)
                    torch.cuda.synchronize()
                    require(w4_matmul_experts_cuda.launches == before + 2,
                            "one expert-axis launch a call")
                    require(y.shape == (e, c, n)
                            and bool(torch.isfinite(y).all()),
                            "experts output shape/finite")
                    require(torch.equal(y, again), "experts repeat differs")
                    if r is not None:
                        require(bool((y[idle] == 0).all()),
                                "idle expert rows are exact zeros")
                    err = (y - ref).abs().max().item()
                    rel = err / ref.abs().max().item()
                    worst = max(worst, err)
                    log(f"[w4 experts check] {label} E={e} N={n} K={k} C={c}"
                        f" x={str(dt)[6:]} path={path} rows="
                        f"{'none' if r is None else int(r.sum())}: "
                        f"max_abs_err {err:.3e} rel {rel:.3e}")
                    require(rel <= TOL, f"w4_matmul experts disagree: "
                                        f"rel {rel}")
            x = torch.randn((e, c, k), generator=g, device="cuda",
                            dtype=torch.bfloat16)
            ref = ops.w4_matmul_experts(x, *args, rows, group_size=16,
                                        plain=True)
            scale = p["scale"].clone()
            scale[rows == 0] = float("nan")
            x[idle] = float("nan")
            y = ops.w4_matmul_experts(x, p["qw"], scale, p["zero"], rows,
                                      group_size=16)
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            log(f"[w4 experts check] {label} C={c}: "
                f"{int((rows == 0).sum())} idle experts with NaN scales, x "
                f"NaN past every expert's rows: output finite "
                f"{bool(torch.isfinite(y).all())}, max_abs_err {err:.3e}")
            require(bool(torch.isfinite(y).all()),
                    "an idle expert or row was read")
            require(bool((y[idle] == 0).all()) and err <= TOL * ref.abs()
                    .max().item(), "the poisoned call disagrees")
            del scale
        del p, args
    return worst


def w4_experts_layer(timer, g, name, e, shapes, tokens=4, plain=True,
                     dispatch=None):
    """One MoE layer's three expert projections (wg, wu, wd) through the
    W4 expert axis with the buffer rows of one dispatch of ``tokens``
    routed rows (:func:`_dispatch_rows`, or the ``(rows, C)`` of a
    recorded ``dispatch``; 4: a 4-slot decode step, C = 1): kernel, plain
    (when ``plain``), ``torch.bmm`` on the occupied
    experts' dense bf16 weights gathered beforehand, and the bound: the
    occupied experts' codes, scales and zeros, their filled x rows and
    the whole y over 3.35 TB/s, or their multiply-adds over the bf16
    tensor cores' 989 TFLOP/s, whichever is larger."""
    from repro_torch.core.quant import QuantConfig, dequantize, unpack_int4
    from repro_torch.kernels import ops
    from repro_torch.kernels.w4_matmul import w4_matmul_experts_cuda
    rows, cap = dispatch or _dispatch_rows(g, e, tokens)
    occ = torch.nonzero(rows).flatten()
    n_occ = int(occ.numel())
    n_rows = int(rows.sum())
    keep = torch.arange(cap, device="cuda")[None, :] < rows[:, None]
    ex = dict(ms=0.0, plain_ms=0.0 if plain else None, library_ms=0.0,
              bound_ms=0.0)
    nbytes_all = flops_all = 0
    for label, (n, k) in shapes.items():
        p = _w4_experts_packed(e, n, k, SEED + 15)
        args = (p["qw"], p["scale"], p["zero"])
        x = (torch.randn((e, cap, k), generator=g, device="cuda",
                         dtype=torch.bfloat16) * keep[..., None])
        nbytes = (n_occ * (n * k // 2 + 8 * n * (k // 16)) + n_rows * k * 2
                  + e * cap * n * 4)
        flops = 2 * n_rows * n * k
        bound = _bound_ms(nbytes, flops)
        dense = torch.stack([dequantize(
            unpack_int4(p["qw"][i]), p["scale"][i], p["zero"][i],
            QuantConfig(group_size=16), torch.bfloat16) for i in occ])
        xo = x[occ].contiguous()
        t_k = timer.ms(lambda: w4_matmul_experts_cuda(x, *args, rows, 16))
        t_p = timer.ms(lambda: ops.w4_matmul_experts(
            x, *args, rows, group_size=16, plain=True), iters=3) \
            if plain else None
        t_l = timer.ms(lambda: torch.bmm(xo, dense.transpose(1, 2)))
        p_note = "-" if t_p is None else f"{t_p * 1e3:.1f}us"
        log(f"[w4 experts time] {name} {label} E={e} N={n} K={k} C={cap}, "
            f"{n_occ} occupied experts, {n_rows} filled rows, bf16 x: "
            f"kernel {t_k * 1e3:.1f}us plain {p_note} "
            f"torch.bmm(dense bf16, occupied) {t_l * 1e3:.1f}us bound "
            f"{bound * 1e3:.2f}us ({nbytes / 1e6:.1f} MB) -> "
            f"{bound / t_k:.0%} of bound")
        c = 2 if label == "wg/wu" else 1
        for key, v in zip(("ms", "plain_ms", "library_ms", "bound_ms"),
                          (t_k, t_p, t_l, bound)):
            if v is not None:
                ex[key] += c * v
        nbytes_all += c * nbytes
        flops_all += c * flops
        del p, args, dense
    ex["bound_by"] = ("bytes" if nbytes_all / HBM_BYTES_PER_S
                      >= flops_all / BF16_TC_FLOP_PER_S else "operations")
    ex.update(occupied=n_occ, capacity=cap, routed_rows=tokens,
              filled_rows=n_rows)
    plain_note = ("-" if ex["plain_ms"] is None
                  else f"{ex['plain_ms']:.4f}ms")
    log(f"[w4 experts time] {name}: one layer (3 expert projections, "
        f"C={cap}, {n_occ} of {e} occupied, {n_rows} filled rows): kernel "
        f"{ex['ms']:.4f}ms plain {plain_note} bmm {ex['library_ms']:.4f}ms "
        f"bound {ex['bound_ms']:.4f}ms by {ex['bound_by']} "
        f"({ex['bound_ms'] / ex['ms']:.0%} of bound)")
    return ex


def phase_w4_experts_timing(timer):
    """The W4 expert axis at 4-slot decode: a deepseek-moe-16b layer (the
    kernel line's numbers) and a DeepSeek-V2 layer."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 16)
    out = w4_experts_layer(timer, g, "deepseek-moe-16b", MOE_EXPERTS,
                           MOE_EXPERT_SHAPES)
    out["deepseek_v2_layer"] = w4_experts_layer(timer, g, "deepseek-v2",
                                                160, DS_EXPERT_SHAPES)
    return {"w4_matmul_experts": out}


def _packed_bytes(tree):
    """Bytes of a tree's packed linears: GQSA payloads, or W4 codes,
    scales and zeros."""
    if isinstance(tree, dict):
        if "qw" in tree:
            return sum(t.numel() * t.element_size() for t in tree.values())
        return sum(_packed_bytes(v) for v in tree.values())
    return tree.nbytes_packed() if hasattr(tree, "nbytes_packed") else 0


def phase_model_moe(compress):
    """deepseek-moe-16b at full width and all 28 layers under ``compress``
    ("gqsa": GQSA W4 S50 G16; "w4": dense W4 G16), packed on the card
    expert by expert: kernel vs plain logits on its first 4 layers and a
    profiled bf16 decode step of all 28."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.gqs_layer import GQSAConfig
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models import transformer as tf
    full = get_config("deepseek_moe_16b")
    packing = (GQSAConfig() if compress == "gqsa"
               else QuantConfig(bits=4, group_size=16))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = tf.init_params(SEED, full, "cuda", compress=packing)
    torch.cuda.synchronize()
    log(f"[model] deepseek-moe-16b full width and depth ({full.n_layers} "
        f"layers), {compress} packed on the card expert by expert in "
        f"{time.time() - t0:.1f}s: "
        f"{_packed_bytes(params['layers']) / 1e9:.3f} GB of packed linears; "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    toks, lens, bt, num_pages, ps = check_routed(
        params, full, MOE_CHECK_LAYERS,
        f"deepseek-moe {compress} {MOE_CHECK_LAYERS} of {full.n_layers} "
        f"layers")
    log(f"[model] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB")
    profile_decode(params, full, toks, lens, bt, num_pages, ps,
                   label=f"deepseek-moe {compress} bf16 decode step at 4 "
                         f"slots, {full.n_layers} layers")
    del params


def phase_model_deepseek_w4():
    """DeepSeek-V2 under dense W4 G16 (``--compress w4``, the paper's
    W4A16 baseline on the repo's other MoE model) at full width and 4 of
    its 60 layers: kernel vs plain logits on 2 layers, and its main path,
    the engine serving 8 requests x 32 new tokens on 4 slots."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models import transformer as tf
    full = dataclasses.replace(get_config("deepseek_v2_236b"),
                               n_layers=DS_W4_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = tf.init_params(SEED, full, "cuda",
                            compress=QuantConfig(bits=4, group_size=16))
    torch.cuda.synchronize()
    log(f"[model] deepseek-v2-236b full width, {DS_W4_LAYERS} of 60 layers, "
        f"dense W4 G16 packed on the card expert by expert in "
        f"{time.time() - t0:.1f}s: "
        f"{_packed_bytes(params['layers']) / 1e9:.3f} GB of packed linears; "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    check_routed(params, full, DS_CHECK_LAYERS,
                 f"deepseek w4 {DS_CHECK_LAYERS} of {DS_W4_LAYERS} layers")
    launches = engine_deepseek(params, full, "w4")
    del params
    return launches


STATIC_B = 4
KV_DECODE_S = (64, 1000, 4096, 32768)   # 1000: a partial last chunk
KV_DECODE_TIMED = (4096, 32768)          # lengths of the timing
STATIC_MAX_SEQ = 32768                   # the main path's cache
STATIC_CHECK_SEQ = 4096                  # the kernel-vs-plain model check
STATIC_PROMPTS = (7, 12, 4, 15)
STATIC_FILL = 32704                      # positions of synthetic history


def _kv_cache_case(g, s, b=STATIC_B, kh=32, r=1, d=128):
    """q [B, KH, R, D] f32 and a contiguous int8 cache of random K/V
    quantized per token and head: (q, k, k_scale, v, v_scale)."""
    from repro_torch.models.layers import quantize_kv
    q = torch.randn((b, kh, r, d), generator=g, device="cuda")
    (k8, ks), (v8, vs) = (quantize_kv(torch.randn(
        (b, s, kh, d), generator=g, device="cuda", dtype=torch.bfloat16))
        for _ in range(2))
    return q, k8, ks, v8, vs


def phase_kv_decode_check():
    """(a) kv_decode_attention against its plain version, B=4 KH=32 R=1
    D=128: every S of ``KV_DECODE_S`` at a shared length, per-slot lengths
    with a row of 0 (exact zeros), and the full length; one launch a
    call, repeats bit-identical. Returns the worst max-abs error."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 18)
    worst = 0.0
    for s in KV_DECODE_S:
        worst = max(worst, _kv_decode_check(g, s))
    torch.cuda.empty_cache()
    return worst


def _kv_decode_check(g, s, kh=32, r=1):
    """kv_decode_attention against its plain version, B=4, ``kh`` KV heads
    of ``r`` query rows, D=128, over S = ``s`` positions: a shared length,
    per-slot lengths with a row of 0 (exact zeros) and the full length;
    one launch a call, repeats bit-identical. Returns the worst max-abs
    error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.kv_decode_attention import (
        kv_decode_attention_cuda, plan)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    case = _kv_cache_case(g, s, kh=kh, r=r)
    p = plan(STATIC_B, kh, s, r, 128, sms)
    worst = 0.0
    for label, ln in (("shared", s - 7), ("per-slot", [s, 0, s // 3, 5]),
                      ("full", s)):
        ln = torch.tensor(ln, dtype=torch.int32, device="cuda")
        before = kv_decode_attention_cuda.launches
        o = ops.kv_decode_attention(*case, ln)
        require(kv_decode_attention_cuda.launches == before + 1,
                "one launch a call")
        ref = ops.kv_decode_attention(*case, ln, plain=True)
        torch.cuda.synchronize()
        err = (o - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        worst = max(worst, err)
        require(bool(torch.isfinite(o).all()) and rel <= TOL,
                f"kv_decode_attention S={s} KH={kh} R={r} {label}: rel {rel}")
        require(torch.equal(o, ops.kv_decode_attention(*case, ln)),
                "repeat not bit-identical")
        if ln.ndim:
            require(bool((o[1] == 0).all()), "length-0 row is zeros")
        log(f"[kv_decode check] S={s} KH={kh} R={r} ({p.heads} heads a "
            f"block, {p.stages} stages, {p.n_split} splits, {p.smem} B of "
            f"shared memory) {label} lengths: max_abs_err {err:.3e} (rel "
            f"{rel:.2e}, bar {TOL:.0e}); repeat bit-identical")
    return worst


def phase_kv_decode_timing(timer, kh=32, r=1):
    """(b) kv_decode_attention at B=4 KH=32 R=1 D=128 (or ``kh`` KV heads
    of ``r`` query rows), full lengths 4096 and 32768: the kernel alone
    on the dispatcher's operands, the plain version, SDPA on K/V
    dequantized to bf16 beforehand (dequantization and the KV heads'
    repeat over their query rows not timed) and the bound (codes and
    scales read once; 4 R flops a code pair at the f32 rate)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.kv_decode_attention import (
        kv_decode_attention_cuda, plan)
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    b, d = STATIC_B, 128
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for s in KV_DECODE_TIMED:
        q, k8, ks, v8, vs = _kv_cache_case(g, s, kh=kh, r=r)
        ln = torch.tensor(s, dtype=torch.int32, device="cuda")
        p = plan(b, kh, s, r, d, sms)
        t_k = timer.ms(lambda: kv_decode_attention_cuda(q, k8, ks, v8, vs,
                                                        ln))
        t_p = timer.ms(lambda: ops.kv_decode_attention(
            q, k8, ks, v8, vs, ln, plain=True), iters=5)
        kk, vv = ((c.float() * sc[..., None]).to(torch.bfloat16)
                  .permute(0, 2, 1, 3).repeat_interleave(r, dim=1)
                  .contiguous() for c, sc in ((k8, ks), (v8, vs)))
        qs = q.reshape(b, kh * r, 1, d).to(torch.bfloat16)
        t_l = timer.ms(lambda: F.scaled_dot_product_attention(qs, kk, vv))
        nbytes = 2 * b * s * kh * (d + 4) + 2 * b * kh * r * d * 4
        flops = 4 * b * s * kh * r * d
        bound, by, bound_f32 = _attn_bound(nbytes, flops)
        log(f"[kv_decode time] B=4 KH={kh} R={r} D=128 S=length={s} "
            f"({p.heads} heads a block, {p.stages} stages, {p.n_split} "
            f"splits): kernel {t_k * 1e3:.1f}us plain {t_p * 1e3:.1f}us "
            f"sdpa {t_l * 1e3:.1f}us bound {bound * 1e3:.1f}us by {by} "
            f"(f32 rate {bound_f32 * 1e3:.1f}us; {nbytes / 1e9:.4f} GB) -> "
            f"{bound / t_k:.0%} of bound")
        out[str(s)] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                           bound_ms=bound, bound_by=by,
                           bound_f32_ms=bound_f32)
        del q, k8, ks, v8, vs, kk, vv, qs
        torch.cuda.empty_cache()
    return dict(out[str(KV_DECODE_TIMED[-1])], lengths=out)


def _static_prompts(vocab, seed=SEED):
    rng = np.random.default_rng(seed)
    toks = np.zeros((STATIC_B, max(STATIC_PROMPTS)), np.int32)
    for i, n in enumerate(STATIC_PROMPTS):
        toks[i, :n] = rng.integers(0, vocab, n)
    return (torch.from_numpy(toks).cuda(),
            torch.tensor(STATIC_PROMPTS, device="cuda"))


def serve_static(params, cfg, cache, new, plain=False, feed=None,
                 with_logits=False):
    """The static-batch serve loop through ``build_serve_step`` at a
    shared ``pos``: each prompt teacher-forced, then greedy tokens, until
    every sequence has ``new`` of them. ``feed``: tokens to feed instead
    of the greedy ones (the plain run takes the kernel run's). Returns
    (fed tokens, logits per step or None)."""
    from repro_torch.launch.steps import build_serve_step
    toks, lens = _static_prompts(cfg.vocab)
    step = build_serve_step(cfg, plain=plain, with_logits=with_logits)
    n_steps = int(max(STATIC_PROMPTS)) + new - 1
    tok = toks[:, :1].int()
    fed, logits = [], []
    for i in range(n_steps):
        fed.append(tok)
        out = step(params, cache, tok,
                   torch.tensor(i, dtype=torch.int32, device="cuda"))
        if with_logits:
            logits.append(out[2].float())
        nxt = out[0] if feed is None else feed[i + 1]
        prompt = toks[:, i + 1:i + 2] if i + 1 < toks.shape[1] \
            else toks[:, :1]
        tok = torch.where((i + 1 < lens)[:, None], prompt.int(), nxt)
    return fed + [tok], (logits if with_logits else None)


def phase_static(arch="llama2_7b"):
    """Phase 18, the static-batch contiguous path at full width and depth
    of ``arch`` (llama2-7b; phase 21 runs starcoder2-3b), GQSA
    W4 S50 G16 packed on the card: (c) the serve step through the kernels
    against the plain versions on an int8 cache of 4096 positions, f32
    and bf16; (d) f32 serve steps with an f32 cache against the prefill
    step's forward at every prompt position; (e) the main path: bf16,
    int8 cache of 32768 positions, 4 sequences each served 32 greedy
    tokens after its teacher-forced prompt; (f) a profiled decode step at
    32704-32711 positions of synthetic history. Returns the main path's
    launch counts."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core.gqs_layer import GQSAConfig
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import quantize_kv
    full = dataclasses.replace(get_config(arch), kv_cache_dtype="int8")
    t0 = time.time()
    params = tf.init_params(SEED, full, "cuda", compress=GQSAConfig())
    torch.cuda.synchronize()
    log(f"[static] {full.name} full width, GQSA W4 S50 G16 packed on the "
        f"card in {time.time() - t0:.1f}s")

    # (c) kernels vs plain, int8 cache
    for dtype, tol in (("float32", LOGITS_TOL_INT8_F32),
                       ("bfloat16", LOGITS_TOL_BF16)):
        cfg = dataclasses.replace(full, dtype=dtype)
        runs = []
        for plain in (False, True):
            cache = tf.init_cache(cfg, STATIC_B, STATIC_CHECK_SEQ,
                                  device="cuda")
            runs.append(serve_static(params, cfg, cache, 4, plain,
                                     feed=runs[0][0] if plain else None,
                                     with_logits=True))
            del cache
        for i, (a, p) in enumerate(zip(runs[0][1], runs[1][1])):
            compare_logits(a, p, tol, f"static int8 {full.name} {dtype}",
                           f"step {i}")
    # (d) the serve step against the prefill step's forward, f32
    cfg = dataclasses.replace(full, dtype="float32", kv_cache_dtype="bf16")
    toks = _static_prompts(cfg.vocab, SEED + 1)[0][:, :12]
    serve = build_serve_step(cfg, with_logits=True)
    prefill = build_prefill_step(cfg, with_logits=True)
    cache = tf.init_cache(cfg, STATIC_B, 16, device="cuda")
    for i in range(toks.shape[1]):
        tok, _, logits = serve(params, cache, toks[:, i:i + 1].int(),
                               torch.tensor(i, device="cuda"))
        ptok, plogits = prefill(params, {"tokens": toks[:, :i + 1]})
        compare_logits(logits, plogits, LOGITS_TOL_F32,
                       f"static f32 serve vs forward {full.name}",
                       f"position {i}")
    del cache
    torch.cuda.empty_cache()

    # (e) the main path
    cfg = dataclasses.replace(full, dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    cache = tf.init_cache(cfg, STATIC_B, STATIC_MAX_SEQ, device="cuda")
    nbytes = {k: v.numel() * v.element_size() for k, v in cache.items()}
    log(f"[static] int8 cache, {STATIC_B} x {STATIC_MAX_SEQ} positions: "
        f"codes {(nbytes['k'] + nbytes['v']) / 1e9:.2f} GB, scales "
        f"{(nbytes['k_scale'] + nbytes['v_scale']) / 1e9:.2f} GB")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    fed, _ = serve_static(params, cfg, cache, 32)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    n_steps = len(fed) - 1
    out = torch.cat(fed[1:], dim=1)
    log(f"[static serve] {full.name}: {n_steps} steps of 4 sequences in "
        f"{wall:.2f}s "
        f"({wall / n_steps * 1e3:.2f} ms a step, "
        f"{STATIC_B * 32 / wall:.1f} tok/s over the 32 greedy tokens a "
        f"sequence); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{launches}")
    require(out.shape == (STATIC_B, n_steps)
            and bool(((out >= 0) & (out < cfg.vocab)).all()),
            "every step gave a token of the vocabulary per sequence")
    require(launches["kv_decode_attention"] == cfg.n_layers * n_steps,
            "kv_decode_attention launched once a layer a step")
    require(launches["gqsa_gemv"] > 0
            and all(launches[k] == 0 for k in (
                "paged_attention", "paged_attention_int8",
                "paged_attention_tree", "paged_attention_latent")),
            "gqsa_gemv launched and no paged-pool attention launch on the "
            "static path")

    # (f) a profiled step at 32k positions of synthetic history
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    for i in range(cfg.n_layers):
        for name in ("k", "v"):
            codes, scales = quantize_kv(torch.randn(
                (STATIC_B, STATIC_FILL, cfg.n_kv_heads, cfg.hd),
                generator=g, device="cuda", dtype=torch.bfloat16))
            cache[name][i, :, :STATIC_FILL] = codes
            cache[f"{name}_scale"][i, :, :STATIC_FILL] = scales
    step = build_serve_step(cfg)
    pos = torch.tensor(STATIC_FILL, dtype=torch.int32, device="cuda")
    tok = out[:, -1:]

    def one():
        nonlocal pos
        step(params, cache, tok, pos)
        pos = pos + 1

    profile_steps(one, 8, f"{full.name} bf16 static int8 decode step at 4 "
                          f"x {STATIC_FILL}-{STATIC_FILL + 16} positions "
                          f"(synthetic history)")
    del cache, params
    return launches


# ---------------------------------------------------------------------------
# speculation on the MoE families (phase 19)
# ---------------------------------------------------------------------------

# capacity factors at which no routed entry drops: C >= the routed rows
# needs factor >= E / top_k (64 / 6 and 160 / 6)
MOE_DROPLESS = {"deepseek_moe_16b": 11.0, "deepseek_v2_236b": 27.0}
DS_SPEC_F32_LAYERS = 4   # DeepSeek-V2's depth in the f32 spec check


@contextlib.contextmanager
def recording_routes(n_rows):
    """Keeps the expert ids ([rows, top_k], on the card) of every routing
    of ``n_rows`` rows while the block runs. At 4 slots these are the
    verify blocks' (4 x (K + 1) rows for a chain, 4 x 29 for a (4, 2, 2)
    tree): no prefill (4 x a power of two) or draft call (4 x 1, 4 or 8)
    routes as many."""
    from repro_torch.models import moe
    inner, kept = moe.route, []

    def keep(router_p, x, cfg_moe, aux=True):
        out = inner(router_p, x, cfg_moe, aux)
        if x.shape[0] == n_rows:
            kept.append(out[1])
        return out
    moe.route = keep
    try:
        yield kept
    finally:
        moe.route = inner


def verify_rows(spec, slots=4):
    """Rows a verify call routes: slots x (K + 1), or slots x the tree's
    fed tokens."""
    from repro_torch.engine.spec import TreeTemplate
    if "spec_k" in spec:
        return slots * (spec["spec_k"] + 1)
    return slots * (TreeTemplate(spec["spec_fanout"]).n_nodes + 1)


def verify_dispatch(kept, cfg, label):
    """``(rows [E], C)`` of one recorded verify dispatch (each MoE layer
    of each verify call is one) at the config's capacity factor: the
    median by occupied experts, then filled rows. Logs the spread over
    all of them."""
    from repro_torch.models import moe
    require(len(kept) > 0, f"{label}: verify dispatches recorded")
    e, n = cfg.moe.n_experts, kept[0].shape[0]
    cap = moe.capacity(n, cfg.moe)
    rows = torch.stack([torch.bincount(ids.reshape(-1), minlength=e)
                        for ids in kept]).clamp(max=cap).to(torch.int32)
    occ = (rows > 0).sum(1).cpu()
    filled = rows.sum(1).cpu()
    mid = int(torch.argsort(occ * (n * cfg.moe.top_k + 1) + filled)
              [len(kept) // 2])
    log(f"[verify dispatch] {label}: {len(kept)} dispatches of {n} routed "
        f"rows (C={cap}, E={e}): occupied experts {int(occ.min())}.."
        f"{int(occ.max())} (mean {occ.float().mean():.1f}), filled rows "
        f"{int(filled.min())}..{int(filled.max())} (mean "
        f"{filled.float().mean():.1f}); timed: the median, "
        f"{int(occ[mid])} occupied, {int(filled[mid])} filled")
    return rows[mid].contiguous(), cap


def spec_launches(cfg, compress, profile, spec, rounds, prefills):
    """Each kernel's launches over a speculative run, from the layer
    structure: every call launches, in each layer it runs, one attention
    kernel and one a packed projection (four attention projections and
    three of the MLP: a dense model's (two in a GELU MLP), or the fused
    shared experts', then
    one expert-axis launch for each of the three routed projections); the
    target runs in every prefill and verify (all its layers), the draft
    (its leading layers) K times a chain round, or a root call and a
    level call a tree level after the first. Chain calls and a tree's root attend in the plain
    mode (the latent mode on ``mla_moe``), tree levels and the tree
    verify in the tree mode (the latent mode with tree operands)."""
    from repro_torch.core.model_compress import DRAFT_PROFILES, draft_layers
    lt, ld = cfg.n_layers, draft_layers(cfg, profile)
    target = "gqsa_gemv" if compress == "gqsa" else "w4_matmul"
    drafter = ("w4_matmul" if DRAFT_PROFILES[profile]["sparsity"] <= 0
               else "gqsa_gemv")
    tree = "spec_fanout" in spec
    level_calls = len(spec["spec_fanout"]) - 1 if tree else 0
    plain_calls = 1 if tree else spec["spec_k"]
    want = {k: 0 for k in read_launches() if not k.endswith("_tc")}
    n_proj = 6 if cfg.moe is None and cfg.mlp_type == "gelu" else 7
    for kind, calls, layers in ((target, prefills + rounds, lt),
                                (drafter, (plain_calls + level_calls)
                                 * rounds, ld)):
        want[kind] += n_proj * layers * calls
        if cfg.moe is not None:
            want[f"{kind}_experts"] += 3 * layers * calls
    tree_attn = (level_calls * ld + lt) * rounds if tree else 0
    if cfg.family == "mla_moe":
        want["paged_attention_latent"] = ((plain_calls + level_calls) * ld
                                          + lt) * rounds
        want["paged_attention_latent_tree"] = tree_attn
    else:
        want["paged_attention"] = plain_calls * ld * rounds \
            + (0 if tree else lt * rounds)
        want["paged_attention_tree"] = tree_attn
    return want


def check_spec_launches(label, cfg, compress, profile, spec, launches,
                        metrics):
    """Logs acceptance and each kernel's launches per round, and requires
    every count to equal :func:`spec_launches`' (from the engine's
    ``spec_rounds`` and ``prefills``) and every expert-axis launch of the
    dense-W4 path to take the tensor cores."""
    rounds, prefills = metrics["spec_rounds"], metrics["prefills"]
    require(rounds > 0, f"{label}: speculative rounds ran")
    want = spec_launches(cfg, compress, profile, spec, rounds, prefills)
    per_round = ", ".join(f"{k} {v / rounds:.1f}" for k, v in
                          launches.items() if v)
    log(f"[spec moe] {label}: acceptance {metrics['acceptance_rate']:.1%}, "
        f"{rounds} rounds, {prefills} prefills, accepted drafts per "
        f"slot-round {metrics['accepted_len_mean']:.2f}; launches per "
        f"round (prefills included): {per_round}")
    got = {k: launches[k] for k in want}
    require(got == want, f"{label}: launches {got} are not the layer "
                         f"structure's {want}")
    require(launches["w4_matmul_experts_tc"]
            == launches["w4_matmul_experts"]
            and (launches["w4_matmul"] == 0 or launches["w4_matmul_tc"] > 0),
            f"{label}: the dense-W4 expert axis took the tensor cores")


def _moe_spec_cfg(arch, n_layers=None, dtype=None, capacity_factor=None):
    import dataclasses
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def phase_spec_moe_engine():
    """(a) Speculation against none in the f32 engine, dropless (8
    requests x 32 tokens, 4 slots, GQSA target): deepseek-moe-16b at full
    width and all 28 layers, chain K=4 (draft w4s50) and tree (4, 2, 2)
    (draft w4l25); DeepSeek-V2 at full width and 4 layers, tree (4, 2, 2)
    (draft w4l25). Greedy tokens equal, where they differ only at a top-2
    margin under SPEC_MARGIN_REL, as phase 11 judges llama2-7b."""
    from repro_torch.core.gqs_layer import GQSAConfig
    from repro_torch.core.model_compress import draft_layers
    from repro_torch.models import transformer as tf
    runs = [("deepseek_moe_16b", None, "chain K=4, draft w4s50", "w4s50",
             dict(spec_k=4)),
            ("deepseek_moe_16b", None, "tree (4,2,2), draft w4l25", "w4l25",
             dict(spec_fanout=(4, 2, 2))),
            ("deepseek_v2_236b", DS_SPEC_F32_LAYERS,
             "tree (4,2,2), draft w4l25", "w4l25",
             dict(spec_fanout=(4, 2, 2)))]
    plain = {}
    for r, (arch, layers, label, profile, spec) in enumerate(runs):
        cfg = _moe_spec_cfg(arch, layers, "float32", MOE_DROPLESS[arch])
        tag = f"{arch} {cfg.n_layers} layers, capacity factor " \
              f"{cfg.moe.capacity_factor:g}"
        if arch not in plain:
            # one draw of the weights packs the target and every draft
            # profile this model's runs take
            profiles = [run[3] for run in runs[r:] if run[0] == arch]
            t0 = time.time()
            params, drafts = tf.init_params_and_drafts(
                SEED, cfg, profiles, "cuda", compress=GQSAConfig())
            torch.cuda.synchronize()
            log(f"[spec moe f32] {tag}: target and drafts {profiles} "
                f"packed on the card in {time.time() - t0:.1f}s")
            prompts, plain[arch], _, _, wall = _engine_run(cfg, params)
            log(f"[spec moe f32] {tag}: no speculation: wall {wall:.1f}s")
        _, got, eng, launches, wall = _engine_run(
            cfg, params, drafts[profile],
            spec_draft_layers=draft_layers(cfg, profile), **spec)
        m = eng.metrics.summary()
        mism = 0
        for i, (a, b) in enumerate(zip(got, plain[arch])):
            diff = np.flatnonzero(a != b)
            if len(diff) == 0:
                continue
            mism += 1
            at = int(diff[0])
            margin, scale = greedy_margin(params, cfg, prompts[i], b, at)
            log(f"[spec moe f32] {tag}, {label}: request {i} first differs "
                f"at token {at}: plain top-2 margin {margin:.4e} (max "
                f"|logit| {scale:.3f}, rel {margin / scale:.2e})")
            require(margin <= SPEC_MARGIN_REL * scale,
                    f"{label}: tokens differ at a clear top-2 margin "
                    f"(rel {margin / scale:.2e} > {SPEC_MARGIN_REL})")
        log(f"[spec moe f32] {tag}, {label}: {mism} of 8 requests differ "
            f"from no speculation (margin bound {SPEC_MARGIN_REL:.0e} x "
            f"max |logit|); wall {wall:.1f}s")
        check_spec_launches(f"f32 {arch} {label}", cfg, "gqsa", profile,
                            spec, launches, m)
        del eng
        if r + 1 == len(runs) or runs[r + 1][0] != arch:
            del params, drafts
        torch.cuda.empty_cache()


MOE_SPEC_SERVE = {
    "deepseek-moe gqsa chain serve": ("gqsa", "w4s75", dict(spec_k=4)),
    "deepseek-moe gqsa tree serve": ("gqsa", "w4l25",
                                     dict(spec_fanout=(4, 2, 2))),
    "deepseek-moe w4 tree serve": ("w4", "w4l25",
                                   dict(spec_fanout=(4, 2, 2))),
}


def phase_serve_spec_moe(label):
    """(b) A speculative main path of deepseek-moe-16b: the serve CLI at
    full width and all 28 layers, bf16, the configs' capacity factor
    (1.25), 4 slots, 8 requests x 32 new tokens."""
    from repro_torch.launch import serve
    compress, profile, spec = MOE_SPEC_SERVE[label]
    flags = (["--spec", str(spec["spec_k"])] if "spec_k" in spec else
             ["--spec-tree", ",".join(map(str, spec["spec_fanout"]))])
    argv = ["--arch", "deepseek_moe_16b", "--full", "--compress", compress,
            "--slots", "4", "--requests", "8", "--max-new", "32",
            "--max-seq", "256", "--seed", str(SEED), "--draft-profile",
            profile] + flags
    buf = io.StringIO()
    reset_launches()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        res = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    for line in buf.getvalue().splitlines():
        log(f"[{label}] {line}")
    log(f"[{label}] {' '.join(argv[5:])}: wall {wall:.1f}s (init + pack + "
        f"serve)")
    require(len(res["results"]) == 8, "all 8 requests answered")
    require(all(len(r["tokens"]) == 32 for r in res["results"]),
            "every request got 32 tokens")
    check_spec_launches(label, _moe_spec_cfg("deepseek_moe_16b"), compress,
                        profile, spec, launches, res)
    return launches


DS_SPEC = dict(spec_fanout=(4, 2, 2))   # DeepSeek-V2's served speculation


def engine_spec_deepseek():
    """(b) DeepSeek-V2's speculative main path: full width, 8 of 60
    layers, GQSA target, tree (4, 2, 2) with draft w4l25, bf16, the
    configs' capacity factor; the engine serves 8 requests x 32 new
    tokens on 4 slots."""
    from repro_torch.core.gqs_layer import GQSAConfig
    from repro_torch.core.model_compress import draft_layers
    from repro_torch.models import transformer as tf
    cfg = _moe_spec_cfg("deepseek_v2_236b", DS_LAYERS)
    spec = DS_SPEC
    t0 = time.time()
    params, draft = tf.init_params_and_draft(SEED, cfg, "w4l25", "cuda",
                                             compress=GQSAConfig())
    torch.cuda.synchronize()
    log(f"[deepseek spec engine] {DS_LAYERS} of 60 layers, GQSA target and "
        f"draft w4l25 packed on the card in {time.time() - t0:.1f}s")
    _, got, eng, launches, wall = _engine_run(
        cfg, params, draft, spec_draft_layers=draft_layers(cfg, "w4l25"),
        **spec)
    log(f"[deepseek spec engine] {eng.metrics.format_summary()}; wall "
        f"{wall:.1f}s")
    require(all(0 <= int(t) < cfg.vocab for r in got for t in r),
            "tokens in the vocabulary")
    check_spec_launches("deepseek gqsa tree engine", cfg, "gqsa", "w4l25",
                        spec, launches, eng.metrics.summary())
    del params, draft, eng
    return launches


def profile_verify_moe():
    """A profiled (4, 2, 2) tree verify step of deepseek-moe-16b at full
    width and depth, bf16, GQSA, 4 slots, after a batched prefill (the
    draft tokens are random: the verify's work does not depend on
    them)."""
    from repro_torch.core.gqs_layer import GQSAConfig
    from repro_torch.engine.sampling import SamplingParams
    from repro_torch.engine.spec import tree_step_fns
    from repro_torch.models import transformer as tf
    cfg = _moe_spec_cfg("deepseek_moe_16b")
    params = tf.split_layers(tf.init_params(SEED, cfg, "cuda",
                                            compress=GQSAConfig()), cfg)
    _, verify_fn, tpl = tree_step_fns(cfg, SamplingParams(), (4, 2, 2))
    ps, mp = 16, 4
    lens = torch.tensor([7, 12, 4, 15], dtype=torch.int32, device="cuda")
    toks = torch.randint(0, cfg.vocab, (4, 16), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(SEED))
    bt = torch.arange(4 * mp, dtype=torch.int32, device="cuda").reshape(
        4, mp)
    cache = tf.init_paged_cache(cfg, 4 * mp, ps, device="cuda")
    logits, _ = tf.prefill(params, cache, toks, lens, bt, cfg)
    first = logits[:, -1].argmax(-1).int()
    tree = torch.randint(0, cfg.vocab, (4, tpl.n_nodes), device="cuda",
                         dtype=torch.int32)
    ones = torch.ones(4, dtype=torch.int32, device="cuda")

    def step():
        verify_fn(params, cache, first, tree, lens, bt, ones, ones * 32,
                  None, 3)
    profile_steps(step, 8, "deepseek-moe gqsa bf16 tree (4,2,2) verify "
                           "step at 4 slots (T=29), 28 layers")
    del params, cache


def latent_tree_time(timer, g):
    """The latent mode on a (4, 2, 2) verify block (T=29) at DeepSeek-V2
    width, 4 slots, bf16 pages, window bases ~64 and ~256: kernel, plain,
    SDPA with the ancestor mask on the latent rows gathered beforehand
    (the 29 x 128 query rows of the one KV head), and the bound: the
    larger of the bytes (each live latent row once in bf16, q and the
    output once in f32) over 3.35 TB/s and the multiply-adds (a score and
    a value product, D + v_rank, for every position a query row sees)
    over the bf16 tensor cores' 989 TFLOP/s, with the bound at the f32
    rate (67 TFLOP/s) beside it. At each base the kernel's output must
    agree with the plain version's."""
    import torch.nn.functional as F
    from repro_torch.engine.spec import TreeTemplate
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.layers import ancestor_mask
    b = 4
    spec = TreeTemplate((4, 2, 2)).verify_tree("cuda")
    t, win = spec["anc"].shape[0], spec["window"]
    anc = spec["anc"][None].expand(b, t).contiguous()
    seen_anc = sum(bin(int(a)).count("1") for a in spec["anc"].tolist())
    out = {}
    for label, bases in (("~64", [35, 40, 31, 38]),
                         ("~256", [227, 220, 225, 210])):
        base = torch.tensor(bases, dtype=torch.int32)
        lens = (base + win)[:, None].expand(b, t).contiguous()
        q, lat, lq, bt = _latent_case(b, t, lens, torch.bfloat16, g)
        base = base.to("cuda")
        rows = sum(bases) + b * win
        nbytes = rows * DS_D * 2 + b * t * DS_H * (DS_D + DS_R) * 4
        flops = 2 * DS_H * (t * sum(bases) + b * seen_anc) * (DS_D + DS_R)
        bound, by, bound_f32 = _attn_bound(nbytes, flops)
        o = ops.paged_latent_attention(q, lat, lq, bt, v_rank=DS_R, anc=anc,
                                       anc_base=base, anc_window=win)
        ref = ops.paged_latent_attention(q, lat, lq, bt, v_rank=DS_R,
                                         anc=anc, anc_base=base,
                                         anc_window=win, plain=True)
        err = (o - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        require(rel <= TOL, f"paged_attention (latent, (4,2,2) verify, "
                            f"bases {label}) disagrees: rel {rel}")
        lq2, live = ops.paged_query_prep(lq, bt, b, t, lat.shape[1])
        qh = q.reshape(b, 1, t * DS_H, DS_D).contiguous()
        lat4 = lat[:, :, None, :]
        t_k = timer.ms(lambda: paged_attention_cuda(
            qh, lat4, None, lq2, bt, live, t, anc=anc, anc_base=base,
            window=win, v_rank=DS_R))
        t_p = timer.ms(lambda: ops.paged_latent_attention(
            q, lat, lq, bt, v_rank=DS_R, anc=anc, anc_base=base,
            anc_window=win, plain=True), iters=3)
        smax = int(lens.max())
        kk = lat[bt.clamp(max=lat.shape[0] - 1).long()].reshape(
            b, -1, DS_D)[:, None, :smax].contiguous()
        vv = kk[..., :DS_R].contiguous()
        mask = ancestor_mask(lq, anc, base, win, b, t, smax)[:, None] \
            .repeat_interleave(DS_H, dim=2)
        qs = qh.to(torch.bfloat16)
        t_l = timer.ms(lambda: F.scaled_dot_product_attention(
            qs, kk, vv, attn_mask=mask))
        log(f"[latent time] verify (4,2,2) T={t} bases {label} ({bases}) "
            f"B=4 H=128 D=576 v_rank=512 bf16 pages "
            f"({split_note(b, 1, t * DS_H, bt.shape[1], DS_R)}): kernel "
            f"{t_k * 1e3:.1f}us plain {t_p * 1e3:.1f}us sdpa(mask) "
            f"{t_l * 1e3:.1f}us bound {bound * 1e3:.2f}us by {by} at the "
            f"tensor cores' rate (f32 rate {bound_f32 * 1e3:.2f}us; "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP) -> "
            f"{bound / t_k:.0%} of bound; kernel vs plain max_abs_err "
            f"{err:.3e} rel {rel:.3e}")
        out[label] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                          bound_ms=bound, bound_by=by,
                          bound_f32_ms=bound_f32, max_abs_err=err)
    return out


# (model, experts, expert shapes, the main paths of (b) whose recorded
# verify routing the GQSA and the W4 expert axis are timed on): a chain
# K=4 of 4 slots (20 routed rows) and a (4, 2, 2) tree (116); the W4
# axis takes the W4 target's own routing where (b) serves one
VERIFY_DISPATCHES = (
    ("deepseek-moe-16b", MOE_EXPERTS, MOE_EXPERT_SHAPES,
     "deepseek-moe gqsa chain serve", "deepseek-moe gqsa chain serve"),
    ("deepseek-moe-16b", MOE_EXPERTS, MOE_EXPERT_SHAPES,
     "deepseek-moe gqsa tree serve", "deepseek-moe w4 tree serve"),
    ("deepseek-v2", 160, DS_EXPERT_SHAPES, "deepseek spec engine",
     "deepseek spec engine"))


def phase_spec_moe_timing(timer, dispatches):
    """(c) The kernels at the shapes speculation on the MoE families
    sends: the tree mode at deepseek-moe-16b's width (KH=16), the latent
    mode on a (4, 2, 2) block, and both expert axes at verify capacities
    (a layer's three projections with the buffer rows of one verify
    dispatch recorded on a main path of (b), :func:`verify_dispatch`),
    each beside its plain version."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    out = {"tree_kh16": phase_tree_timing(timer, kh=16),
           "latent_verify_422": latent_tree_time(timer, g),
           "experts_verify": [], "w4_experts_verify": []}
    for name, e, shapes, *sources in VERIFY_DISPATCHES:
        for key, layer, source in (
                ("experts_verify", experts_layer, sources[0]),
                ("w4_experts_verify", w4_experts_layer, sources[1])):
            spec = (MOE_SPEC_SERVE[source][2] if source in MOE_SPEC_SERVE
                    else DS_SPEC)
            row = layer(timer, g, name, e, shapes, verify_rows(spec),
                        dispatch=dispatches[source])
            row["routing"] = source
            out[key].append(row)
    return out


def phase_spec_moe(timer):
    """Phase 19: (a), (b) and (c); the routing of the served paths'
    verify calls is recorded for (c). Returns ({main path: launches},
    timings)."""
    t0 = time.time()
    phase_spec_moe_engine()
    launches, dispatches = {}, {}
    moe_cfg = _moe_spec_cfg("deepseek_moe_16b")
    for label, (_, _, spec) in MOE_SPEC_SERVE.items():
        torch.cuda.empty_cache()
        with recording_routes(verify_rows(spec)) as kept:
            launches[label] = phase_serve_spec_moe(label)
        dispatches[label] = verify_dispatch(kept, moe_cfg, label)
        del kept
    torch.cuda.empty_cache()
    label = "deepseek spec engine"
    with recording_routes(verify_rows(DS_SPEC)) as kept:
        launches[label] = engine_spec_deepseek()
    dispatches[label] = verify_dispatch(
        kept, _moe_spec_cfg("deepseek_v2_236b"), label)
    del kept
    torch.cuda.empty_cache()
    profile_verify_moe()
    torch.cuda.empty_cache()
    times = phase_spec_moe_timing(timer, dispatches)
    log(f"[time] speculation on the MoE families (phase 19) "
        f"{time.time() - t0:.1f}s")
    return launches, times


# ---------------------------------------------------------------------------
# phase 20: gqsa_gemv at group sizes 8, 32, 64 and 128
# ---------------------------------------------------------------------------

GROUP_SIZES_NEW = (8, 32, 64, 128)    # the kernels' group sizes beside 16
GROUP_EXPERT_CAPS = (1, 5, 13, 30)    # C of (b)
GROUP_SPEC_SERVE = tuple(             # (e)'s speculative serves
    (f"chain serve g{gs}",
     ["--spec", "4", "--draft-profile", "w4s75", "--group-size", str(gs)],
     ("gqsa", "w4s75", dict(spec_k=4)))
    for gs in (32, 128))
GROUP_W4_SERVE = 128                  # (e)'s dense W4 baseline: G128


def phase_group_model(gs):
    """(d) llama2-7b at full width and depth, GQSA W4 S50 at group size
    ``gs`` packed on the card layer by layer: one batched prefill + 4
    decode steps through the kernels and through the plain versions, f32
    and bf16, the f32 greedy tokens equal (:func:`check_model`). Returns
    the GB of its packed linears."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf
    full = get_config("llama2_7b")
    t0 = time.time()
    params = tf.init_params(SEED, full, "cuda", compress=_gqsa(gs))
    torch.cuda.synchronize()
    gb = _packed_bytes(params['layers']) / 1e9
    log(f"[model] llama2-7b full width and depth, GQSA W4 S50 G{gs} packed "
        f"on the card in {time.time() - t0:.1f}s: {gb:.3f} GB of packed "
        f"linears")
    check_model(params, full, f"gqsa g{gs}", tokens_equal=True)
    del params
    return gb


def moe_packed_gb(gs):
    """GB of deepseek-moe-16b's packed linears at full width and depth
    under GQSA W4 S50 at group size ``gs``, packed on the card as its
    serve packs them."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf
    params = tf.init_params(SEED, get_config("deepseek_moe_16b"), "cuda",
                            compress=_gqsa(gs))
    gb = _packed_bytes(params["layers"]) / 1e9
    log(f"[model] deepseek-moe-16b full width and depth, GQSA W4 S50 G{gs}: "
        f"{gb:.3f} GB of packed linears")
    del params
    return gb


def kv_a_check(gs):
    """DeepSeek-V2's kv_a projection (N = 576, K = 5120) at group size
    ``gs`` against its plain version (:func:`_gemv_case`), T = 1, 4, 9
    and 116, bf16 and f32 x. Returns the worst max-abs error."""
    n, k = DS_KV_A
    bsr = _packed(n, k, SEED + 17, gs)
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    worst = 0.0
    for b in (1, 4, 9, 116):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((b, k), generator=g, device="cuda").to(dt)
            worst = max(worst, _gemv_case(x, bsr, f"deepseek-v2 kv_a N={n} "
                                                  f"K={k}"))
    return worst


def phase_group_sizes(timer):
    """Phase 20, at each group size of GROUP_SIZES_NEW: (a) gqsa_gemv
    against its plain version as phase 3 holds it (at g = 128 also
    DeepSeek-V2's kv_a, :func:`kv_a_check`); (b) its expert axis as phase
    13 holds it, C in GROUP_EXPERT_CAPS; (c) a llama2-7b layer at T = 4,
    64 and 116 and a deepseek-moe-16b expert layer at C = 1 timed beside
    the plain version, the library call and the bound (at g = 128 also
    kv_a at T = 4); (d) :func:`phase_group_model` and deepseek-moe-16b's
    packed GB (:func:`moe_packed_gb`); (e) the serve CLI with
    ``--group-size``: llama2-7b and deepseek-moe-16b at full width and
    depth, at g = 32 and 128 the chain K=4 speculative serve (draft w4s75
    at the same g) with its launches held to :func:`spec_launches`, and
    llama2-7b under ``--compress w4 --group-size 128`` (the dense W4 G128
    baseline). Returns ({g: errors and times}, {main path: launches})."""
    t0 = time.time()
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    out, launches = {}, {}
    for gs in GROUP_SIZES_NEW:
        t_g = time.time()
        row = dict(gemv_err=phase_gemv_check(gs),
                   experts_err=phase_experts_check(gs, GROUP_EXPERT_CAPS))
        if gs == 128:
            row["gemv_err"] = max(row["gemv_err"], kv_a_check(gs))
            row["kv_a"] = kv_a_time(timer, g, gs=gs)
        row["gemv"] = gemv_layer(timer, g, 4, gs)
        row["gemv"]["rows"] = {str(t): gemv_layer(timer, g, t, gs)
                               for t in (64, 116)}
        row["experts"] = experts_layer(timer, g, "deepseek-moe-16b",
                                       MOE_EXPERTS, MOE_EXPERT_SHAPES, 4,
                                       gs=gs)
        torch.cuda.empty_cache()
        row["packed_gb"] = {"llama2_7b": phase_group_model(gs)}
        torch.cuda.empty_cache()
        row["packed_gb"]["deepseek_moe_16b"] = moe_packed_gb(gs)
        for arch in ("llama2_7b", "deepseek_moe_16b"):
            torch.cuda.empty_cache()
            tag = "gqsa" if arch == "llama2_7b" else "deepseek-moe gqsa"
            launches[f"{tag} serve g{gs}"] = phase_serve("gqsa", arch, gs)
        out[gs] = row
        log(f"[time] group size {gs} (phase 20) {time.time() - t_g:.1f}s")
    for label, flags, counted in GROUP_SPEC_SERVE:
        torch.cuda.empty_cache()
        launches[label] = phase_serve_spec(label, flags, counted)
    torch.cuda.empty_cache()
    launches[f"w4 serve g{GROUP_W4_SERVE}"] = phase_serve(
        "w4", "llama2_7b", GROUP_W4_SERVE)
    log(f"[time] group sizes {GROUP_SIZES_NEW} (phase 20) "
        f"{time.time() - t0:.1f}s")
    return out, launches


def group_size_rows(groups, launches, kind):
    """The kernels line's ``group_sizes`` map of ``kind`` ("gemv": the
    single matrix on the llama2-7b serve; "experts": the expert axis on
    the deepseek-moe-16b serve): g -> error, times, bound and launches on
    its served path."""
    name = "gqsa_gemv" if kind == "gemv" else "gqsa_gemv_experts"
    tag = "gqsa" if kind == "gemv" else "deepseek-moe gqsa"
    rows = {}
    for gs, row in groups.items():
        t = row[kind]
        path = f"{tag} serve g{gs}"
        rows[str(gs)] = dict(
            max_abs_err=row[f"{kind}_err"], ms=t["ms"],
            plain_ms=t["plain_ms"], library_ms=t["library_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            launches=launches[path][name], path=path,
            packed_gb=row["packed_gb"]["llama2_7b" if kind == "gemv"
                                       else "deepseek_moe_16b"])
        if "rows" in t:
            rows[str(gs)]["rows"] = t["rows"]
        if kind == "gemv" and "kv_a" in row:
            rows[str(gs)]["deepseek_v2_kv_a"] = row["kv_a"]
    return rows


# ---------------------------------------------------------------------------
# phase 21: the reference's four other dense configs
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("yi_34b", "starcoder2_3b", "qwen3_14b", "mistral_nemo_12b")
DENSE_CHECK_LAYERS = 4              # (b)'s depth
DENSE_GEMV_ROWS = (1, 4, 64, 116)   # (a)'s x rows of gqsa_gemv
DENSE_W4_ROWS = (1, 4, 64)          # (a)'s x rows of w4_matmul
KV_DECODE_ROWS = (4, 5, 7, 12, 16)  # (a)'s query rows a KV head
DENSE_SPEC = ("starcoder2-3b tree serve",
              ["--spec-tree", "4,2,2", "--draft-profile", "w4l25"],
              ("gqsa", "w4l25", dict(spec_fanout=(4, 2, 2))))


def dense_ratio(arch):
    """(KV heads, query heads a KV head) of ``arch`` at full width."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    return cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads


def dense_layer_shapes(arch):
    """(shapes, per_layer) of one full-width layer's packed projections,
    projections of one (N, K) under one label (yi-34b's wq and wo are
    both 7168 x 7168; a GELU MLP has no wg)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    d, hd, h, kh = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    mlp = [("wg", cfg.d_ff, d)] if cfg.mlp_type == "swiglu" else []
    names = [("wq", h * hd, d), ("wk", kh * hd, d), ("wv", kh * hd, d),
             ("wo", d, h * hd)] + mlp + [("wu", cfg.d_ff, d),
                                         ("wd", d, cfg.d_ff)]
    by = {}
    for name, n, k in names:
        by.setdefault((n, k), []).append(name)
    shapes = {"/".join(v): nk for nk, v in by.items()}
    return shapes, {label: len(label.split("/")) for label in shapes}


def phase_dense_kernels():
    """(a) Every kernel of the dense configs' paths against its plain
    version at their shapes: paged attention's plain and int8 modes at
    each config's (KV heads, R) with D=128, T in {1, 4}; the tree mode on
    a (4, 2, 2) verify block (T=29) at yi-34b's and starcoder2-3b's;
    kv_decode_attention at B=4, R in KV_DECODE_ROWS (KH 8; 2 at R = 12),
    S=4096; gqsa_gemv on one yi-34b and one starcoder2-3b layer, T in
    DENSE_GEMV_ROWS, bf16 and f32 x; w4_matmul on one starcoder2-3b
    layer, T in DENSE_W4_ROWS. Returns the worst max-abs error a kernel."""
    from repro_torch.kernels.gqsa_gemv import plan
    from repro_torch.kernels.build import sm_count
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    worst = {k: 0.0 for k in ("gqsa_gemv", "paged_attention",
                              "paged_attention_int8", "paged_attention_tree",
                              "kv_decode_attention", "w4_matmul")}
    for arch in DENSE_ARCHS:
        kh, r = dense_ratio(arch)
        for dtype in (torch.bfloat16, torch.float32, torch.int8):
            mode = ("paged_attention_int8" if dtype == torch.int8
                    else "paged_attention")
            for t in (1, 4):
                worst[mode] = max(worst[mode], _attn_check(dtype, t, g, kh,
                                                           r))
        if arch in ("yi_34b", "starcoder2_3b"):
            for dtype in (torch.bfloat16, torch.float32, torch.int8):
                worst["paged_attention_tree"] = max(
                    worst["paged_attention_tree"],
                    _tree_check(dtype, (4, 2, 2), 0, None, kh, g, r))
    for r in KV_DECODE_ROWS:
        worst["kv_decode_attention"] = max(
            worst["kv_decode_attention"],
            _kv_decode_check(g, 4096, kh=2 if r == 12 else 8, r=r))
    torch.cuda.empty_cache()
    for arch in ("yi_34b", "starcoder2_3b"):
        shapes, _ = dense_layer_shapes(arch)
        for label, (n, k) in shapes.items():
            bsr = _packed(n, k, SEED)
            for t in DENSE_GEMV_ROWS:
                for dt in (torch.bfloat16, torch.float32):
                    x = torch.randn((t, k), generator=g,
                                    device="cuda").to(dt)
                    tile = plan(t, n, k, 16, x.element_size(),
                                sm_count(0)).tile
                    worst["gqsa_gemv"] = max(worst["gqsa_gemv"], _gemv_case(
                        x, bsr, f"{arch} {label} N={n} K={k} (tile {tile}, "
                                f"bar rel {TOL:.0e})"))
            del bsr
    shapes, _ = dense_layer_shapes("starcoder2_3b")
    for label, (n, k) in shapes.items():
        p = _w4_packed(n, k, SEED)
        for t in DENSE_W4_ROWS:
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((t, k), generator=g, device="cuda").to(dt)
                worst["w4_matmul"] = max(worst["w4_matmul"], _w4_case(
                    x, p, 16, f"starcoder2-3b {label}"))
    torch.cuda.empty_cache()
    log(f"[dense kernels] worst max_abs_err a kernel: {worst}")
    return worst


def phase_dense_timing(timer):
    """(e) Timings at the dense configs' shapes, each beside its plain
    version, its library call and its bound: gqsa_gemv on one yi-34b and
    one starcoder2-3b layer at T = 4 and 64 (against torch.matmul on the
    dense bf16 W); the paged plain mode at yi-34b's (8, 7) and
    starcoder2-3b's (2, 12), serve lengths (against SDPA); and
    kv_decode_attention at starcoder2-3b's (2, 12) and at the kernel's
    limit, (8, 16), over 4 x 4096 and 4 x 32768 (against SDPA on
    dequantized K/V)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    out = {"gqsa_gemv": {}, "paged_attention": {}}
    for arch in ("yi_34b", "starcoder2_3b"):
        shapes, per_layer = dense_layer_shapes(arch)
        out["gqsa_gemv"][arch] = {
            str(t): gemv_layer(timer, g, t, shapes=shapes,
                               per_layer=per_layer) for t in (4, 64)}
        kh, r = dense_ratio(arch)
        out["paged_attention"][arch] = attn_time(
            timer, g, torch.bfloat16, "serve", [20, 25, 31, 29], kh, r)
        torch.cuda.empty_cache()
    out["kv_decode_attention"] = {
        "starcoder2_3b": phase_kv_decode_timing(
            timer, *dense_ratio("starcoder2_3b"))["lengths"],
        "kh8_r16": phase_kv_decode_timing(timer, 8, 16)["lengths"]}
    return out


def dense_model_check(arch):
    """(b) ``arch`` at full width and DENSE_CHECK_LAYERS layers, GQSA W4
    S50 G16: prefill + 4 decode steps through the kernels against the
    plain versions, f32 (greedy tokens equal at every step) and bf16.
    Returns the inputs of :func:`profile_decode`."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_config(arch), n_layers=DENSE_CHECK_LAYERS)
    params = tf.init_params(SEED, cfg, "cuda", compress=_gqsa())
    out = check_model(params, cfg, f"{arch} {DENSE_CHECK_LAYERS} layers",
                      tokens_equal=True)
    del params
    torch.cuda.empty_cache()
    return out


def dense_full_model(arch, inputs, int8_engine=False):
    """``arch`` at full width and depth, GQSA W4 S50 G16 packed on the
    card: a profiled bf16 decode step at 4 slots; with ``int8_engine``
    the int8-pool main path (the engine serves 8 requests x 32 new
    tokens). Returns that path's launches, or None."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf
    full = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = tf.init_params(SEED, full, "cuda", compress=_gqsa())
    torch.cuda.synchronize()
    log(f"[model] {arch} full width and depth ({full.n_layers} layers), "
        f"GQSA W4 S50 G16 packed on the card in {time.time() - t0:.1f}s: "
        f"{_packed_bytes(params['layers']) / 1e9:.3f} GB of packed linears; "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    profile_decode(params, full, *inputs,
                   label=f"{arch} bf16 decode step at 4 slots")
    launches = engine_int8(params, full) if int8_engine else None
    del params
    torch.cuda.empty_cache()
    return launches


def phase_dense_configs(timer):
    """Phase 21, the reference's four other dense configs (yi-34b,
    starcoder2-3b, qwen3-14b, mistral-nemo-12b), bf16 unless marked, seed
    0, 4 slots, 8 requests of 4-15 prompt and 32 new tokens, max_seq 256,
    greedy: (a) :func:`phase_dense_kernels`; (b) :func:`dense_model_check`
    for each; (c) the main paths at full width and depth: the serve CLI
    under GQSA W4 S50 G16 for each, ``--compress w4`` on starcoder2-3b,
    the int8 pool through the engine on qwen3-14b, the tree speculation
    serve ``--spec-tree 4,2,2 --draft-profile w4l25`` on starcoder2-3b
    (launches held to :func:`spec_launches`) and, in f32 at 4 layers, its
    tokens against the same engine's without speculation; profiled
    decode steps of yi-34b and starcoder2-3b; (d) starcoder2-3b's static
    int8 contiguous path (:func:`phase_static`: 4 x 32768 positions, R =
    12); (e) :func:`phase_dense_timing`. Every kernel must launch on each
    config's path that runs it. Returns (errors, times, {path: launches},
    {kernel: {arch: launches}})."""
    t0 = time.time()
    errs = phase_dense_kernels()
    times = phase_dense_timing(timer)
    torch.cuda.empty_cache()
    launches = {}
    for arch in DENSE_ARCHS:
        inputs = dense_model_check(arch)
        if arch in ("yi_34b", "starcoder2_3b"):
            dense_full_model(arch, inputs)
        elif arch == "qwen3_14b":
            launches[f"{arch} int8-kv engine"] = dense_full_model(
                arch, inputs, int8_engine=True)
        launches[f"{arch} gqsa serve"] = phase_serve("gqsa", arch)
        torch.cuda.empty_cache()
    launches["starcoder2_3b w4 serve"] = phase_serve("w4", "starcoder2_3b")
    torch.cuda.empty_cache()
    label, flags, counted = DENSE_SPEC
    phase_spec_engine("starcoder2_3b", DENSE_CHECK_LAYERS, [
        (f"starcoder2-3b {DENSE_CHECK_LAYERS} layers: tree (4,2,2), draft "
         f"w4l25", counted[1], counted[2])])
    torch.cuda.empty_cache()
    launches[label] = phase_serve_spec(label, flags, counted,
                                       arch="starcoder2_3b")
    torch.cuda.empty_cache()
    launches["starcoder2_3b static int8 serve"] = phase_static(
        "starcoder2_3b")
    torch.cuda.empty_cache()
    by_kernel = {
        "gqsa_gemv": {a: launches[f"{a} gqsa serve"]["gqsa_gemv"]
                      for a in DENSE_ARCHS},
        "paged_attention": {a: launches[f"{a} gqsa serve"]["paged_attention"]
                            for a in DENSE_ARCHS},
        "w4_matmul": {"starcoder2_3b": launches["starcoder2_3b w4 serve"][
            "w4_matmul"]},
        "paged_attention_int8": {"qwen3_14b": launches[
            "qwen3_14b int8-kv engine"]["paged_attention_int8"]},
        "paged_attention_tree": {"starcoder2_3b": launches[label][
            "paged_attention_tree"]},
        "kv_decode_attention": {"starcoder2_3b": launches[
            "starcoder2_3b static int8 serve"]["kv_decode_attention"]}}
    log(f"[dense configs] launches by kernel and config: {by_kernel}")
    require(all(n > 0 for per in by_kernel.values() for n in per.values()),
            "every kernel launched on each dense config's path that runs "
            "it")
    log(f"[time] the four dense configs (phase 21) {time.time() - t0:.1f}s")
    return errs, times, launches, by_kernel


# ---------------------------------------------------------------------------
# phase 22: the shared-prefix KV cache and its ragged tail prefill
# ---------------------------------------------------------------------------

PREFIX_TAIL_SLOTS = ((1024, 17), (1040, 64), (1008, 33), (0, 0))
PREFIX_T = 64                 # the tail's query rows a slot (t_pad)
PREFIX_LEN = 1024             # the shared prefix of (b)-(c): 64 pages
PREFIX_MAX_SEQ = 2048
PREFIX_CHECK_LAYERS = 4       # (c)'s depth
# (c)'s pool under eviction: one request of up to 69 pages resident at a
# time, so a hit's own pages (5 past the 64 of the prefix) come from
# dropping the cached tail blocks of earlier requests
PREFIX_EVICT_PAGES = 70


def _tail_feed(dtype, g, kh=32, d=128, ps=16):
    """The tail dispatch's attention operands at full width (a shuffled
    pool): slot i's ``PREFIX_T`` rows on the staircase base + t + 1 over
    its cached prefix and tail pages, rows at t >= feed padding; the last
    slot is fed nothing (all-sentinel table, as a slot outside the
    admission group). Returns (q, k_pages, v_pages, lengths, table,
    scales, feed)."""
    b, t = len(PREFIX_TAIL_SLOTS), PREFIX_T
    mp = max(-(-(base + t + 32) // ps) for base, _ in PREFIX_TAIL_SLOTS)
    lens = torch.tensor([[base + i + 1 for i in range(t)]
                         for base, _ in PREFIX_TAIL_SLOTS],
                        dtype=torch.int32)
    q, kp, vp, lq, bt, ks, vs = _attn_case(b, t, lens, dtype, g, kh=kh,
                                           d=d, ps=ps, mp=mp)
    bt[-1] = kp.shape[0]
    feed = torch.tensor([f for _, f in PREFIX_TAIL_SLOTS], device="cuda")
    return q, kp, vp, lq, bt, ks, vs, feed


def _feed_check(o, ref, feed, label, tag):
    """A ragged feed's attention output ``o`` [B, T, ...] against the plain
    version's: every row finite (padding included: its sentinel pages
    clamp to the pool's last page), within the bar. Returns the max-abs
    error."""
    torch.cuda.synchronize()
    require(bool(torch.isfinite(o).all()),
            f"{label}: every row finite, padding included")
    real = (torch.arange(o.shape[1], device="cuda")[None, :]
            < feed[:, None])
    scale = ref.abs().max().item()
    err = (o - ref).abs().max().item()
    err_real = (o - ref)[real].abs().max().item()
    log(f"[{tag}] {label}: max_abs_err {err:.3e} (fed rows {err_real:.3e}) "
        f"rel {err / scale:.3e} (bar rel {TOL:.0e})")
    require(err <= TOL * scale, f"{label} disagrees: rel {err / scale}")
    return err


def _ragged_modes_check(make_feed, what, shape, tag):
    """The plain (bf16, f32 pages) and int8 modes on a ragged feed
    (``make_feed(dtype)`` -> (q, k_pages, v_pages, lengths, table,
    k_scales, v_scales, feed)) against their plain versions: one launch
    a call, :func:`_feed_check`, repeats bit-identical. Returns {mode:
    worst max-abs error}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    worst = {"plain": 0.0, "int8": 0.0}
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        mode = "int8" if dtype == torch.int8 else "plain"
        q, kp, vp, lq, bt, ks, vs, feed = make_feed(dtype)
        counter = "int8_launches" if mode == "int8" else "launches"
        before = getattr(paged_attention_cuda, counter)
        o = ops.paged_decode_attention(q, kp, vp, lq, bt, ks, vs)
        require(getattr(paged_attention_cuda, counter) == before + 1,
                f"{what} ({mode}): one launch")
        ref = ops.paged_decode_attention(q, kp, vp, lq, bt, ks, vs,
                                         plain=True)
        err = _feed_check(
            o, ref, feed, f"{what} ({mode}) pages={str(dtype)[6:]} B=4 "
            f"{shape} ({split_note(4, 32, q.shape[1], bt.shape[1], 128)})",
            tag)
        require(torch.equal(o, ops.paged_decode_attention(q, kp, vp, lq, bt,
                                                          ks, vs)),
                f"{what} ({mode}): repeat not bit-identical")
        worst[mode] = max(worst[mode], err)
    return worst


def phase_prefix_kernels(timer):
    """(a) The plain (bf16, f32 pages) and int8 modes on the tail feed
    against their plain versions: every row finite (padding included:
    its sentinel pages clamp to the pool's last page), the fed rows and
    the padding within the bar, one launch a call, repeats
    bit-identical; then the plain mode at this shape timed beside its
    plain version, SDPA under the same staircase mask (K/V gathered
    beforehand) and the bound. Returns ({mode: worst error}, timing)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    worst = _ragged_modes_check(
        lambda dtype: _tail_feed(dtype, g), "tail feed",
        f"T={PREFIX_T} KH=32 D=128 ps=16 (base, feed) "
        f"{list(PREFIX_TAIL_SLOTS)}", "prefix kernels")
    # the plain mode timed at the tail shape (bf16 pages)
    q, kp, vp, lq, bt, _, _, _ = _tail_feed(torch.bfloat16, g)
    q = q.to(torch.bfloat16)
    b, t, h, d = q.shape
    lq2, live = ops.paged_query_prep(lq, bt, b, t, kp.shape[1])
    qh = q.reshape(b, t, h, 1, d).permute(0, 2, 1, 3, 4) \
          .reshape(b, h, t, d).float().contiguous()
    smax = int(lq.max())
    bti = bt.clamp(max=kp.shape[0] - 1).long()
    kk, vv = (p[bti].reshape(b, -1, h, d)[:, :smax].permute(0, 2, 1, 3)
              .contiguous() for p in (kp, vp))
    mask = (torch.arange(smax, device="cuda")[None, None, :]
            < lq[:, :, None])[:, None]                 # [B, 1, T, S]
    qs = q.permute(0, 2, 1, 3).contiguous()
    t_k = timer.ms(lambda: paged_attention_cuda(qh, kp, vp, lq2, bt, live,
                                                t))
    t_p = timer.ms(lambda: ops.paged_decode_attention(q, kp, vp, lq, bt,
                                                      plain=True))
    t_l = timer.ms(lambda: F.scaled_dot_product_attention(qs, kk, vv,
                                                          attn_mask=mask))
    # bytes: each slot's live K/V (its longest row's positions) read once,
    # q read and the output written in f32; operations: two multiply-adds
    # a head dim for every (row, visible position)
    nbytes = sum(int(r.max()) for r in lq) * h * d * 2 * 2 \
        + 2 * b * t * h * d * 4
    flops = 4 * int(lq.long().sum()) * h * d
    bound, by, bound_f32 = _attn_bound(nbytes, flops)
    log(f"[prefix time] tail feed B=4 T={PREFIX_T} KH=32 D=128 bf16 pages, "
        f"lengths up to {smax}: kernel {t_k * 1e3:.1f}us plain "
        f"{t_p * 1e3:.1f}us sdpa (staircase mask) {t_l * 1e3:.1f}us bound "
        f"{bound * 1e3:.2f}us by {by} (f32 rate {bound_f32 * 1e3:.2f}us; "
        f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP) -> "
        f"{bound / t_k:.0%} of bound")
    return worst, dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                       bound_ms=bound, bound_by=by, bound_f32_ms=bound_f32)


def _llama_gqsa(n_layers=None, dtype=None):
    """llama2-7b at full width (``n_layers`` of its 32 and in ``dtype``
    when given), GQSA W4 S50 G16 packed on the card from ``SEED``: (cfg,
    params). Phases 22 and 23 share one of each."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core.gqs_layer import GQSAConfig
    from repro_torch.models import transformer as tf
    cfg = get_config("llama2_7b")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    t0 = time.time()
    params = tf.init_params(SEED, cfg, "cuda", compress=GQSAConfig())
    torch.cuda.synchronize()
    log(f"[llama2-7b] GQSA {cfg.n_layers} layers {cfg.dtype} packed in "
        f"{time.time() - t0:.1f}s")
    return cfg, params


def prefix_requests(vocab, seed=SEED):
    """(b)-(c)'s 8 prompts from ``seed``: seven share a ``PREFIX_LEN``
    prefix and have unique tails of 8-48 tokens; the eighth, submitted
    last, is exactly the prefix (a page-aligned full hit)."""
    rng = np.random.default_rng(seed + 22)
    pre = rng.integers(0, vocab, PREFIX_LEN).astype(np.int32)
    tails = rng.integers(8, 49, 7)
    return [np.concatenate([pre, rng.integers(0, vocab, n).astype(np.int32)])
            for n in tails] + [pre.copy()]


def prefix_expected(prompts, slots=4, ps=16):
    """The prefix counters that FIFO admission of ``prompts`` into
    ``slots`` slots implies, every request of one budget: the first group
    misses (a prefix enters the cache only after its prefill), each
    later one hits the common prefix's full pages, clamped to its length
    - 1 (a page-aligned full hit then copies on write)."""
    common = PREFIX_LEN // ps * ps
    hits = prompts[slots:]
    return dict(misses=min(slots, len(prompts)), hits=len(hits),
                hit_tokens=sum(min(common, len(p) - 1) for p in hits),
                cow=sum(min(common, len(p) - 1) % ps != 0 for p in hits))


def _prefix_engine(cfg, params, prefix, tails=None, **kw):
    """8 prefix requests x 32 new tokens through the engine, 4 slots,
    max_seq 2048; ``tails``, a list, gets the arguments of every tail
    dispatch. Returns (tokens in submission order, engine, launches, wall
    seconds)."""
    from repro_torch.engine import EngineConfig, InferenceEngine
    prompts = prefix_requests(cfg.vocab)
    reset_launches()
    t0 = time.time()
    eng = InferenceEngine(cfg, params, EngineConfig(
        num_slots=4, max_seq=PREFIX_MAX_SEQ, seed=SEED, device="cuda",
        prefix_cache=prefix, **kw))
    if tails is not None:
        inner = eng._tail_fn

        def recorded(*args):
            tails.append(args)
            return inner(*args)
        eng._tail_fn = recorded
    rids = [eng.submit(p, 32) for p in prompts]
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    by = {r["rid"]: r["tokens"] for r in res["results"]}
    require(len(by) == 8 and all(len(by[r]) == 32 for r in rids),
            "8 requests x 32 tokens")
    alc = eng.kv.allocator
    require(alc.num_free + alc.num_outstanding == eng.kv.num_pages,
            "page conservation")
    return [by[r] for r in rids], eng, read_launches(), wall


def _prefix_counters(eng):
    reg = eng.tel.registry
    return {k: int(reg.counter(f"prefix.{c}").value) for k, c in (
        ("hits", "hits"), ("misses", "misses"), ("hit_tokens", "hit_tokens"),
        ("cow", "cow_copies"), ("evicted", "evicted_pages"))}


def phase_prefix_engine(full, params):
    """(b) The main path: llama2-7b (``full``, ``params``) at full width
    and depth, GQSA W4 S50 G16, bf16, the engine with the prefix cache
    on: hits and misses as the admission order implies, every kernel's
    launches equal to the count the batched prefills, tail dispatches,
    decode steps and layers give. Returns (launches, TTFT numbers)."""
    prompts = prefix_requests(full.vocab)
    tails = []
    toks, eng, launches, wall = _prefix_engine(full, params, True, tails)
    m = eng.metrics.summary()
    got, want = _prefix_counters(eng), prefix_expected(prompts)
    log(f"[prefix engine] {eng.metrics.format_summary()}")
    log(f"[prefix engine] prompts {[len(p) for p in prompts]}; counters "
        f"{got} (admission order implies {want}); {m['prefills']} batched "
        f"prefills, {m['prefill_tails']} tail dispatches, "
        f"{m['decode_steps']} decode steps; wall {wall:.1f}s; launches "
        f"{launches}")
    require(all(got[k] == v for k, v in want.items()),
            f"prefix counters {got} are not the admission order's {want}")
    require(got["cow"] >= 1, "the page-aligned full hit copied on write")
    layers = full.n_layers
    calls = m["prefills"] + m["prefill_tails"] + m["decode_steps"]
    expect = {"gqsa_gemv": 7 * layers * calls,
              "paged_attention": layers * (m["prefill_tails"]
                                           + m["decode_steps"])}
    require(all(launches[k] == v for k, v in expect.items()),
            f"launches {launches} are not the layer structure's {expect}")
    require(m["prefill_tails"] >= 1, "a tail dispatch ran")
    require(all(v == 0 for k, v in launches.items()
                if k not in expect and k != "w4_matmul_tc"),
            "no tree-mode, latent-mode, int8-mode, expert-axis or w4_matmul "
            "launch on the prefix path")
    timing = {}
    for kind, group in (("misses", range(4)), ("hits", range(4, 8))):
        rts = [eng.metrics.requests[i] for i in group]
        ttft = [r.ttft_s * 1e3 for r in rts]
        pre = [(r.first_token_t - r.admit_t) * 1e3 for r in rts]
        timing[kind] = dict(ttft_ms=float(np.median(ttft)),
                            admit_to_first_ms=float(np.median(pre)))
        log(f"[prefix engine] TTFT of the {kind}: "
            f"{['%.1f' % x for x in ttft]} ms (median "
            f"{timing[kind]['ttft_ms']:.1f}); admission to first token "
            f"(the {'batched prefill' if kind == 'misses' else 'tail'} "
            f"dispatch) {['%.1f' % x for x in pre]} ms (median "
            f"{timing[kind]['admit_to_first_ms']:.1f})")
    # the hits' tail dispatch again (it rewrites its rows with the same
    # values), profiled: B x t_pad rows through every projection
    args = tails[0]
    log(f"[prefix engine] tail dispatch: {args[2].shape[0]} slots x "
        f"t_pad {args[2].shape[1]} rows, feed {args[4].tolist()}, "
        f"max_live {args[7]} pages")
    profile_steps(lambda: eng._tail_fn(*args), 2,
                  "llama2-7b GQSA bf16 tail dispatch (prefix hits)")
    del eng
    return launches, timing


def _tokens_equal(params, cfg, prompts, got, want, label,
                  tag="prefix f32"):
    """``got`` against ``want`` (the cache-off run, or the unchunked
    one), request by request: equal, or first different only where the
    plain path's top-2 margin is under the near-tie bound. Returns the
    number differing."""
    mism = 0
    for i, (a, b) in enumerate(zip(got, want)):
        diff = np.flatnonzero(a != b)
        if len(diff) == 0:
            continue
        mism += 1
        at = int(diff[0])
        margin, scale = greedy_margin(params, cfg, prompts[i], b, at)
        log(f"[{tag}] {label}: request {i} first differs at token "
            f"{at}: plain top-2 margin {margin:.4e} (rel "
            f"{margin / scale:.2e})")
        require(margin <= SPEC_MARGIN_REL * scale,
                f"{label}: tokens differ at a clear top-2 margin")
    return mism


def phase_prefix_f32(cfg, params):
    """(c) f32 compute at full width and ``PREFIX_CHECK_LAYERS`` layers
    (``cfg``, ``params``): greedy tokens with the cache on against off on
    (b)'s 8 requests, then on a pool of ``PREFIX_EVICT_PAGES`` pages that
    forces evictions. Returns the cache-on tokens (of the first)."""
    prompts = prefix_requests(cfg.vocab)
    off, _, _, w_off = _prefix_engine(cfg, params, False)
    cache_on = None
    for label, kw in (("cache on", {}),
                      ("cache on, evicting",
                       dict(num_pages=PREFIX_EVICT_PAGES))):
        got, eng, launches, wall = _prefix_engine(cfg, params, True, **kw)
        c = _prefix_counters(eng)
        mism = _tokens_equal(params, cfg, prompts, got, off, label)
        log(f"[prefix f32] {label} ({PREFIX_CHECK_LAYERS} layers, "
            f"{eng.kv.num_pages} pages): {8 - mism} of 8 requests' tokens "
            f"equal to the cache off; counters {c}; wall {wall:.1f}s "
            f"(off {w_off:.1f}s)")
        require(c["hits"] > 0, f"{label}: the cache hit")
        if kw:
            require(c["evicted"] > 0, f"{label}: cached pages evicted")
        require(launches["paged_attention"] > 0
                and launches["gqsa_gemv"] > 0, "the kernels launched")
        cache_on = got if cache_on is None else cache_on
        del eng
    return cache_on


def phase_prefix(timer, llama=None, llama_f32=None):
    """Phase 22, the shared-prefix KV cache: (a)
    :func:`phase_prefix_kernels`; (b) :func:`phase_prefix_engine` on
    ``llama`` (cfg, params; packed here when None); (c)
    :func:`phase_prefix_f32` on ``llama_f32``; (d) the serve CLI with
    ``--prefix-cache`` on llama2-7b at full width and depth (its 4-15-token
    prompts fill no page: 8 misses). Returns (errors, timing, {path:
    launches}, TTFT, the cache-on tokens of (c))."""
    t0 = time.time()
    errs, timing = phase_prefix_kernels(timer)
    torch.cuda.empty_cache()
    launches, ttft = {}, {}
    launches["prefix engine"], ttft = phase_prefix_engine(
        *(llama or _llama_gqsa()))
    torch.cuda.empty_cache()
    cache_on = phase_prefix_f32(*(llama_f32 or _llama_gqsa(
        PREFIX_CHECK_LAYERS, "float32")))
    torch.cuda.empty_cache()
    out = []
    launches["prefix serve"] = phase_serve("gqsa", extra=["--prefix-cache"],
                                           out=out)
    line = [x for x in out[0].splitlines() if x.startswith("[prefix]")]
    require(len(line) == 1 and " misses=8 " in line[0],
            f"the serve CLI printed its [prefix] line with misses=8: {line}")
    log(f"[time] the prefix cache (phase 22) {time.time() - t0:.1f}s")
    return errs, timing, launches, ttft, cache_on


# ---------------------------------------------------------------------------
# phase 23: chunked prefill
# ---------------------------------------------------------------------------

# (a)'s chunk feed: (base, fed rows) a slot: a first chunk, one mid-prompt,
# a final partial chunk and a slot fed nothing
CHUNK_SLOTS = ((0, 64), (960, 64), (1024, 17), (0, 0))
CHUNK_T = 64                  # query rows a slot (t_pad)
CHUNK_BUDGET = 64             # (b)'s prefill_chunk_tokens
CHUNK_MAX_SEQ = 2048
CHUNK_SHORT_BUDGETS = (24, 48, 72, 96)   # (b)'s short requests' new tokens
CHUNK_LONG_NEW = 32                      # (b)'s long requests' new tokens
CHUNK_CROSS_PAGES = 100       # (c)'s second budget: chunk ends cross pages
CHUNK_PREFIX_BUDGET = 16      # (c)'s budget on phase 22's prefix requests
CHUNK_DS_LAYERS = 2           # (d)'s depth
CHUNK_DS_PROMPTS = (215, 390, 263, 331, 298, 207)   # (d)'s prompt lengths
CHUNK_SERVE_BUDGET = 3    # (e): under the CLI's shortest prompts (4 tokens)


def _chunk_table(b, mp, num_pages, g, ps=16):
    """Slot i's table row exposed only up to ``base + fed`` (the pages its
    chunk can touch), over a shuffled pool; sentinels past that."""
    perm = torch.randperm(num_pages, generator=g, device="cuda")
    bt = torch.full((b, mp), num_pages, dtype=torch.int32, device="cuda")
    for i, (base, feed) in enumerate(CHUNK_SLOTS):
        occ = -(-(base + feed) // ps)
        bt[i, :occ] = perm[i * mp:i * mp + occ].to(torch.int32)
    lens = torch.tensor([[base + i + 1 for i in range(CHUNK_T)]
                         for base, _ in CHUNK_SLOTS], dtype=torch.int32,
                        device="cuda")
    feed = torch.tensor([f for _, f in CHUNK_SLOTS], device="cuda")
    return bt, lens, feed


def _chunk_feed(dtype, g, kh=32, d=128, ps=16):
    """The chunk dispatch's K/V attention operands at full width: slot i's
    ``CHUNK_T`` rows on the staircase base + t + 1, rows at t >= fed
    padding (their lengths reach past the exposed pages, which the walk
    clamps to the pool's last page). Returns (q, k_pages, v_pages,
    lengths, table, k_scales, v_scales, feed)."""
    b = len(CHUNK_SLOTS)
    mp = max(-(-(base + CHUNK_T) // ps) for base, _ in CHUNK_SLOTS) + 1
    lens0 = torch.ones((b, 1), dtype=torch.int32)
    q, kp, vp, _, _, ks, vs = _attn_case(b, CHUNK_T, lens0, dtype, g, kh=kh,
                                         d=d, ps=ps, mp=mp)
    bt, lens, feed = _chunk_table(b, mp, kp.shape[0], g, ps)
    return q, kp, vp, lens, bt, ks, vs, feed


def _chunk_latent_feed(dtype, g, ps=16):
    """The same chunk feed at DeepSeek-V2's latent widths: (q, latent
    pages, lengths, table, feed)."""
    b = len(CHUNK_SLOTS)
    mp = max(-(-(base + CHUNK_T) // ps) for base, _ in CHUNK_SLOTS) + 1
    num_pages = b * mp
    q = torch.randn((b, CHUNK_T, DS_H, DS_D), generator=g, device="cuda")
    lat = torch.randn((num_pages, ps, DS_D), generator=g,
                      device="cuda").to(dtype)
    bt, lens, feed = _chunk_table(b, mp, num_pages, g, ps)
    return q, lat, lens, bt, feed


def phase_chunk_kernels(timer):
    """(a) The plain (bf16, f32 pages), int8 and latent (bf16 pages)
    modes on the chunk feed against their plain versions: one launch a
    call, every row finite, repeats bit-identical; then the latent mode
    timed there beside its plain version, SDPA under the same staircase
    mask (latent rows gathered beforehand) and the bound. Returns
    ({mode: worst error}, latent timing)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    worst = _ragged_modes_check(
        lambda dtype: _chunk_feed(dtype, g), "chunk feed",
        f"T={CHUNK_T} KH=32 D=128 ps=16 (base, fed) {list(CHUNK_SLOTS)}",
        "chunk kernels")
    q, lat, lq, bt, feed = _chunk_latent_feed(torch.bfloat16, g)
    before = paged_attention_cuda.latent_launches
    o = ops.paged_latent_attention(q, lat, lq, bt, v_rank=DS_R)
    require(paged_attention_cuda.latent_launches == before + 1,
            "chunk feed (latent): one launch")
    ref = ops.paged_latent_attention(q, lat, lq, bt, v_rank=DS_R, plain=True)
    b, t = q.shape[:2]
    worst["latent"] = _feed_check(
        o, ref, feed, f"chunk feed (latent) pages=bfloat16 B=4 T={t} "
        f"H={DS_H} D={DS_D} v_rank={DS_R} (base, fed) {list(CHUNK_SLOTS)} "
        f"({split_note(b, 1, t * DS_H, bt.shape[1], DS_R)})",
        "chunk kernels")
    require(torch.equal(o, ops.paged_latent_attention(q, lat, lq, bt,
                                                      v_rank=DS_R)),
            "chunk feed (latent): repeat not bit-identical")
    # timed: the kernel alone, its plain version, SDPA (the 128 heads of
    # T rows as T x 128 query rows of the one latent head, the staircase
    # as a mask) and the bound
    lq2, live = ops.paged_query_prep(lq, bt, b, t, lat.shape[1])
    qh = q.reshape(b, 1, t * DS_H, DS_D).contiguous()
    lat4 = lat[:, :, None, :]
    t_k = timer.ms(lambda: paged_attention_cuda(qh, lat4, None, lq2, bt,
                                                live, t, v_rank=DS_R))
    t_p = timer.ms(lambda: ops.paged_latent_attention(
        q, lat, lq, bt, v_rank=DS_R, plain=True), iters=5)
    smax = int(lq.max())
    kk = lat[bt.clamp(max=lat.shape[0] - 1).long()].reshape(
        b, -1, DS_D)[:, None, :smax].contiguous()
    vv = kk[..., :DS_R].contiguous()
    rows = lq.repeat_interleave(DS_H, dim=1)               # [B, T*H]
    mask = (torch.arange(smax, device="cuda")[None, None, :]
            < rows[:, :, None])[:, None]                  # [B, 1, T*H, S]
    qs = qh.to(torch.bfloat16)
    t_l = timer.ms(lambda: F.scaled_dot_product_attention(
        qs, kk, vv, attn_mask=mask))
    # bytes: each slot's live latent rows (its longest row's positions)
    # read once, q read and the output written in f32; operations: for
    # every (row, head, visible position) a D-wide score and an R-wide
    # value multiply-add
    nbytes = sum(int(r.max()) for r in lq) * DS_D * 2 \
        + b * t * DS_H * (DS_D + DS_R) * 4
    flops = 2 * DS_H * int(lq.long().sum()) * (DS_D + DS_R)
    bound, by, bound_f32 = _attn_bound(nbytes, flops)
    log(f"[chunk time] latent chunk feed B=4 T={t} H={DS_H} D={DS_D} "
        f"v_rank={DS_R} bf16 pages, lengths up to {smax}: kernel "
        f"{t_k * 1e3:.1f}us plain {t_p * 1e3:.1f}us sdpa (staircase mask) "
        f"{t_l * 1e3:.1f}us bound {bound * 1e3:.2f}us by {by} (f32 rate "
        f"{bound_f32 * 1e3:.2f}us; {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} "
        f"GFLOP) -> {bound / t_k:.0%} of bound")
    return worst, dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bound,
                       bound_by=by, bound_f32_ms=bound_f32,
                       max_abs_err=worst["latent"])


def chunk_requests(vocab, seed=SEED):
    """(b)-(c)'s 8 requests from ``seed``: four short prompts of 8-15
    tokens with budgets ``CHUNK_SHORT_BUDGETS`` (so slots free one at a
    time), then four long prompts of 1024-1536 tokens, none a whole
    number of pages, ``CHUNK_LONG_NEW`` new tokens each (each admitted
    while other slots decode). Returns (prompts, budgets)."""
    rng = np.random.default_rng(seed + 23)
    lens = list(rng.integers(8, 16, 4)) + [
        n + (n % 16 == 0) for n in rng.integers(1024, 1536, 4)]
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lens]
    return prompts, list(CHUNK_SHORT_BUDGETS) + [CHUNK_LONG_NEW] * 4


def _chunk_engine(cfg, params, chunk, prompts, budgets, record=None,
                  max_seq=CHUNK_MAX_SEQ):
    """``prompts`` through the engine, 4 slots, ``prefill_chunk_tokens``
    ``chunk``. ``record``, a list, gets every dispatch in order: decode
    steps, batched prefills and chunk (tail) dispatches, each with a
    timing event recorded after it and what the host knew at its call
    (no host read of the card is added). Returns (tokens in submission
    order, engine, launches, wall seconds)."""
    from repro_torch.engine import EngineConfig, InferenceEngine
    from repro_torch.engine.scheduler import DECODE, PREFILL, PREFILLING
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    reset_launches()
    t0 = time.time()
    eng = InferenceEngine(cfg, params, EngineConfig(
        num_slots=4, max_seq=max_seq, seed=SEED, device="cuda",
        prefill_chunk_tokens=chunk))
    if record is not None:
        def states(state):
            return [s.request for s in eng.scheduler.slots
                    if s.request is not None and s.request.state == state]

        def wrap(attr, kind):
            inner = getattr(eng, attr)

            def recorded(*args):
                entry = dict(kind=kind, decoding=len(states(DECODE)),
                             prefilling=[r.slot for r in states(PREFILLING)],
                             prompts=[r.prompt_len for r in states(PREFILL)],
                             latent=paged_attention_cuda.latent_launches)
                out = inner(*args)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                entry.update(event=ev, latent=paged_attention_cuda
                             .latent_launches - entry["latent"])
                if kind == "chunk":
                    entry.update(feed=args[4], t_pad=args[2].shape[1])
                record.append(entry)
                return out
            setattr(eng, attr, recorded)
        wrap("_decode_fn", "decode")
        wrap("_prefill_fn", "prefill")
        wrap("_tail_fn", "chunk")
    rids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    res = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    by = {r["rid"]: r["tokens"] for r in res["results"]}
    require(len(by) == len(prompts)
            and all(len(by[r]) == n for r, n in zip(rids, budgets)),
            "every request answered with its budget")
    alc = eng.kv.allocator
    require(alc.num_free + alc.num_outstanding == eng.kv.num_pages,
            "page conservation")
    return [by[r] for r in rids], eng, read_launches(), wall


def _admission_stalls(record, long_from):
    """Device time between consecutive decode steps, split by whether a
    long prompt's batched prefill or chunk dispatch ran between them:
    (stalls while admitting, the other gaps), in ms."""
    admitting, other = [], []
    last, between = None, False
    for e in record:
        if e["kind"] == "decode":
            if last is not None:
                gap = last.elapsed_time(e["event"])
                (admitting if between else other).append(gap)
            last, between = e["event"], False
        elif e["kind"] == "chunk" or max(e["prompts"], default=0) \
                >= long_from:
            between = True
    return admitting, other


def phase_chunk_engine(full, params):
    """(b) The main path: llama2-7b at full width and depth, GQSA W4 S50
    G16, bf16, the engine with chunked prefill at ``CHUNK_BUDGET`` tokens
    and without it, on :func:`chunk_requests`: chunk tokens as the prompts
    imply, no chunk over the budget and only PREFILLING slots fed, a
    decode step between two chunk dispatches whenever a slot decodes,
    every kernel's launches as the dispatches and layers imply; the
    longest device-side decode stall while a long prompt is admitted,
    the co-resident requests' TPOT and the long prompts' TTFT, chunking
    on and off. Returns (launches, numbers)."""
    prompts, budgets = chunk_requests(full.vocab)
    long_from = min(len(p) for p in prompts[4:])
    out, tokens = {}, {}
    for chunk in (CHUNK_BUDGET, 0):
        record = []
        tokens[chunk], eng, launches, wall = _chunk_engine(
            full, params, chunk, prompts, budgets, record)
        torch.cuda.synchronize()
        m = eng.metrics.summary()
        tag = f"chunk {chunk}" if chunk else "monolithic"
        chunks = [e for e in record if e["kind"] == "chunk"]
        log(f"[chunk engine] {tag}: {eng.metrics.format_summary()}")
        log(f"[chunk engine] {tag}: prompts {[len(p) for p in prompts]}; "
            f"{m['prefills']} batched prefills, {len(chunks)} chunk "
            f"dispatches, {m['decode_steps']} decode steps; wall "
            f"{wall:.1f}s; launches {launches}")
        reg = eng.tel.registry
        fed = int(reg.counter("engine.prefill_chunk_tokens").value)
        want = sum(len(p) for p in prompts if chunk and len(p) > chunk)
        require(fed == want, f"{tag}: chunk tokens {fed}, the prompts imply "
                             f"{want}")
        require(bool(chunks) == bool(chunk) and m["prefill_tails"] == 0,
                f"{tag}: chunk dispatches exactly when chunking")
        for i, e in enumerate(chunks):
            feed = e["feed"].cpu()
            fed_slots = [s for s in range(4) if int(feed[s]) > 0]
            require(int(feed.max()) <= chunk and e["t_pad"] <= chunk
                    and fed_slots == sorted(e["prefilling"]),
                    f"{tag}: chunk dispatch {i} fed {feed.tolist()} (t_pad "
                    f"{e['t_pad']}) with slots {e['prefilling']} "
                    f"PREFILLING")
        kinds = [e["kind"] for e in record]
        for i, e in enumerate(record):
            if e["kind"] != "chunk" or not e["decoding"]:
                continue
            nxt = kinds[i + 1:]
            if "chunk" in nxt:
                require("decode" in nxt[:nxt.index("chunk")],
                        f"{tag}: a decode step between chunk dispatches "
                        f"while {e['decoding']} slots decode")
        layers = full.n_layers
        dispatches = m["prefills"] + len(chunks) + m["decode_steps"]
        expect = {"gqsa_gemv": 7 * layers * dispatches,
                  "paged_attention": layers * (len(chunks)
                                               + m["decode_steps"])}
        require(all(launches[k] == v for k, v in expect.items()),
                f"{tag}: launches {launches} are not the layer structure's "
                f"{expect}")
        require(all(v == 0 for k, v in launches.items() if k not in expect),
                f"{tag}: nothing else launched")
        admitting, other = _admission_stalls(record, long_from)
        require(admitting, f"{tag}: long prompts admitted beside decodes")
        rts = [eng.metrics.requests[i] for i in range(8)]
        tpot = [r.tpot_s * 1e3 for r in rts[:4]]
        ttft = [r.ttft_s * 1e3 for r in rts[4:]]
        out[tag] = dict(
            launches=launches, chunk_dispatches=len(chunks),
            decode_steps=m["decode_steps"], prefills=m["prefills"],
            stall_ms_max=max(admitting),
            gap_ms_p50=float(np.median(other)) if other else None,
            tpot_ms_p50=float(np.percentile(tpot, 50)),
            tpot_ms_p99=float(np.percentile(tpot, 99)),
            long_ttft_ms=ttft, wall_s=wall)
        log(f"[chunk engine] {tag}: longest device-side decode stall while "
            f"a long prompt is admitted {max(admitting):.1f} ms (over "
            f"{len(admitting)} gaps; other gaps p50 "
            f"{out[tag]['gap_ms_p50'] or float('nan'):.2f} ms); co-resident "
            f"requests' TPOT p50 {out[tag]['tpot_ms_p50']:.2f} ms p99 "
            f"{out[tag]['tpot_ms_p99']:.2f} ms ({['%.2f' % x for x in tpot]});"
            f" long prompts' TTFT {['%.1f' % x for x in ttft]} ms")
        del eng
        torch.cuda.empty_cache()
    same = sum(np.array_equal(a, b) for a, b in zip(tokens[CHUNK_BUDGET],
                                                    tokens[0]))
    log(f"[chunk engine] bf16: {same} of 8 requests' tokens equal with "
        f"chunking on and off (bf16 ties may flip; (c) holds f32)")
    return out


def phase_chunk_f32(cfg, params, prefix_on=None):
    """(c) f32 at full width and ``PREFIX_CHECK_LAYERS`` layers: greedy
    tokens with chunking on against off on (b)'s requests at budgets
    ``CHUNK_BUDGET`` and ``CHUNK_CROSS_PAGES``, and on phase 22's prefix
    requests with the prefix cache on at ``CHUNK_PREFIX_BUDGET`` (the
    hits chunk their tails from the shared boundary); ``prefix_on``, the
    cache-on tokens phase 22 took there (run again when None)."""
    prompts, budgets = chunk_requests(cfg.vocab)
    off, _, _, w_off = _chunk_engine(cfg, params, 0, prompts, budgets)
    for chunk in (CHUNK_BUDGET, CHUNK_CROSS_PAGES):
        got, eng, launches, wall = _chunk_engine(cfg, params, chunk,
                                                 prompts, budgets)
        n = int(eng.tel.registry.counter("engine.prefill_chunks").value)
        mism = _tokens_equal(params, cfg, prompts, got, off,
                             f"chunk {chunk}", tag="chunk f32")
        log(f"[chunk f32] chunk {chunk} ({cfg.n_layers} layers): "
            f"{8 - mism} of 8 requests' tokens equal to unchunked; {n} "
            f"slot chunks; wall {wall:.1f}s (off {w_off:.1f}s)")
        require(n > 0 and launches["paged_attention"] > 0, "chunks ran")
        del eng
    pprompts = prefix_requests(cfg.vocab)
    if prefix_on is None:
        prefix_on = _prefix_engine(cfg, params, True)[0]
    got, eng, _, wall = _prefix_engine(
        cfg, params, True, prefill_chunk_tokens=CHUNK_PREFIX_BUDGET)
    c = _prefix_counters(eng)
    n = int(eng.tel.registry.counter("engine.prefill_chunks").value)
    mism = _tokens_equal(params, cfg, pprompts, got, prefix_on,
                         f"prefix chunk {CHUNK_PREFIX_BUDGET}",
                         tag="chunk f32")
    log(f"[chunk f32] prefix cache on, chunk {CHUNK_PREFIX_BUDGET}: "
        f"{8 - mism} of 8 requests' tokens equal to unchunked; counters {c}; "
        f"{n} slot chunks; wall {wall:.1f}s")
    require(c["hits"] > 0 and n > 0, "prefix hits chunked their tails")


def phase_chunk_deepseek():
    """(d) DeepSeek-V2 at full width and ``CHUNK_DS_LAYERS`` layers, f32,
    dropless, GQSA: prompts of 200-400 tokens through the engine with
    chunking on and off; tokens equal (the near-tie rule), the latent
    mode launched on the chunk dispatches. Returns the latent launches
    on the chunk dispatches."""
    from repro_torch.core.gqs_layer import GQSAConfig
    from repro_torch.models import transformer as tf
    arch = "deepseek_v2_236b"
    cfg = _moe_spec_cfg(arch, CHUNK_DS_LAYERS, "float32", MOE_DROPLESS[arch])
    t0 = time.time()
    params = tf.init_params(SEED, cfg, "cuda", compress=GQSAConfig())
    torch.cuda.synchronize()
    log(f"[chunk deepseek] DeepSeek-V2 full width, {CHUNK_DS_LAYERS} layers, "
        f"f32, capacity factor {cfg.moe.capacity_factor:g}: packed in "
        f"{time.time() - t0:.1f}s")
    rng = np.random.default_rng(SEED + 24)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in CHUNK_DS_PROMPTS]
    budgets = [16] * len(prompts)
    off, _, _, w_off = _chunk_engine(cfg, params, 0, prompts, budgets,
                                     max_seq=512)
    record = []
    got, eng, launches, wall = _chunk_engine(cfg, params, CHUNK_BUDGET,
                                             prompts, budgets, record,
                                             max_seq=512)
    latent = sum(e["latent"] for e in record if e["kind"] == "chunk")
    chunks = sum(e["kind"] == "chunk" for e in record)
    mism = _tokens_equal(params, cfg, prompts, got, off, "deepseek chunk",
                         tag="chunk deepseek")
    log(f"[chunk deepseek] chunk {CHUNK_BUDGET}: {len(prompts) - mism} of "
        f"{len(prompts)} requests' tokens equal to unchunked; {chunks} chunk "
        f"dispatches, {latent} latent launches on them; launches "
        f"{launches}; wall {wall:.1f}s (off {w_off:.1f}s)")
    require(latent == cfg.n_layers * chunks > 0,
            "the latent mode launched on every chunk dispatch's layers")
    del params, eng
    torch.cuda.empty_cache()
    return latent


def phase_chunk_serve():
    """(e) The serve CLI with ``--chunked-prefill 3 --trace`` at full width
    and depth on llama2-7b: every one of its 4-15-token prompts chunks
    (a 4-token prompt would fit one chunk of 4 and take the batched
    prefill), so its trace holds ``prefill_chunk`` spans whose
    ``completed`` sums to the 8 requests. Returns its launches."""
    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", "chunk_serve_trace.json")
    launches = phase_serve("gqsa", extra=[
        "--chunked-prefill", str(CHUNK_SERVE_BUDGET), "--trace", path])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events
             if e.get("ph") == "X" and e.get("name") == "prefill_chunk"]
    done = sum(e["args"]["completed"] for e in spans)
    log(f"[chunk serve] trace {path}: {len(spans)} prefill_chunk spans, "
        f"completed sums to {done}")
    require(spans and done == 8, "the trace holds the chunk spans of all 8 "
                                 "requests")
    return launches


def phase_chunk(timer, llama=None, llama_f32=None, prefix_on=None):
    """Phase 23, chunked prefill: (a) :func:`phase_chunk_kernels`; (b)
    :func:`phase_chunk_engine` on ``llama`` (cfg, params; packed here when
    None); (c) :func:`phase_chunk_f32` on ``llama_f32``; (d)
    :func:`phase_chunk_deepseek`; (e) :func:`phase_chunk_serve`. Returns
    (errors, latent timing, {path: launches}, engine numbers)."""
    t0 = time.time()
    errs, timing = phase_chunk_kernels(timer)
    torch.cuda.empty_cache()
    llama = llama or _llama_gqsa()
    numbers = phase_chunk_engine(*llama)
    launches = {"chunk engine": numbers[f"chunk {CHUNK_BUDGET}"]["launches"]}
    llama = None
    torch.cuda.empty_cache()
    phase_chunk_f32(*(llama_f32 or _llama_gqsa(PREFIX_CHECK_LAYERS,
                                               "float32")), prefix_on)
    torch.cuda.empty_cache()
    numbers["deepseek_latent_chunk_launches"] = phase_chunk_deepseek()
    launches["chunk serve"] = phase_chunk_serve()
    log(f"[time] chunked prefill (phase 23) {time.time() - t0:.1f}s")
    return errs, timing, launches, numbers


KERNELS = {
    "gqsa_gemv": dict(
        source="src/repro_torch/csrc/gqsa_gemv.cu",
        replaces="src/repro/kernels/gqsa_gemv.py:71",
        unit="one decode layer: 7 projections at 4 slots, bf16 x; 'rows' "
             "holds the same layer at T = 64 (prefill rows) and T = 116 "
             "(a (4,2,2) tree verify of 4 slots), one launch a projection, "
             "each with ms, plain_ms, library_ms (torch.matmul on the "
             "dense bf16 W), bound_ms and bound_by, and "
             "'deepseek_v2_kv_a' DeepSeek-V2's kv_a projection (N=576, "
             "K=5120) at T = 4; every bound is the "
             "larger of the bytes over 3.35 TB/s and the multiply-adds "
             "over the bf16 tensor cores' 989 TFLOP/s; all at group size "
             "16, and 'group_sizes' the same layer at g = 8, 32, 64 and "
             "128 (T = 4, 'rows' T = 64 and 116; at 128 also kv_a) with "
             "its error, llama2-7b's packed GB and its launches on the "
             "llama2-7b serve at that g; 'spec_g32_launches' / 'spec_g128_launches' those of the "
             "chain w4s75 serve at g; 'prefix_launches' its launches on "
             "phase 22's prefix engine, 'chunk_launches' on phase 23's "
             "chunked engine"),
    "paged_attention": dict(
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:181",
        unit="one layer's decode attention: 4 slots, lengths 20/25/31/29, "
             "KH=32, D=128, bf16 pages; 'prefix_tail' the prefix cache's "
             "tail feed (T=64 rows a slot over 1008-1040 cached "
             "positions, phase 22) timed, its error, its launches on the "
             "prefix engine and the TTFT of that engine's misses and "
             "hits; 'chunk_feed_max_abs_err' its error on phase 23's chunk "
             "feed, 'chunk_launches' its launches on the chunked engine "
             "and 'chunk_engine' that engine's numbers, chunking on and "
             "off (the longest device-side decode stall while a long "
             "prompt is admitted, the co-resident requests' TPOT, the "
             "long prompts' TTFT)"),
    "w4_matmul": dict(
        source="src/repro_torch/csrc/w4_matmul.cu",
        replaces="src/repro/kernels/w4_matmul.py:51",
        unit="one decode layer: 7 projections at 4 slots, G16, bf16 x; "
             "'g128_serve_launches' / 'g128_serve_tc_launches' its "
             "launches on the llama2-7b serve under --compress w4 "
             "--group-size 128 (tensor cores: the second)"),
    "paged_attention_int8": dict(
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:181",
        unit="one layer's decode attention: 4 slots, lengths 20/25/31/29, "
             "KH=32, D=128, int8 pages + f32 scales; "
             "'prefix_tail_max_abs_err' its error on phase 22's tail feed, "
             "'chunk_feed_max_abs_err' on phase 23's chunk feed"),
    "paged_attention_tree": dict(
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:181",
        unit="one layer's tree verify attention, fanout (4,2,2): 4 slots, "
             "T=29, lengths ~64, KH=32, D=128, bf16 pages; 'lengths' holds "
             "~64 and ~256, 'deepseek_moe_kh16' the same at KH=16, "
             "'moe_spec_launches' the tree-mode launches of the "
             "deepseek-moe-16b GQSA tree serve"),
    "gqsa_gemv_experts": dict(
        source="src/repro_torch/csrc/gqsa_gemv.cu",
        replaces="src/repro/kernels/gqsa_gemv.py:71",
        unit="one DeepSeek-V2 decode layer's routed experts (w_g, w_u, "
             "w_d; the Pallas kernel under the vmap at "
             "src/repro/models/moe.py:73) through the streaming expert "
             "kernel (gqsa_gemv_experts_launch), one launch a projection: "
             "160 experts, C=1, the occupied experts of one 4-slot step, "
             "bf16 x; 'deepseek_moe_layer' holds a deepseek-moe-16b decode "
             "layer (64 experts) and 'prefill' the layers of prefill "
             "dispatches (C = 3, 7 and 30), each with its bound and "
             "torch.bmm; 'verify' the layers at verify capacities "
             "(deepseek-moe-16b C = 2 and 13, DeepSeek-V2 C = 5) with the "
             "rows of a verify dispatch recorded on the served path named "
             "by 'routing', and "
             "'spec_launches' the launches of the MoE families' GQSA "
             "tree paths; all at group size 16, and 'group_sizes' a "
             "deepseek-moe-16b decode layer (C=1) at g = 8, 32, 64 and "
             "128 with its error, deepseek-moe-16b's packed GB and its "
             "launches on the deepseek-moe-16b serve at that g"),
    "paged_attention_latent": dict(
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:181",
        unit="one DeepSeek-V2 layer's latent decode attention: 4 slots, "
             "lengths 20/25/31/29, H=128, D=576, v_rank 512, bf16 pages; "
             "'verify_422' a (4,2,2) verify block (T=29) at ~64 and ~256, "
             "its bound at the tensor cores' rate (bound_f32_ms: at the "
             "f32 rate); 'spec_launches' / 'spec_tree_launches' the latent "
             "launches (with tree operands) of the DeepSeek-V2 tree "
             "engine; 'chunk_feed' the chunk feed (T=64 rows a slot over "
             "up to 1088 positions, phase 23) timed with its error, "
             "'chunk_launches' its launches on the chunk dispatches of "
             "phase 23's DeepSeek-V2 engine"),
    "w4_matmul_experts": dict(
        source="src/repro_torch/csrc/w4_matmul.cu",
        replaces="src/repro/kernels/w4_matmul.py:51",
        unit="one deepseek-moe-16b decode layer's routed experts (wg, wu, "
             "wd at G16; the Pallas kernel under the vmap at "
             "src/repro/models/moe.py:91): 64 experts, C=1, the occupied "
             "experts of one 4-slot step, bf16 x; 'deepseek_v2_layer' "
             "holds a DeepSeek-V2 layer (160 experts), 'spec_launches' "
             "(tensor cores: 'spec_tc_launches') the launches of the "
             "w4l25 draft of the deepseek-moe-16b GQSA tree serve, "
             "'verify' the layers at verify capacities (deepseek-moe-16b "
             "C = 2 and 13, DeepSeek-V2 C = 5) with the rows of a verify "
             "dispatch recorded on the served path named by 'routing'"),
    "kv_decode_attention": dict(
        source="src/repro_torch/csrc/kv_decode_attention.cu",
        replaces="src/repro/kernels/ops.py:261",
        unit="one layer's int8 decode attention over the contiguous cache "
             "(paged_attention_pallas in int8 mode under identity block "
             "tables): 4 sequences, KH=32, R=1, D=128, length 32768; "
             "'lengths' holds 4096 and 32768"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    t_start = time.time()
    name, smi = phase_device()
    phase_build()
    errs = {"gqsa_gemv": phase_gemv_check()}
    attn = phase_attention_check()
    errs["paged_attention"] = attn["plain"]
    errs["paged_attention_int8"] = attn["int8"]
    errs["w4_matmul"] = phase_w4_check()
    errs["paged_attention_tree"] = phase_tree_check()
    timer = Timer()
    times = phase_timing(timer)
    times["paged_attention_tree"] = phase_tree_timing(timer)
    torch.cuda.empty_cache()
    # each main path's launches, counted from 0 just before it
    launches = {"int8-kv engine": phase_model_gqsa()}
    torch.cuda.empty_cache()
    phase_model_w4()
    torch.cuda.empty_cache()
    launches["gqsa serve"] = phase_serve("gqsa")
    torch.cuda.empty_cache()
    launches["w4 serve"] = phase_serve("w4")
    torch.cuda.empty_cache()
    phase_spec_engine()
    for label in SPEC_SERVE:
        torch.cuda.empty_cache()
        launches[label] = phase_serve_spec(label)
    torch.cuda.empty_cache()
    errs["paged_attention_latent"] = phase_latent_check()
    errs["gqsa_gemv_experts"] = phase_experts_check()
    times.update(phase_mla_moe_timing(timer))
    torch.cuda.empty_cache()
    launches["deepseek engine"] = phase_model_deepseek()
    torch.cuda.empty_cache()
    t_moe = time.time()
    errs["w4_matmul_experts"] = phase_w4_experts_check()
    times.update(phase_w4_experts_timing(timer))
    for compress in ("gqsa", "w4"):
        torch.cuda.empty_cache()
        phase_model_moe(compress)
    for compress in ("gqsa", "w4"):
        torch.cuda.empty_cache()
        launches[f"deepseek-moe {compress} serve"] = phase_serve(
            compress, "deepseek_moe_16b")
    torch.cuda.empty_cache()
    launches["deepseek w4 engine"] = phase_model_deepseek_w4()
    log(f"[time] the W4 expert axis, deepseek-moe-16b and DeepSeek-V2 W4 "
        f"phases {time.time() - t_moe:.1f}s")
    torch.cuda.empty_cache()
    t_static = time.time()
    errs["kv_decode_attention"] = phase_kv_decode_check()
    times["kv_decode_attention"] = phase_kv_decode_timing(timer)
    launches["static int8 serve"] = phase_static()
    log(f"[time] the static-batch contiguous path (phase 18) "
        f"{time.time() - t_static:.1f}s")
    torch.cuda.empty_cache()
    spec_moe, spec_times = phase_spec_moe(timer)
    launches.update(spec_moe)
    torch.cuda.empty_cache()
    groups, group_launches = phase_group_sizes(timer)
    launches.update(group_launches)
    torch.cuda.empty_cache()
    dense_errs, dense_times, dense_launches, dense_by = phase_dense_configs(
        timer)
    launches.update(dense_launches)
    torch.cuda.empty_cache()
    # phases 22 and 23 share llama2-7b, packed once: bf16 at full depth
    # and f32 at PREFIX_CHECK_LAYERS
    llama = _llama_gqsa()
    llama_f32 = _llama_gqsa(PREFIX_CHECK_LAYERS, "float32")
    prefix_errs, prefix_time, prefix_launches, prefix_ttft, prefix_on = \
        phase_prefix(timer, llama, llama_f32)
    launches.update(prefix_launches)
    torch.cuda.empty_cache()
    chunk_errs, chunk_time, chunk_launches, chunk_numbers = phase_chunk(
        timer, llama, llama_f32, prefix_on)
    launches.update(chunk_launches)
    del llama, llama_f32
    torch.cuda.empty_cache()
    path_of = {"gqsa_gemv": "gqsa serve", "paged_attention": "gqsa serve",
               "w4_matmul": "w4 serve",
               "paged_attention_int8": "int8-kv engine",
               "paged_attention_tree": "tree serve",
               "gqsa_gemv_experts": "deepseek engine",
               "paged_attention_latent": "deepseek engine",
               "w4_matmul_experts": "deepseek-moe w4 serve",
               "kv_decode_attention": "static int8 serve"}
    kernels = [dict(name=k, route="cuda", source=v["source"],
                    replaces=v["replaces"],
                    launches=launches[path_of[k]][k],
                    max_abs_err=errs[k], ms=times[k]["ms"],
                    plain_ms=times[k]["plain_ms"],
                    bound_ms=times[k]["bound_ms"],
                    bound_by=times[k].get("bound_by", "bytes"),
                    library_ms=times[k]["library_ms"], unit=v["unit"],
                    path=path_of[k])
               for k, v in KERNELS.items()]
    gemv = next(k for k in kernels if k["name"] == "gqsa_gemv")
    gemv["rows"] = times["gqsa_gemv"]["rows"]
    gemv["deepseek_v2_kv_a"] = times["gqsa_gemv_kv_a"]
    gx = next(k for k in kernels if k["name"] == "gqsa_gemv_experts")
    for key in ("occupied", "deepseek_moe_layer", "prefill"):
        gx[key] = times["gqsa_gemv_experts"][key]
    w4 = next(k for k in kernels if k["name"] == "w4_matmul")
    w4["tc_launches"] = launches["w4 serve"]["w4_matmul_tc"]
    w4["launch_floor_ms"] = times["w4_matmul"]["launch_floor_ms"]
    w4x = next(k for k in kernels if k["name"] == "w4_matmul_experts")
    w4x["tc_launches"] = launches["deepseek-moe w4 serve"][
        "w4_matmul_experts_tc"]
    w4x["occupied"] = times["w4_matmul_experts"]["occupied"]
    w4x["deepseek_v2_layer"] = times["w4_matmul_experts"]["deepseek_v2_layer"]
    kvd = next(k for k in kernels if k["name"] == "kv_decode_attention")
    kvd["lengths"] = times["kv_decode_attention"]["lengths"]
    # phase 19: launches on the MoE families' speculative paths and the
    # timings at their shapes
    tree = next(k for k in kernels if k["name"] == "paged_attention_tree")
    tree["lengths"] = times["paged_attention_tree"]["lengths"]
    tree["moe_spec_launches"] = spec_moe["deepseek-moe gqsa tree serve"][
        "paged_attention_tree"]
    tree["deepseek_moe_kh16"] = spec_times["tree_kh16"]
    lat = next(k for k in kernels if k["name"] == "paged_attention_latent")
    lat["spec_launches"] = spec_moe["deepseek spec engine"][
        "paged_attention_latent"]
    lat["spec_tree_launches"] = spec_moe["deepseek spec engine"][
        "paged_attention_latent_tree"]
    lat["verify_422"] = spec_times["latent_verify_422"]
    gx["spec_launches"] = {
        path: spec_moe[path]["gqsa_gemv_experts"]
        for path in ("deepseek-moe gqsa tree serve", "deepseek spec engine")}
    gx["verify"] = spec_times["experts_verify"]
    w4x["spec_launches"] = spec_moe["deepseek-moe gqsa tree serve"][
        "w4_matmul_experts"]
    w4x["spec_tc_launches"] = spec_moe["deepseek-moe gqsa tree serve"][
        "w4_matmul_experts_tc"]
    w4x["verify"] = spec_times["w4_experts_verify"]
    # phase 20: the group sizes 8, 32, 64 and 128
    gemv["group_sizes"] = group_size_rows(groups, launches, "gemv")
    gx["group_sizes"] = group_size_rows(groups, launches, "experts")
    for label, flags, _ in GROUP_SPEC_SERVE:
        gemv[f"spec_g{flags[-1]}_launches"] = launches[label]["gqsa_gemv"]
    w4_g = launches[f"w4 serve g{GROUP_W4_SERVE}"]
    w4[f"g{GROUP_W4_SERVE}_serve_launches"] = w4_g["w4_matmul"]
    w4[f"g{GROUP_W4_SERVE}_serve_tc_launches"] = w4_g["w4_matmul_tc"]
    # phase 21: the four dense configs' launches on their paths (every
    # kernel keeps the key; those off the dense paths hold {}), worst
    # errors at their shapes and their timings
    for k in kernels:
        k["dense_configs"] = dense_by.get(k["name"], {})
        if k["name"] in dense_errs:
            k["dense_max_abs_err"] = dense_errs[k["name"]]
        if k["name"] in dense_times:
            k["dense_times"] = dense_times[k["name"]]
    # phase 22: the prefix cache's tail feed and its main path
    pa = next(k for k in kernels if k["name"] == "paged_attention")
    pa["prefix_tail"] = dict(
        prefix_time, max_abs_err=prefix_errs["plain"],
        launches=launches["prefix engine"]["paged_attention"],
        ttft=prefix_ttft)
    pi8 = next(k for k in kernels if k["name"] == "paged_attention_int8")
    pi8["prefix_tail_max_abs_err"] = prefix_errs["int8"]
    gemv["prefix_launches"] = launches["prefix engine"]["gqsa_gemv"]
    # phase 23: chunked prefill's feed and its main path
    pa["chunk_feed_max_abs_err"] = chunk_errs["plain"]
    pa["chunk_launches"] = launches["chunk engine"]["paged_attention"]
    pa["chunk_engine"] = {
        tag: {k: v for k, v in n.items() if k != "launches"}
        for tag, n in chunk_numbers.items() if isinstance(n, dict)}
    pi8["chunk_feed_max_abs_err"] = chunk_errs["int8"]
    lat["chunk_feed"] = chunk_time
    lat["chunk_launches"] = chunk_numbers["deepseek_latent_chunk_launches"]
    gemv["chunk_launches"] = launches["chunk engine"]["gqsa_gemv"]
    require(all(k["launches"] > 0 for k in kernels),
            "every kernel launched on its main path")
    require(all(r["launches"] > 0 for k in (gemv, gx)
                for r in k["group_sizes"].values()),
            "gqsa_gemv and its expert axis launched at every group size on "
            "its served path")
    log(f"[time] chip_smoke total {time.time() - t_start:.1f}s")
    log(f"[power] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
