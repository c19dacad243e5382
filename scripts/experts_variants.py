"""What holds the expert axis of ``gqsa_gemv`` back: variants of the expert
kernels timed in one process on one card.

    python3 scripts/experts_variants.py [--old DIR] [--tokens 4]

Times one DeepSeek-V2 layer (w_g, w_u: N = 1536, K = 5120, M = 160; w_d:
N = 5120, K = 1536, M = 48; E = 160) and one deepseek-moe-16b layer (wg,
wu: N = 1408, K = 2048, M = 64; wd: N = 2048, K = 1408, M = 44; E = 64),
GQSA W4 S50 G16, bf16 x, with the buffer rows of one dispatch of
``--tokens`` routed rows (``chip_smoke._dispatch_rows``): 4, one 4-slot
decode step, gives capacity C = 1; 64 a prefill (C = 3 on DeepSeek-V2,
7 on deepseek-moe-16b).
``chip_smoke.Timer`` flushes L2 before every launch.

  (a) the warp-per-row kernel of DIR's ``csrc/gqsa_gemv.cu``
      (``gqsa_gemv_experts_launch`` of the first design: grid (N / 8, E),
      one warp an output row, <= 8 buffer rows a launch), as built;
  (b) the same kernel on a grid over the occupied experts only (the list
      is made on the host, for the experiment: a block's expert is
      ``occ[blockIdx.y]``; idle experts get no zeros);
  (c) at C = 1, the single-matrix streaming kernel of this checkout
      (``gqsa_gemv_cuda``) launched once per occupied expert and
      projection: the kernel times summed (each launch flushed), and the
      launches back to back;
  (d) this checkout's ``ops.gqsa_gemv_experts`` (one launch a projection
      once the expert axis streams), and scratch variants of its source:
      other ring depths (``--depths``, ``kExpertDepth``);
  (e) this checkout's library with ``--per-sm`` blocks an SM instead of
      its plan's;
  (f), (g), (i) with ``--edits``: the expert kernel without its payload
      (no copy is issued; each slot's idx, scale, zero and codes are
      register values of the slot), without its x reads (each chunk of x
      a set of constants), and with its payload only (every copy and wait,
      no arithmetic; rings 4 and 8 stages deep);
  (j) this checkout's library at ``--lanes`` lanes a row instead of its
      plan's (``kernels/gqsa_gemv.py:row_lanes``): 16 is two rows a warp.
  (h) ``ops.gqsa_gemv_experts`` with every expert idle: the launch, the
      pair count and the zeros alone.
``--flush read`` flushes L2 by reading 1 GiB instead of writing it, so
that the flush's dirty lines are not written back during the timed
launch.
(a) and (b) run only when DIR's source holds the warp-per-row kernel:
give ``--old`` a checkout of the parent of the streaming expert axis (an
unpacked ``git archive``); the default is this checkout. Each layer line
carries its bound: the occupied experts' payload (20 bytes a kept group),
their x rows and the whole y over 3.35 TB/s, or their multiply-adds over
the bf16 tensor cores' 989 TFLOP/s, whichever is larger. Prints
``VARIANT`` lines, each with its projections' times.
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

OUT = os.path.join(ROOT, "build/experts_variants")
OLD_EXPERT = ("  int nrows = B;\n"
              "  const int e = blockIdx.y;\n"
              "  if (rows != nullptr) nrows = min(max(rows[e] - c0, 0), B);\n")
OCC_EXPERT = ("  int nrows = B;\n"
              "  const int e = rows[blockIdx.y];   // the occupied experts\n")
DEPTH = re.compile(r"constexpr int kExpertDepth = \d+;")
# scratch edits of the expert kernel (and of `group`, which it shares)
RING_COPIES = ("        cp_async4(&st.idx[lane], a.idx + fo, 4);\n"
               "        cp_async4(&st.scale[lane], a.scale + fo, 4);\n"
               "        cp_async4(&st.zero[lane], a.zero + fo, 4);\n"
               "        cp_async_codes(&st.vals[lane], vals + fo);\n")
NO_RING_COPIES = "        (void)st;\n        (void)fo;\n"
RING_READ = ("        group<T, TT, G>(st.vals[lane], max(st.idx[lane], 0),\n"
             "                        st.scale[lane], st.zero[lane], xg, "
             "xsum, u, v, acc);\n")
# a slot's codes made from its slot and row (any group size)
NO_RING_READ = ("        (void)st;   // m < M <= K / G: a valid column\n"
                "        const uint32_t made[4] = {m * 0x01234567u, "
                "static_cast<uint32_t>(row),\n"
                "                                  m * 0x89ABCDEFu, "
                "static_cast<uint32_t>(row ^ m)};\n"
                "        V pk;\n"
                "        memcpy(&pk, made, sizeof(V));\n"
                "        group<T, TT, G>(pk, m, 1e-3f, 8.f, xg, xsum, u, v, "
                "acc);\n")
X_READ = ("      chunk(reinterpret_cast<const T*>(\n"
          "                line + 16 * (tok * L::kParts + (sp ^ v))), xv);\n")
NO_X_READ = ("#pragma unroll\n"
             "      for (int e = 0; e < L::kElems; ++e)\n"
             "        xv[e] = __int_as_float(0x3f800000 + (j << 8) + "
             "(sp << 4) + e);\n")
EDITS = {
    "(f) no payload": [(RING_COPIES, NO_RING_COPIES),
                       (RING_READ, NO_RING_READ)],
    "(g) no x reads": [(X_READ, NO_X_READ)],
    "(i) payload only": [(RING_READ, "        (void)st;\n")],
    "(i) payload only, 8 stages": [
        (RING_READ, "        (void)st;\n"),
        ("constexpr int kExpertDepth = 4;", "constexpr int kExpertDepth = 8;")],
}
MODELS = {
    "deepseek-v2": (160, {"wg/wu": (1536, 5120), "wd": (5120, 1536)}),
    "deepseek-moe-16b": (64, {"wg/wu": (1408, 2048), "wd": (2048, 1408)}),
}
PER_LAYER = {"wg/wu": 2, "wd": 1}


def _nvcc(jobs):
    """{name: library path} for {name: source text}, every nvcc at once."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(jobs.items()):
        cu = os.path.join(OUT, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib = os.path.join(OUT, f"libv{i}.so")
        procs[name] = (subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def warp_per_row(lib_path, occupied_grid):
    """``call(x, bsr, rows, occ)``: the first design's expert kernel, 8
    buffer rows a launch; on a grid over ``occ`` when ``occupied_grid``."""
    import torch
    fn = ctypes.CDLL(lib_path).gqsa_gemv_experts_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(x, bsr, rows, occ):
        e, c, k = x.shape
        n, m = bsr.idx.shape[-2:]
        y = torch.empty((e, c, n), dtype=torch.float32, device=x.device)
        for c0 in range(0, c, 8):
            rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                    bsr.idx.data_ptr(), bsr.vals.data_ptr(),
                    bsr.scale.data_ptr(), bsr.zero.data_ptr(), y.data_ptr(),
                    (occ if occupied_grid else rows).data_ptr(),
                    occ.numel() if occupied_grid else e, c, c0,
                    min(8, c - c0), n, m, k,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
        return y
    return call


def variant(lib_path, depth, per_sm, lanes=None):
    """``call(x, bsr, rows, occ)``: this checkout's expert launch on a
    library (a scratch one whose rings are ``depth`` stages deep, or the
    checkout's), its plan but ``per_sm`` blocks an SM and, if given,
    ``lanes`` lanes a row."""
    import torch
    import repro_torch.kernels.gqsa_gemv as kg
    from repro_torch.kernels.build import sm_count
    fn = ctypes.CDLL(lib_path).gqsa_gemv_experts_launch
    fn.argtypes = kg._experts_launcher().argtypes
    fn.restype = ctypes.c_int

    def call(x, bsr, rows, occ):
        e, c, k = x.shape
        n, m = bsr.idx.shape[-2:]
        g = bsr.group_size
        p = kg.experts_plan(e, c, n, m, k, g, x.element_size(), sm_count(0))
        smem = p.smem + (kg.STREAM_WARPS * (depth - kg.EXPERT_RING_DEPTH)
                         * kg.STAGE_BYTES[g])
        blocks = max(1, min(per_sm * sm_count(0),
                            -(-e * -(-c // p.tile) * n // kg.STREAM_WARPS)))
        y = torch.empty((e, c, n), dtype=torch.float32, device=x.device)
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                bsr.idx.data_ptr(), bsr.vals.data_ptr(), bsr.scale.data_ptr(),
                bsr.zero.data_ptr(), y.data_ptr(), rows.data_ptr(), e, c, n,
                m, k, g, p.tile, lanes or p.row_lanes, blocks, smem,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return y
    return call


def ReadFlushTimer():
    """``chip_smoke.Timer`` whose flush reads 1 GiB (a max over it), so
    no dirty line of the flush is written back during the timed call."""
    import chip_smoke as cs

    class Timer(cs.Timer):
        def ms(self, fn, iters=30, warmup=3):
            import torch
            for _ in range(warmup):
                fn()
            torch.cuda.synchronize()
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
            for s, e in ev:
                self.sink = self.flush.max()
                s.record()
                fn()
                e.record()
            torch.cuda.synchronize()
            return sum(s.elapsed_time(e) for s, e in ev) / iters
    return Timer()


def main(argv=None) -> int:
    import torch
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.gqsa_gemv import (EXPERT_RING_DEPTH as
                                               EXPERT_DEPTH, gqsa_gemv_cuda)
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", default=ROOT,
                    help="checkout whose csrc holds the warp-per-row kernel")
    ap.add_argument("--tokens", default="4",
                    help="comma list of routed rows a dispatch (4: a "
                         "4-slot decode step)")
    ap.add_argument("--per-sm", default="",
                    help="comma list of blocks an SM for (e), this "
                         "checkout's library on other grids")
    ap.add_argument("--lanes", default="",
                    help="comma list of lanes a row (16, 32) for (j)")
    ap.add_argument("--edits", action="store_true",
                    help="also time (f) and (g), scratch edits of the "
                         "expert kernel")
    ap.add_argument("--flush", default="write", choices=("write", "read"),
                    help="flush L2 by a 1 GiB write (chip_smoke.Timer) or "
                         "a 1 GiB read, which leaves no dirty line")
    ap.add_argument("--depths", default="",
                    help="comma list of ring depths for (d)'s scratch "
                         "variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("experts_variants: no CUDA device", file=sys.stderr)
        return 1
    print(f"[device] {cs.phase_device()[1]}", flush=True)
    old_src = open(os.path.join(args.old, "src/repro_torch/csrc/"
                                "gqsa_gemv.cu")).read()
    new_src = open(os.path.join(ROOT, "src/repro_torch/csrc/"
                                "gqsa_gemv.cu")).read()
    jobs = {}
    if OLD_EXPERT in old_src:
        jobs["(a) warp-per-row, as built"] = old_src
        jobs["(b) warp-per-row, occupied grid"] = old_src.replace(
            OLD_EXPERT, OCC_EXPERT)
    else:
        print(f"[note] {args.old} holds no warp-per-row kernel: (a), (b) "
              f"skipped", flush=True)
    if args.edits:
        for name, edits in EDITS.items():
            src = new_src
            for a, b in edits:
                if a not in src:
                    raise RuntimeError(f"the source no longer holds {a!r}")
                src = src.replace(a, b)
            jobs[name] = src
    for d in filter(None, args.depths.split(",")):
        if DEPTH.search(new_src):
            jobs[f"(d) ring depth {d}"] = DEPTH.sub(
                f"constexpr int kExpertDepth = {d};", new_src)
    libs = _nvcc(jobs)
    build_all(["gqsa_gemv"])
    calls = {}
    for name, lib in libs.items():
        if name.startswith("(d)"):
            calls[name] = variant(lib, int(name.split()[-1]), 1)
        elif name in EDITS:
            calls[name] = variant(lib, 8 if "8 stages" in name
                                  else EXPERT_DEPTH, 1)
        else:
            calls[name] = warp_per_row(lib, name.startswith("(b)"))
    from repro_torch.kernels.build import library_path
    lib = str(library_path("gqsa_gemv"))
    for per_sm in filter(None, args.per_sm.split(",")):
        calls[f"(e) {per_sm} blocks an SM"] = variant(lib, EXPERT_DEPTH,
                                                      int(per_sm))
    for lanes in filter(None, args.lanes.split(",")):
        calls[f"(j) {lanes} lanes a row"] = variant(lib, EXPERT_DEPTH, 1,
                                                    int(lanes))
    calls["(d) ops.gqsa_gemv_experts"] = \
        lambda x, bsr, rows, occ: ops.gqsa_gemv_experts(x, bsr, rows)
    calls["(h) ops, every expert idle"] = \
        lambda x, bsr, rows, occ: ops.gqsa_gemv_experts(
            x, bsr, torch.zeros_like(rows))
    timer = cs.Timer() if args.flush == "write" else ReadFlushTimer()
    g = torch.Generator(device="cuda").manual_seed(5)
    for model, (e, shapes) in MODELS.items():
        packed = {label: cs._experts_packed(n, k, cs.SEED + 12, e)
                  for label, (n, k) in shapes.items()}
        for tokens in (int(t) for t in args.tokens.split(",")):
            rows, cap = cs._dispatch_rows(g, e, tokens)
            occ = torch.nonzero(rows).flatten().to(torch.int32)
            n_occ = int(occ.numel())
            keep = (torch.arange(cap, device="cuda")[None, :]
                    < rows[:, None])
            res = {name: 0.0 for name in calls}
            if cap == 1:
                res["(c) streaming per expert, summed"] = 0.0
                res["(c) streaming per expert, back to back"] = 0.0
            bound = 0.0
            parts = {}
            for label, (n, k) in shapes.items():
                bsr = packed[label]
                m = bsr.idx.shape[-1]
                x = torch.randn((e, cap, k), generator=g, device="cuda",
                                dtype=torch.bfloat16) * keep[..., None]
                c = PER_LAYER[label]
                n_rows = int(rows.sum())
                nbytes = n_occ * n * m * 20 + n_rows * k * 2 + e * cap * n * 4
                bound += c * cs._bound_ms(nbytes, 2 * n_rows * n * m * 16,
                                          cs.BF16_TC_FLOP_PER_S)
                ref = ops.gqsa_gemv_experts(x, bsr, rows)
                for name, call in calls.items():
                    y = call(x, bsr, rows, occ)
                    torch.cuda.synchronize()
                    same = (name.startswith("(h)")
                            or torch.equal(y[occ.long()], ref[occ.long()]))
                    if not same:
                        err = (y[occ.long()] - ref[occ.long()]).abs().max()
                        print(f"[note] {name} {model} {label}: occupied "
                              f"rows differ from ops by {err.item():.3e}",
                              flush=True)
                    ms = timer.ms(lambda: call(x, bsr, rows, occ), iters=50)
                    res[name] += c * ms
                    parts.setdefault(name, []).append(
                        f"{label} {ms * 1e3:.1f}")
                if cap > 1:
                    continue
                per = [(x[i, :int(rows[i])].contiguous(), bsr.layer(i))
                       for i in occ.tolist()]
                res["(c) streaming per expert, summed"] += c * sum(
                    timer.ms(lambda: gqsa_gemv_cuda(xe, be), iters=20)
                    for xe, be in per)

                def back_to_back():
                    for xe, be in per:
                        gqsa_gemv_cuda(xe, be)
                res["(c) streaming per expert, back to back"] += \
                    c * timer.ms(back_to_back, iters=20)
            for name, ms in res.items():
                print(f"VARIANT {model} C={cap} ({n_occ} of {e} occupied, "
                      f"{int(rows.sum())} rows) {name}: layer "
                      f"{ms * 1e3:.1f}us (bound {bound * 1e3:.1f}us, "
                      f"{bound / ms:.0%}) "
                      f"[{'; '.join(parts.get(name, []))}]", flush=True)
        del packed
    return 0


if __name__ == "__main__":
    sys.exit(main())
