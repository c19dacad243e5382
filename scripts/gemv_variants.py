"""What holds ``gqsa_gemv`` back: scratch variants of the streaming kernel
(``src/repro_torch/csrc/gqsa_gemv.cu``), timed in one process on one
card, then the dispatcher at many rows.

    python3 scripts/gemv_variants.py

Each variant is the source with one edit, built by ``nvcc`` under
``build/gemv_variants/``. Each times one llama2-7b layer of the 7 GQSA
W4 S50 G16 projections with bf16 x (``chip_smoke.Timer``: L2 flushed by
a 1 GiB write before every launch).

Streaming variants (``gqsa_gemv_launch``, launched as
``kernels/gqsa_gemv.py:plan`` launches them) at T = 4, 64 and 116: as
built; without the x reads (each chunk of x a set of constants that
differ by token and cost no instruction); without the payload (no copy
is issued and each slot's idx, scale, zero and codes are register values
of the slot); x widened once to f32 (the f32 instantiation, on x
converted before the timed launch; its tile is at most 4 rows); an
8-stage ring instead of 3 (T = 4 only: at T = 116 the x tile of wd
leaves no room). The warp-per-row kernel that the first design ran (PR
20's variants of it, `PERF.md`) is gone from the source; the expert
axis has its own variants in ``scripts/experts_variants.py``.

Then ``ops.gqsa_gemv`` of the checkout (the repository's own path) at T
in {4, 20, 64, 116}, beside ``torch.matmul`` on the dense bf16 W and the
bound (the larger of the bytes over 3.35 TB/s and the multiply-adds over
the bf16 tensor cores' 989 TFLOP/s). Prints ``VARIANT`` and ``ROWS``
lines.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

SRC_PATH = os.path.join(ROOT, "src/repro_torch/csrc/gqsa_gemv.cu")
OUT = os.path.join(ROOT, "build/gemv_variants")

# the streaming kernel (gqsa_gemv_launch)
X_READ = ("      chunk(reinterpret_cast<const T*>(\n"
          "                line + 16 * (tok * L::kParts + (sp ^ v))), xv);\n")
NO_X_READ = ("#pragma unroll\n"
             "      for (int e = 0; e < L::kElems; ++e)\n"
             "        xv[e] = __int_as_float(0x3f800000 + (j << 8) + "
             "(sp << 4) + e);\n")
RING_COPIES = ("      cp_async4(&st.idx[lane], a.idx + f, 4);\n"
               "      cp_async4(&st.scale[lane], a.scale + f, 4);\n"
               "      cp_async4(&st.zero[lane], a.zero + f, 4);\n"
               "      cp_async_codes(&st.vals[lane], vals + f);\n")
NO_RING_COPIES = "      (void)st;\n      (void)f;\n"
RING_READ = ("      group<T, TT, G>(st.vals[lane], max(st.idx[lane], 0), "
             "st.scale[lane],\n"
             "                      st.zero[lane], xg, xsum, u, v, acc);\n")
# a slot's codes made from its slot and row (any group size)
NO_RING_READ = ("      (void)st;   // m < M <= K / G: a valid column\n"
                "      const uint32_t made[4] = {m * 0x01234567u, "
                "static_cast<uint32_t>(row),\n"
                "                                m * 0x89ABCDEFu, "
                "static_cast<uint32_t>(row ^ m)};\n"
                "      V pk;\n"
                "      memcpy(&pk, made, sizeof(V));\n"
                "      group<T, TT, G>(pk, m, 1e-3f, 8.f, xg, xsum, u, v, "
                "acc);\n")
DEPTH = "constexpr int kDepth = 3;"
STREAM_VARIANTS = {
    "stream as built": lambda s: s,
    "stream no x reads": lambda s: _edit(s, X_READ, NO_X_READ),
    "stream no payload": lambda s: _edit(_edit(s, RING_COPIES,
                                               NO_RING_COPIES),
                                         RING_READ, NO_RING_READ),
    "stream 8-stage ring": lambda s: _edit(s, DEPTH,
                                           "constexpr int kDepth = 8;"),
}


def _edit(src, old, new):
    if old not in src:
        raise RuntimeError(f"the source no longer holds {old!r}")
    return src.replace(old, new)


def build():
    """{variant: library path}, every nvcc started at once."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    os.makedirs(OUT, exist_ok=True)
    src = open(SRC_PATH).read()
    procs = {}
    for i, (name, edit) in enumerate(STREAM_VARIANTS.items()):
        cu = os.path.join(OUT, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(edit(src))
        lib = os.path.join(OUT, f"libv{i}.so")
        procs[name] = (subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def streaming(lib_path, depth):
    """``call(x, bsr)``: the variant's streaming kernel (its ring
    ``depth`` stages deep), launched as ``kernels/gqsa_gemv.py:plan``
    launches it."""
    import torch
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.gqsa_gemv import (RING_DEPTH, STAGE_BYTES,
                                               STREAM_WARPS, plan,
                                               smem_bytes)
    fn = ctypes.CDLL(lib_path).gqsa_gemv_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 8 + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(x, bsr):
        t, k = x.shape
        n, m = bsr.idx.shape
        g = bsr.group_size
        p = plan(t, n, k, g, x.element_size(), sm_count(0))
        smem = (smem_bytes(p.tile, k, g, x.element_size())
                + STREAM_WARPS * (depth - RING_DEPTH) * STAGE_BYTES[g])
        y = torch.empty((t, n), dtype=torch.float32, device=x.device)
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                bsr.idx.data_ptr(), bsr.vals.data_ptr(),
                bsr.scale.data_ptr(), bsr.zero.data_ptr(), y.data_ptr(),
                t, n, m, k, g, p.tile, p.tiles, p.blocks, smem,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return y
    return call


def main() -> int:
    import torch
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.core.bsr import to_dense
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        print("gemv_variants: no CUDA device", file=sys.stderr)
        return 1
    print(f"[device] {cs.phase_device()[1]}", flush=True)
    libs = build()
    timer = cs.Timer()
    g = torch.Generator(device="cuda").manual_seed(3)
    packed = {label: cs._packed(n, k, 4)
              for label, (n, k) in cs.SHAPES.items()}
    xs = {(label, t): torch.randn((t, k), generator=g, device="cuda",
                                  dtype=torch.bfloat16)
          for label, (n, k) in cs.SHAPES.items() for t in (4, 20, 64, 116)}
    plain = {(label, t): ops.gqsa_gemv(xs[(label, t)], bsr, plain=True)
             for label, bsr in packed.items() for t in (4, 64)}

    def layer(name, t, call, x_of=lambda x: x, iters=50, check=False):
        total, parts = 0.0, []
        for label, bsr in packed.items():
            x = x_of(xs[(label, t)])
            note = ""
            if check:
                y = call(x, bsr)
                torch.cuda.synchronize()
                ref = plain[(label, t)]
                err = ((y - ref).abs().max() / ref.abs().max()).item()
                note = f" (rel {err:.1e})"
            ms = timer.ms(lambda: call(x, bsr), iters=iters)
            total += cs.PER_LAYER[label] * ms
            parts.append(f"{label} {ms * 1e3:.2f}{note}")
        print(f"VARIANT {name} T={t}: layer {total * 1e3:.2f}us "
              f"({'; '.join(parts)})", flush=True)

    for name in ("stream as built", "stream no x reads",
                 "stream no payload"):
        call = streaming(libs[name], 3)
        for t in (4, 64, 116):
            layer(name, t, call, check=name == "stream as built"
                  and t < 116)
    call = streaming(libs["stream as built"], 3)
    for t in (4, 64, 116):
        layer("stream x widened to f32 once", t, call,
              x_of=lambda x: x.float(), check=t < 116)
    # the 8-stage ring only at T = 4: at T = 116 wd's x tile leaves no room
    layer("stream 8-stage ring", 4, streaming(libs["stream 8-stage ring"],
                                              8), check=True)
    dense = {label: to_dense(bsr).to(torch.bfloat16)
             for label, bsr in packed.items()}
    for t in (4, 20, 64, 116):
        tot = dict(kernel=0.0, matmul=0.0, bound=0.0)
        parts = []
        for label, bsr in packed.items():
            n, k = bsr.shape
            m = bsr.idx.shape[1]
            x = xs[(label, t)]
            nbytes = n * m * 20 + t * k * 2 + t * n * 4
            bound = cs._bound_ms(nbytes, 2 * t * n * m * 16,
                                 cs.BF16_TC_FLOP_PER_S)
            t_k = timer.ms(lambda: ops.gqsa_gemv(x, bsr), iters=50)
            t_l = timer.ms(lambda: torch.matmul(x, dense[label].T), iters=50)
            c = cs.PER_LAYER[label]
            for key, v in (("kernel", t_k), ("matmul", t_l),
                           ("bound", bound)):
                tot[key] += c * v
            parts.append(f"{label} {t_k * 1e3:.2f}")
        print(f"ROWS T={t}: ops.gqsa_gemv layer {tot['kernel'] * 1e3:.2f}us "
              f"matmul {tot['matmul'] * 1e3:.2f}us bound "
              f"{tot['bound'] * 1e3:.2f}us ({'; '.join(parts)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
