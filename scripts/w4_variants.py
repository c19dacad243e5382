"""Where the time of the tensor-core path of ``w4_matmul`` goes: scratch
variants of ``src/repro_torch/csrc/w4_matmul.cu`` timed in one process on
one card.

    python3 scripts/w4_variants.py

Each variant is the source with one edit, built by ``nvcc`` under
``build/w4_variants/`` and launched through the repository's wrapper
(``kernels/w4_matmul.py``, its launcher swapped): as built; without the
product (the ring's loads and the split combine only); without the loads
(the product on whatever shared memory holds); without the L2 line hint
of the copies; a 4-stage ring; 256-element stages in a 2-stage ring. Each
times one llama2-7b layer of the 7 W4 G16 projections with bf16 x at
T = 4 and T = 64 (``chip_smoke.Timer``: L2 flushed by a 1 GiB write
before every launch), then the build as it is at every split count in
{2, 3, 4, 6, 8} per projection, and the build and ``torch.matmul`` (on
the dequantized dense bf16 W) with the flush done by a 1 GiB read, which
leaves no dirty lines for the next kernel to write back. Prints
``VARIANT``, ``SPLITS`` and ``FLUSH`` lines.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

SRC_PATH = os.path.join(ROOT, "src/repro_torch/csrc/w4_matmul.cu")
OUT = os.path.join(ROOT, "build/w4_variants")
PRODUCT = ("    compute_stage<T, NT>(smem + (i % L::kStages) * L::kStage, "
           "acc,\n                         a.gshift);\n")
LOADS = ("    if (i < n_ch) ld.load(smem + i * L::kStage, a, t0, i);\n",
         "    if (next < n_ch)\n      ld.load(smem + (next % L::kStages) "
         "* L::kStage, a, t0, next);\n")
HINT = "cp.async.cg.shared.global.L2::128B"
STAGES = "static constexpr int kStages = 3;"
STAGE_K = "constexpr int kK = 128; "


def _edit(src, old, new):
    if old not in src:
        raise RuntimeError(f"the source no longer holds {old!r}")
    return src.replace(old, new)


VARIANTS = {
    "as built": lambda s: s,
    "no product": lambda s: _edit(s, PRODUCT, ""),
    "no loads": lambda s: _edit(_edit(s, LOADS[0], ""), LOADS[1], ""),
    "no L2 line hint": lambda s: _edit(s, HINT,
                                       "cp.async.cg.shared.global"),
    "4 stages": lambda s: _edit(s, STAGES,
                                "static constexpr int kStages = 4;"),
    "256-element stages, 2 stages": lambda s: _edit(
        _edit(s, STAGE_K, "constexpr int kK = 256; "), STAGES,
        "static constexpr int kStages = 2;"),
}
STAGE_ELEMENTS = {"256-element stages, 2 stages": 256}


def build():
    """{variant: library path}, every nvcc started at once."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    os.makedirs(OUT, exist_ok=True)
    src = open(SRC_PATH).read()
    procs = {}
    for i, (name, edit) in enumerate(VARIANTS.items()):
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


def use(lib_path):
    from repro_torch.kernels import w4_matmul as w4
    fn = ctypes.CDLL(lib_path).w4_matmul_tc_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    w4._tc_launcher = lambda: fn


def main() -> int:
    import torch
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.core.quant import QuantConfig, dequantize, unpack_int4
    from repro_torch.kernels import w4_matmul as w4
    from repro_torch.kernels.build import sm_count
    if not torch.cuda.is_available():
        print("w4_variants: no CUDA device", file=sys.stderr)
        return 1
    print(f"[device] {torch.cuda.get_device_name(0)}", flush=True)
    libs = build()
    timer = cs.Timer()
    g = torch.Generator(device="cuda").manual_seed(3)
    packed = {label: cs._w4_packed(n, k, 4)
              for label, (n, k) in cs.SHAPES.items()}
    xs = {(label, t): torch.randn((t, k), generator=g, device="cuda",
                                  dtype=torch.bfloat16)
          for label, (n, k) in cs.SHAPES.items() for t in (4, 64)}

    def splits(name, t, n, k):
        step = STAGE_ELEMENTS.get(name, w4.TC_K)
        return min(k // step, w4.split_count(t, n, k, sm_count(0)))

    def layer(tm, name, t, fn=None):
        total, parts = 0.0, []
        for label, (n, k) in cs.SHAPES.items():
            p, x = packed[label], xs[(label, t)]
            s = splits(name, t, n, k)
            call = fn(label, x) if fn else (
                lambda: w4.w4_matmul_cuda(x, p["qw"], p["scale"],
                                          p["zero"], 16, n_split=s))
            ms = tm.ms(call, iters=100)
            total += cs.PER_LAYER[label] * ms
            parts.append(f"{label} {ms * 1e3:.2f}")
        return total * 1e3, "; ".join(parts)

    for name, lib in libs.items():
        use(lib)
        for t in (4, 64):
            us, parts = layer(timer, name, t)
            print(f"VARIANT {name} T={t}: layer {us:.2f}us ({parts})",
                  flush=True)
    use(libs["as built"])
    for label, (n, k) in cs.SHAPES.items():
        p, x = packed[label], xs[(label, 4)]
        row = []
        for s in (2, 3, 4, 6, 8):
            ms = timer.ms(lambda: w4.w4_matmul_cuda(
                x, p["qw"], p["scale"], p["zero"], 16, n_split=s), iters=100)
            row.append(f"S={s} {ms * 1e3:.2f}")
        print(f"SPLITS {label} T=4 (chosen S={splits('', 4, n, k)}): "
              + "; ".join(row), flush=True)

    class ReadFlush(cs.Timer):
        """The 1 GiB flush as a read: L2 holds only clean lines after it."""

        def ms(self, fn, iters=30, warmup=3):
            for _ in range(warmup):
                fn()
            torch.cuda.synchronize()
            start = [torch.cuda.Event(enable_timing=True)
                     for _ in range(iters)]
            end = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
            for i in range(iters):
                self.sink = self.flush.view(torch.int32).sum()
                start[i].record()
                fn()
                end[i].record()
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in zip(start, end)) / iters

    dense = {label: dequantize(unpack_int4(p["qw"]), p["scale"], p["zero"],
                               QuantConfig(group_size=16), torch.bfloat16)
             for label, p in packed.items()}
    for tname, tm in (("write", timer), ("read", ReadFlush())):
        us, parts = layer(tm, "as built", 4)
        print(f"FLUSH {tname} w4_matmul T=4: layer {us:.2f}us ({parts})",
              flush=True)
        us, parts = layer(tm, "", 4, lambda label, x: (
            lambda: torch.matmul(x, dense[label].T)))
        print(f"FLUSH {tname} torch.matmul T=4: layer {us:.2f}us ({parts})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
