"""What held ``kv_decode_attention`` back on the paged kernel's int8 mode:
scratch variants of ``src/repro_torch/csrc/paged_attention.cu``, timed in
one process on one card beside the contiguous-cache kernel
(``csrc/kv_decode_attention.cu``).

    python3 scripts/attention_variants.py

Each variant is the paged source with one edit, built by ``nvcc`` under
``build/attention_variants/``:
  * as built;
  * no I2F: int8 codes become f32 by a byte permute into 0x4B0000xx
    (2^23 + 128 + code) and one subtraction, in the score loop and in P.V;
  * all warps score: at one query row a block, each of the block's four
    warps scores a quarter of D and warp 0 sums the four in shared memory
    (as built, only warp 0 scores);
  * both edits.
For each, ``cuobjdump -sass`` counts the I2F instructions of the int8
instantiations, and the int8 page walk is timed over the contiguous
cache viewed as pages of 64 under identity tables (the route of the
parent), at 4 slots x 32 KV heads, R = 1, D = 128, full lengths 32768
and 4096, at 2 splits (the split count that route took) and at 4
(``chip_smoke.Timer``: L2 flushed before every launch). Then
``ops.kv_decode_attention`` of the checkout at the same shapes, and SDPA
on K/V dequantized to bf16 beforehand. Prints ``VARIANT``, ``SASS`` and
``KERNEL`` lines.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

SRC_PATH = os.path.join(ROOT, "src/repro_torch/csrc/paged_attention.cu")
OUT = os.path.join(ROOT, "build/attention_variants")
LENGTHS = (32768, 4096)
SPLITS = (2, 4)

UNPACK = """\
__device__ __forceinline__ void unpack16(const uint4& u, float* o, int8_t) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    o[i] = static_cast<float>(
        static_cast<int8_t>((w[i >> 2] >> (8 * (i & 3))) & 0xFFu));
}
"""
UNPACK_PRMT = """\
__device__ __forceinline__ void unpack16(const uint4& u, float* o, int8_t) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                         u.z ^ 0x80808080u, u.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    o[i] = __uint_as_float(__byte_perm(w[i >> 2], 0x4B000000u,
                                       0x7650 + (i & 3))) - 8388736.f;
}
"""
PAIR = """\
__device__ __forceinline__ float2 load_pair(const unsigned char* p, int8_t) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}
"""
PAIR_PRMT = """\
__device__ __forceinline__ float2 load_pair(const unsigned char* p, int8_t) {
  const uint32_t w =
      static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) ^ 0x8080u;
  return make_float2(
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650)) - 8388736.f,
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7651)) - 8388736.f);
}
"""
D_LOOP = "      for (int d0 = 0; d0 < D; d0 += E) {\n"
D_LOOP_SLICE = ("      const int dw = nr == 1 ? D / nwarps : D;\n"
                "      const int da = nr == 1 ? warp * dw : 0;\n"
                "      for (int d0 = da; d0 < da + dw; d0 += E) {\n")
SCORE = """\
    if (warp < nr) {            // warp-uniform: the warp owns a row
      if (npos > 32)
        dots(Lanes<2>());
      else
        dots(Lanes<1>());
    }
"""
SCORE_ALL = """\
    if (warp < nr || nr == 1) {
      if (npos > 32)
        dots(Lanes<2>());
      else
        dots(Lanes<1>());
    }
    if (nr == 1) {              // every warp scored a slice of D
      __shared__ float red_s[8][2][32];
      red_s[warp][0][lane] = sc[0][0];
      red_s[warp][1][lane] = sc[0][1];
      __syncthreads();
      if (warp == 0) {
        float x0 = 0.f, x1 = 0.f;
        for (int w = 0; w < nwarps; ++w) {
          x0 += red_s[w][0][lane];
          x1 += red_s[w][1][lane];
        }
        sc[0][0] = x0;
        sc[0][1] = x1;
      }
    }
"""


def _edit(src, old, new):
    if old not in src:
        raise RuntimeError(f"the source no longer holds {old!r}")
    return src.replace(old, new)


def _no_i2f(s):
    return _edit(_edit(s, UNPACK, UNPACK_PRMT), PAIR, PAIR_PRMT)


def _all_warps(s):
    return _edit(_edit(s, D_LOOP, D_LOOP_SLICE), SCORE, SCORE_ALL)


VARIANTS = {
    "as built": lambda s: s,
    "no I2F": _no_i2f,
    "all warps score": _all_warps,
    "no I2F, all warps score": lambda s: _all_warps(_no_i2f(s)),
}


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


def sass_counts(lib, pattern):
    """{kernel: (I2F count, I2FP count, instruction count)} of the kernels
    in ``lib`` whose mangled name matches ``pattern`` (I2F: the
    conversion unit's int-to-float; I2FP: the ALU's)."""
    from repro_torch.kernels.build import nvcc_path
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if re.search(pattern, m.group(1)) else None
            if name:
                out[name] = [0, 0, 0]
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            out[name][2] += 1
            out[name][0] += bool(re.search(r"\bI2F\b", line))
            out[name][1] += bool(re.search(r"\bI2FP\b", line))
    return out


def page_walk(lib_path, q, k8, ks, v8, vs):
    """``call(n_split)``: the variant's int8 page walk over the contiguous
    cache viewed as pages of 64 under identity tables, full lengths (the
    operands made once, outside the timed call)."""
    import torch
    from repro_torch.kernels.paged_attention import (LAUNCH_ARGTYPES,
                                                     workspace_floats)
    fn = ctypes.CDLL(lib_path).paged_attention_launch
    fn.argtypes = LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    b, s, kh, d = k8.shape
    ps = 64
    n = b * s // ps
    tables = torch.arange(n, dtype=torch.int32,
                          device="cuda").reshape(b, s // ps)
    lq = torch.full((b, 1), s, dtype=torch.int32, device="cuda")
    live = torch.full((b,), s // ps, dtype=torch.int32, device="cuda")
    out = torch.empty((b, kh, 1, d), dtype=torch.float32, device="cuda")
    work = torch.empty(workspace_floats(b, kh, 1, d, max(SPLITS)),
                       dtype=torch.float32, device="cuda")

    def call(n_split):
        rc = fn(q.data_ptr(), k8.data_ptr(), v8.data_ptr(), 2,
                ks.data_ptr(), vs.data_ptr(), lq.data_ptr(),
                tables.data_ptr(), live.data_ptr(), None, None, 0,
                out.data_ptr(), b, kh, 1, 1, d, d, n, ps, s // ps,
                work.data_ptr(), n_split,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out
    return call


def main() -> int:
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import build_all, library_path
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    libs = build()
    build_all(["kv_decode_attention"])
    new_lib = str(library_path("kv_decode_attention"))
    for name, lib, pattern in [
            *((n, lib, r"split_kernelIaLi4E") for n, lib in libs.items()),
            ("kv_decode_attention.cu", new_lib, r"split_kernelILi1ELi128E")]:
        for kern, (i2f, i2fp, n) in sass_counts(lib, pattern).items():
            print(f"SASS {name}: {kern} I2F {i2f}, I2FP {i2fp} of {n} "
                  f"instructions", flush=True)
    timer = cs.Timer()
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 19)
    for s in LENGTHS:
        q, k8, ks, v8, vs = cs._kv_cache_case(g, s)
        calls = {name: page_walk(lib, q, k8, ks, v8, vs)
                 for name, lib in libs.items()}
        ln = torch.tensor(s, dtype=torch.int32, device="cuda")
        ref = ops.kv_decode_attention(q, k8, ks, v8, vs, ln, plain=True)
        nbytes = 2 * k8.numel() + 2 * 4 * ks.numel()
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e6
        for name, call in calls.items():
            for n_split in SPLITS:
                o = call(n_split).clone()
                rel = ((o - ref).abs().max() / ref.abs().max()).item()
                if not rel <= cs.TOL:
                    raise AssertionError(f"{name} S={n_split}: rel {rel}")
                us = timer.ms(lambda: call(n_split), iters=50) * 1e3
                print(f"VARIANT {name} | 4 x {s} S={n_split}: {us:.1f}us "
                      f"(bound {bound:.1f}us, {bound / us:.0%}; rel "
                      f"{rel:.1e})", flush=True)
        o = ops.kv_decode_attention(q, k8, ks, v8, vs, ln)
        rel = ((o - ref).abs().max() / ref.abs().max()).item()
        us = timer.ms(lambda: ops.kv_decode_attention(q, k8, ks, v8, vs, ln),
                      iters=50) * 1e3
        kk, vv = ((c.float() * sc[..., None]).to(torch.bfloat16)
                  .permute(0, 2, 1, 3).contiguous()
                  for c, sc in ((k8, ks), (v8, vs)))
        qs = q.to(torch.bfloat16)
        sd = timer.ms(lambda: F.scaled_dot_product_attention(qs, kk, vv),
                      iters=50) * 1e3
        print(f"KERNEL kv_decode_attention.cu | 4 x {s}: {us:.1f}us (bound "
              f"{bound:.1f}us, {bound / us:.0%}; rel {rel:.1e}); sdpa "
              f"{sd:.1f}us", flush=True)
        del q, k8, ks, v8, vs, kk, vv, qs, ref, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
