// GQSA sparse-quantized GEMV for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gqsa_gemv.py:gqsa_gemv_pallas.
//
//   y[b, n] = sum_m sum_j ((q[n,m,j] - zero[n,m]) * scale[n,m])
//                         * x[b, idx[n,m]*16 + j]
//
// for B <= 8 activation rows. Layouts (the padded BSR form of
// src/repro_torch/core/bsr.py): x [B, K] f32 or bf16; idx [N, M] int32
// (-1 = padding); vals [N, M, 8] uint8, two 4-bit codes per byte, element
// 2i in the low nibble; scale, zero [N, M] f32 (scale 0 on padding);
// y [B, N] f32. Group size 16.
//
// Bound on the card: bytes. Each kept group streams 20 bytes of payload
// (8 code bytes, idx, scale, zero) for 16 * B multiply-adds, far below
// the H100's ~20 flop/byte f32 balance, so the floor is the payload over
// 3.35 TB/s (4.05 GB per llama2-7b decode step -> 1.21 ms).
//
// Design: one warp per output row, its 32 lanes splitting the row's M
// groups. Consecutive lanes take consecutive groups, so the 8-byte code
// loads (one 64-bit load per group) and the idx/scale/zero loads are
// coalesced across the warp. The codes are unpacked and dequantised in
// registers and reused for all B activation rows; x is gathered through
// the read-only cache (it is at most 8 x 11008 x 4 = 352 KB, more than a
// block's shared memory, and stays resident in L2/L1). A butterfly
// shuffle leaves every row sum in every lane, and lane b writes y[b, n].
// The kernel pads nothing: the ragged edge of N is a warp-uniform exit,
// ragged M a lane loop bound. The work list of the Stream-K design (paper
// §3.5) is not read: every row of a row-balanced packing has the same M.
//
// Expert axis (gqsa_gemv_experts_launch): the routed experts of an MoE
// layer, which the reference runs as a vmap of the same Pallas kernel
// over its stacked weights (src/repro/models/moe.py:_expert_ffn). Grid
// axis y is the expert: leaves [E, N, M] (idx, scale, zero) and
// [E, N, M, 8] (vals), x [E, C, K], y [E, C, N] f32, one launch per
// chunk of <= 8 of the C buffer rows. An optional rows [E] int32 says how
// many leading buffer rows of each expert hold tokens: the kernel writes
// zeros for rows >= rows[e], and a block whose expert holds none writes
// its zeros and returns without reading that expert's weights. At 4-slot
// DeepSeek-V2 decode (24 routed entries, capacity 1) at most 24 of the
// 160 experts hold a row, so a layer's three expert projections stream
// at most 24 experts' payload (14.7 MB each) instead of all 160
// (2.36 GB). The reference computes every expert on its zero rows; those
// products are masked by its keep mask, so the skip changes no number.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 16;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void load_group(const float* p, float o[kGroup]) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = __ldg(v + i);
    o[4 * i] = f.x;
    o[4 * i + 1] = f.y;
    o[4 * i + 2] = f.z;
    o[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load_group(const __nv_bfloat16* p,
                                           float o[kGroup]) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = __ldg(v + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      o[8 * i + 2 * j] = f.x;
      o[8 * i + 2 * j + 1] = f.y;
    }
  }
}

// One matrix (kExperts false: the offsets below are not computed, so the
// single-matrix path is the code it was before the expert axis), or one
// chunk of the expert axis: blockIdx.y is the expert, whose x rows start
// at x + e * x_stride, its y rows at y + e * y_stride and its weights at
// e * N * M; rows[e] - c0 of this chunk's B rows hold tokens (all B when
// rows is null).
template <typename T, int B, bool kExperts>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gqsa_gemv_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                 const uint2* __restrict__ vals,
                 const float* __restrict__ scale,
                 const float* __restrict__ zero, float* __restrict__ y,
                 int N, int M, int K, size_t x_stride, size_t y_stride,
                 const int32_t* __restrict__ rows, int c0) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;  // warp-uniform: the ragged edge of N
  int nrows = B;
  if (kExperts) {
    const int e = blockIdx.y;
    if (rows != nullptr) nrows = min(max(rows[e] - c0, 0), B);
    x += e * x_stride;
    y += e * y_stride;
    if (nrows == 0) {  // an idle expert: zeros, and no weight is read
      if (lane < B) y[static_cast<size_t>(lane) * N + row] = 0.f;
      return;
    }
    const size_t eoff = static_cast<size_t>(e) * N * M;
    idx += eoff;
    vals += eoff;
    scale += eoff;
    zero += eoff;
  }

  float acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = 0.f;

  const size_t base = static_cast<size_t>(row) * M;
  for (int m = lane; m < M; m += 32) {
    // padding slots carry idx -1: read group 0 instead (their scale is 0,
    // so they add nothing), as the TPU kernel's clamp does
    const int col = max(__ldg(idx + base + m), 0);
    const float s = __ldg(scale + base + m);
    const float z = __ldg(zero + base + m);
    const uint2 packed = __ldg(vals + base + m);
    float w[kGroup];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t byte = ((i < 4 ? packed.x : packed.y) >> (8 * (i & 3)))
                            & 0xFFu;
      w[2 * i] = (static_cast<float>(byte & 0xFu) - z) * s;
      w[2 * i + 1] = (static_cast<float>(byte >> 4) - z) * s;
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float xv[kGroup];
      load_group(x + static_cast<size_t>(b) * K
                   + static_cast<size_t>(col) * kGroup, xv);
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) d = fmaf(w[j], xv[j], d);
      acc[b] += d;
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
  }
  // rows past nrows hold no token: their products are computed (x has
  // them) but written as zeros
#pragma unroll
  for (int b = 0; b < B; ++b)
    if (lane == b) y[static_cast<size_t>(b) * N + row] = b < nrows ? acc[b]
                                                                   : 0.f;
}

struct Args {
  const void *x, *idx, *vals, *scale, *zero;
  void* y;
  int N, M, K, E;
  size_t x_stride, y_stride;
  const int32_t* rows;
  int c0;
  bool experts;  // the expert axis (else one matrix)
};

template <typename T, int B>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.N + kWarpsPerBlock - 1) / kWarpsPerBlock, a.E);
  auto kernel = a.experts ? gqsa_gemv_kernel<T, B, true>
                          : gqsa_gemv_kernel<T, B, false>;
  kernel<<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const int32_t*>(a.idx),
      static_cast<const uint2*>(a.vals), static_cast<const float*>(a.scale),
      static_cast<const float*>(a.zero), static_cast<float*>(a.y), a.N, a.M,
      a.K, a.x_stride, a.y_stride, a.rows, a.c0);
}

template <typename T>
int dispatch(const Args& a, int B, cudaStream_t s) {
  switch (B) {
    case 1: launch<T, 1>(a, s); break;
    case 2: launch<T, 2>(a, s); break;
    case 3: launch<T, 3>(a, s); break;
    case 4: launch<T, 4>(a, s); break;
    case 5: launch<T, 5>(a, s); break;
    case 6: launch<T, 6>(a, s); break;
    case 7: launch<T, 7>(a, s); break;
    case 8: launch<T, 8>(a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int run(const Args& a, int x_is_bf16, int B, void* stream) {
  if (a.E < 1 || a.E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? dispatch<__nv_bfloat16>(a, B, s)
                   : dispatch<float>(a, B, s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int gqsa_gemv_launch(const void* x, int x_is_bf16,
                                const void* idx, const void* vals,
                                const void* scale, const void* zero, void* y,
                                int B, int N, int M, int K, void* stream) {
  const Args a{x, idx, vals, scale, zero, y, N, M, K, 1, 0, 0, nullptr, 0,
               false};
  return run(a, x_is_bf16, B, stream);
}

// The expert axis: x [E, C, K], y [E, C, N], stacked leaves [E, N, M(, 8)];
// this launch covers buffer rows c0 .. c0 + B - 1 (B <= 8) of every
// expert. rows [E] int32 or null (every row holds a token).
extern "C" int gqsa_gemv_experts_launch(const void* x, int x_is_bf16,
                                        const void* idx, const void* vals,
                                        const void* scale, const void* zero,
                                        void* y, const void* rows, int E,
                                        int C, int c0, int B, int N, int M,
                                        int K, void* stream) {
  if (c0 < 0 || B < 1 || c0 + B > C)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t esz = x_is_bf16 ? 2 : 4;
  const Args a{static_cast<const char*>(x) + esz * c0 * K, idx, vals, scale,
               zero, static_cast<float*>(y) + static_cast<size_t>(c0) * N,
               N, M, K, E, static_cast<size_t>(C) * K,
               static_cast<size_t>(C) * N,
               static_cast<const int32_t*>(rows), c0, true};
  return run(a, x_is_bf16, B, stream);
}
