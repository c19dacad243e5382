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

template <typename T, int B>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gqsa_gemv_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
                 const uint2* __restrict__ vals,
                 const float* __restrict__ scale,
                 const float* __restrict__ zero, float* __restrict__ y,
                 int N, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;  // warp-uniform: the ragged edge of N

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
#pragma unroll
  for (int b = 0; b < B; ++b)
    if (lane == b) y[static_cast<size_t>(b) * N + row] = acc[b];
}

template <typename T, int B>
void launch(const void* x, const void* idx, const void* vals,
            const void* scale, const void* zero, void* y, int N, int M,
            int K, cudaStream_t stream) {
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
  gqsa_gemv_kernel<T, B><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(idx),
      static_cast<const uint2*>(vals), static_cast<const float*>(scale),
      static_cast<const float*>(zero), static_cast<float*>(y), N, M, K);
}

template <typename T>
int dispatch(const void* x, const void* idx, const void* vals,
             const void* scale, const void* zero, void* y, int B, int N,
             int M, int K, cudaStream_t s) {
  switch (B) {
    case 1: launch<T, 1>(x, idx, vals, scale, zero, y, N, M, K, s); break;
    case 2: launch<T, 2>(x, idx, vals, scale, zero, y, N, M, K, s); break;
    case 3: launch<T, 3>(x, idx, vals, scale, zero, y, N, M, K, s); break;
    case 4: launch<T, 4>(x, idx, vals, scale, zero, y, N, M, K, s); break;
    case 5: launch<T, 5>(x, idx, vals, scale, zero, y, N, M, K, s); break;
    case 6: launch<T, 6>(x, idx, vals, scale, zero, y, N, M, K, s); break;
    case 7: launch<T, 7>(x, idx, vals, scale, zero, y, N, M, K, s); break;
    case 8: launch<T, 8>(x, idx, vals, scale, zero, y, N, M, K, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int gqsa_gemv_launch(const void* x, int x_is_bf16,
                                const void* idx, const void* vals,
                                const void* scale, const void* zero, void* y,
                                int B, int N, int M, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return dispatch<__nv_bfloat16>(x, idx, vals, scale, zero, y, B, N, M, K,
                                   s);
  return dispatch<float>(x, idx, vals, scale, zero, y, B, N, M, K, s);
}
