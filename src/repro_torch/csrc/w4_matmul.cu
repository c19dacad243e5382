// Dense grouped-dequant W4 matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/w4_matmul.py:w4_matmul_pallas,
// which every projection of the dense-W4 baseline (--compress w4) reaches
// in prefill and decode.
//
//   y[t, n] = sum_k x[t, k] * ((q[n, k] - zero[n, k/G]) * scale[n, k/G])
//
// Layouts: x [T, K] f32 or bf16; qw [N, K/2] uint8, two 4-bit codes per
// byte, element 2i in the low nibble; scale, zero [N, K/G] f32; y [T, N]
// f32. G is even and divides K.
//
// Bound on the card: bytes. At decode (T = 4 slots) every code byte and
// every f32 scale/zero is used for T multiply-adds, far below the H100's
// flop/byte balance, so the floor is (N*K/2 + 8*N*K/G + x + y) bytes over
// 3.35 TB/s (wq of llama2-7b at G16: 16.9 MB -> 5.0 us).
//
// Design: a block of 8 warps owns 32 output rows (one per lane) and a
// tile of BT <= 8 rows of x, and walks K in chunks of 512 elements. For
// each chunk the block stages x[tile, chunk] in shared memory as f32
// (zeros past T and past K), and each warp takes 64 elements of it: every
// lane holds its row's 32 code bytes (two 16-byte loads), dequantises
// them in registers with their group's scale and zero as (q - z) * s, the
// reference's order, and accumulates BT dot products in f32 registers
// against x read from shared memory as broadcasts (the lanes of a warp
// share k). The next chunk's codes and first scale/zero are loaded into
// registers before the current chunk is computed, so two chunks' code
// loads are in flight (the early scale/zero load also brings a slice's
// G16 groups into L1). Each weight byte is read once per tile of 8 x
// rows, so decode reads the weights once. The warps' partial sums are
// added in shared memory at the end. Ragged edges are masked here, not
// padded by the caller: rows past N skip their loads and stores, rows
// past T are zero in shared memory and are not stored, and a K that is
// not a multiple of 64 (or a misaligned qw) takes a byte-load path
// bounded per element. Tensor cores (wgmma on bf16-dequantised tiles),
// TMA and Stream-K are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 32;                  // output rows per block (lanes)
constexpr int kSlice = 64;                 // K elements per warp per chunk
constexpr int kChunk = kWarps * kSlice;    // K elements per block per chunk

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The 32 code bytes of elements k .. k+63 of one row, as two 16-byte
// vectors (zeros where `ok` is false; the byte path zeroes past K).
template <bool kVec>
__device__ __forceinline__ void load_codes(const uint8_t* __restrict__ row,
                                           int k, int K, bool ok,
                                           uint4 c[2]) {
  if (!ok) {
    c[0] = c[1] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  if constexpr (kVec) {
    const uint4* p = reinterpret_cast<const uint4*>(row + k / 2);
    c[0] = __ldg(p);
    c[1] = __ldg(p + 1);
  } else {
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (k + 2 * i < K)
        w[i >> 2] |= static_cast<uint32_t>(__ldg(row + k / 2 + i))
                     << (8 * (i & 3));
    c[0] = make_uint4(w[0], w[1], w[2], w[3]);
    c[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

__device__ __forceinline__ uint32_t word_of(const uint4 c[2], int i) {
  const uint4 u = c[i >> 2];
  switch (i & 3) {
    case 0: return u.x;
    case 1: return u.y;
    case 2: return u.z;
    default: return u.w;
  }
}

template <typename T, int BT, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
w4_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ qw,
                 const float* __restrict__ scale,
                 const float* __restrict__ zero, float* __restrict__ y,
                 int Trows, int N, int K, int G) {
  __shared__ __align__(16) float xs[BT][kChunk];
  __shared__ float part[kWarps][BT][kRows];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = blockIdx.x * kRows + lane;
  const int t0 = blockIdx.y * BT;
  const int rows = min(BT, Trows - t0);
  const bool row_ok = n < N;
  const int NG = K / G;
  const uint8_t* qrow = qw + static_cast<size_t>(row_ok ? n : 0) * (K / 2);
  const float* srow = scale + static_cast<size_t>(row_ok ? n : 0) * NG;
  const float* zrow = zero + static_cast<size_t>(row_ok ? n : 0) * NG;

  float acc[BT];
#pragma unroll
  for (int t = 0; t < BT; ++t) acc[t] = 0.f;

  uint4 cur[2], nxt[2];
  float s_cur = 0.f, z_cur = 0.f, s_nxt = 0.f, z_nxt = 0.f;
  {
    const int k = warp * kSlice;
    const bool ok = row_ok && k < K;
    load_codes<kVec>(qrow, k, K, ok, cur);
    if (ok) {
      s_cur = __ldg(srow + k / G);
      z_cur = __ldg(zrow + k / G);
    }
  }

  for (int kc = 0; kc < K; kc += kChunk) {
    const int k = kc + warp * kSlice;
    // the next chunk's codes (and first scale/zero) go in flight first
    const int kn = k + kChunk;
    const bool ok_n = row_ok && kn < K;
    load_codes<kVec>(qrow, kn, K, ok_n, nxt);
    if (ok_n) {
      s_nxt = __ldg(srow + kn / G);
      z_nxt = __ldg(zrow + kn / G);
    }
    // stage x[t0 .. t0+BT, kc .. kc+kChunk] as f32, zeros outside
    for (int e = tid; e < BT * kChunk; e += kWarps * 32) {
      const int t = e / kChunk;
      const int kk = e - t * kChunk;
      xs[t][kk] = (t < rows && kc + kk < K)
          ? to_float(x[static_cast<size_t>(t0 + t) * K + kc + kk]) : 0.f;
    }
    __syncthreads();

    if (row_ok && k < K) {
      int g = k / G;
      int next = (g + 1) * G;       // first element of the next group
      float s = s_cur, z = z_cur;
      const float* xw = &xs[0][warp * kSlice];
#pragma unroll
      for (int wi = 0; wi < 8; ++wi) {   // 8 codes per 32-bit word
        const uint32_t word = word_of(cur, wi);
        float wv[8];
#pragma unroll
        for (int p = 0; p < 4; ++p) {    // one byte = two elements
          const int e = k + 8 * wi + 2 * p;
          if (e >= next) {               // warp-uniform: lanes share k
            ++g;
            next += G;
            if (e < K) {
              s = __ldg(srow + g);
              z = __ldg(zrow + g);
            }
          }
          const uint32_t byte = (word >> (8 * p)) & 0xFFu;
          wv[2 * p] = (static_cast<float>(byte & 0xFu) - z) * s;
          wv[2 * p + 1] = (static_cast<float>(byte >> 4) - z) * s;
        }
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          const float4 xa =
              *reinterpret_cast<const float4*>(xw + t * kChunk + 8 * wi);
          const float4 xb =
              *reinterpret_cast<const float4*>(xw + t * kChunk + 8 * wi + 4);
          float a = acc[t];
          a = fmaf(wv[0], xa.x, a);
          a = fmaf(wv[1], xa.y, a);
          a = fmaf(wv[2], xa.z, a);
          a = fmaf(wv[3], xa.w, a);
          a = fmaf(wv[4], xb.x, a);
          a = fmaf(wv[5], xb.y, a);
          a = fmaf(wv[6], xb.z, a);
          a = fmaf(wv[7], xb.w, a);
          acc[t] = a;
        }
      }
    }
    __syncthreads();                     // the next chunk overwrites xs
    cur[0] = nxt[0];
    cur[1] = nxt[1];
    s_cur = s_nxt;
    z_cur = z_nxt;
  }

#pragma unroll
  for (int t = 0; t < BT; ++t) part[warp][t][lane] = acc[t];
  __syncthreads();
  for (int e = tid; e < BT * kRows; e += kWarps * 32) {
    const int t = e / kRows;
    const int l = e - t * kRows;
    const int nn = blockIdx.x * kRows + l;
    if (t < rows && nn < N) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += part[w][t][l];
      y[static_cast<size_t>(t0 + t) * N + nn] = sum;
    }
  }
}

template <typename T, int BT, bool kVec>
void launch(const void* x, const void* qw, const void* scale,
            const void* zero, void* y, int Trows, int N, int K, int G,
            cudaStream_t stream) {
  const dim3 grid((N + kRows - 1) / kRows, (Trows + BT - 1) / BT);
  w4_matmul_kernel<T, BT, kVec><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(qw),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<float*>(y), Trows, N, K, G);
}

template <typename T, bool kVec>
void dispatch(const void* x, const void* qw, const void* scale,
              const void* zero, void* y, int Trows, int N, int K, int G,
              cudaStream_t s) {
  // the x tile: the smallest power of two >= T, at most 8 rows
  if (Trows <= 1)
    launch<T, 1, kVec>(x, qw, scale, zero, y, Trows, N, K, G, s);
  else if (Trows <= 2)
    launch<T, 2, kVec>(x, qw, scale, zero, y, Trows, N, K, G, s);
  else if (Trows <= 4)
    launch<T, 4, kVec>(x, qw, scale, zero, y, Trows, N, K, G, s);
  else
    launch<T, 8, kVec>(x, qw, scale, zero, y, Trows, N, K, G, s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// `vec`: K % 64 == 0 and qw 16-byte aligned (the 16-byte code loads).
extern "C" int w4_matmul_launch(const void* x, int x_is_bf16, const void* qw,
                                const void* scale, const void* zero, void* y,
                                int T, int N, int K, int G, int vec,
                                void* stream) {
  if (T < 1 || N < 1 || K < 2 || G < 2 || G % 2 != 0 || K % G != 0
      || (vec && K % kSlice != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    if (vec)
      dispatch<__nv_bfloat16, true>(x, qw, scale, zero, y, T, N, K, G, s);
    else
      dispatch<__nv_bfloat16, false>(x, qw, scale, zero, y, T, N, K, G, s);
  } else {
    if (vec)
      dispatch<float, true>(x, qw, scale, zero, y, T, N, K, G, s);
    else
      dispatch<float, false>(x, qw, scale, zero, y, T, N, K, G, s);
  }
  return static_cast<int>(cudaGetLastError());
}
