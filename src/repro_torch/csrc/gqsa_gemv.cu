// GQSA sparse-quantized GEMV / skinny GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gqsa_gemv.py:gqsa_gemv_pallas.
//
//   y[t, n] = sum_m sum_j ((q[n,m,j] - zero[n,m]) * scale[n,m])
//                         * x[t, idx[n,m]*16 + j]
//
// Layouts (the padded BSR form of src/repro_torch/core/bsr.py): x [T, K]
// f32 or bf16; idx [N, M] int32 (-1 = padding); vals [N, M, 8] uint8, two
// 4-bit codes per byte, element 2i in the low nibble; scale, zero [N, M]
// f32 (scale 0 on padding); y [T, N] f32. Group size 16.
//
// Bound on the card (H100 SXM): bytes at every T the model sends. Each
// kept group streams 20 bytes of payload (8 code bytes, idx, scale, zero)
// for 16 * T multiply-adds of bf16 x and exact 4-bit codes, which the
// card's tensor cores take at 989 TFLOP/s; the bytes over 3.35 TB/s stay
// the larger time up to T of about 280 (4.05 GB per llama2-7b decode
// step -> 1.21 ms; a llama2-7b layer: 38 us at T = 4, 46 us at T = 116).
// The design below runs on CUDA cores (f32, 67 TFLOP/s, 350 us a layer
// of multiply-adds alone at T = 116) and is bound by that arithmetic at
// every T: about 41 instructions a kept group and x row (16 bf16
// widenings, 16 multiply-adds, two 16-byte reads, the zero fold), so it
// stays far above the byte floor (PERF.md); tensor cores on a densified
// stage are the next step (ROADMAP.md B.3).
//
// Design (gqsa_gemv_launch, any T in one launch): one block of 16 warps
// per SM, each block on one token tile of TT <= 8 x rows.
//  * x out of the dependent chain: the block stages its tile of x once,
//    with cp.async, in shared memory as [K/16 groups][TT tokens][16], and
//    the group sums of x beside it ([K/16][TT] f32), so a group's gather
//    is one line of TT * 16 values. Lanes read a line in 16-byte chunks;
//    lane l starts at token (l & 7) / P and takes a token's P chunks in
//    the order part ^ (l % P) (P = 2 chunks a token in bf16, 4 in f32),
//    so the 8 lanes of each quarter warp hit 8 distinct 16-byte bank
//    groups whatever the columns: no bank conflict once a line is 128
//    bytes or more (bf16 TT >= 4, f32 TT >= 2); below that, at most the
//    columns' collisions of one or two lines, where bytes dominate.
//  * The payload streams: a warp owns whole rows (rows g, g + W, ... of
//    its tile's W warps), its lanes take slots m = 32 p + lane, so a
//    warp's copy of a field is 128 consecutive bytes. Each lane copies its
//    own slot's idx, scale, zero and codes with cp.async into its warp's
//    ring of kDepth = 3 stages (640 bytes a stage), two slots ahead of the
//    arithmetic. An 8-stage ring was slower at decode (PERF.md,
//    scripts/gemv_variants.py), since the kernel is bound by its
//    arithmetic and a deeper prologue delays the x tile behind the
//    payload's requests. The kernel reads the depth from its arguments,
//    not as a constant: a compile-time depth was slower at 8 rows and
//    more (ptxas schedules the loop differently).
//  * The zero folds out: acc += s * sum_j q_j x_j - (s z) * sum_j x_j, on
//    the raw codes (a nibble becomes the exact float by a byte permute and
//    one subtract), per group; the codes are converted once and used for
//    the TT tokens of the tile.
//  * Any T: ceil(T / TT) tiles, each on its own blocks (one wave up to
//    132 tiles). The blocks of every tile read all the weights; they run
//    at the same time, so a byte comes from device memory once and from
//    L2 for the other tiles.
// Fixed order, no atomics: a row's sums are one lane's slots in order, the
// P chunks of a group added pairwise (the same for every rotation), and a
// butterfly across the warp; the result of a (row, token) depends on
// neither the tile, the grid nor the other rows of x, so repeats are
// bit-identical. Nothing is read on the host; the wrapper
// (kernels/gqsa_gemv.py) picks TT and the grid from shapes and the SM
// count.
//
// Expert axis (gqsa_gemv_experts_launch): the routed experts of an MoE
// layer, which the reference runs as a vmap of the same Pallas kernel
// over its stacked weights (src/repro/models/moe.py:_expert_ffn), on the
// first design: one warp per output row, its 32 lanes splitting the row's
// M groups, x gathered through the read-only cache, <= 8 x rows a launch.
// Grid axis y is the expert: leaves [E, N, M] (idx, scale, zero) and
// [E, N, M, 8] (vals), x [E, C, K], y [E, C, N] f32, one launch per chunk
// of <= 8 of the C buffer rows. An optional rows [E] int32 says how many
// leading buffer rows of each expert hold tokens: the kernel writes zeros
// for rows >= rows[e], and a block whose expert holds none writes its
// zeros and returns without reading that expert's weights. At 4-slot
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

// One chunk of the expert axis: blockIdx.y is the expert, whose x rows
// start at x + e * x_stride, its y rows at y + e * y_stride and its
// weights at e * N * M; rows[e] - c0 of this chunk's B rows hold tokens
// (all B when rows is null).
template <typename T, int B>
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
};

template <typename T, int B>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.N + kWarpsPerBlock - 1) / kWarpsPerBlock, a.E);
  const auto kernel = gqsa_gemv_kernel<T, B>;
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

namespace streaming {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kDepth = 3;          // stages of each warp's ring
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block, sm_90

// One stage of a warp's ring: the payload of 32 slots, one a lane.
struct Stage {
  int32_t idx[32];
  float scale[32];
  float zero[32];
  uint2 vals[32];
};
// kernels/gqsa_gemv.py:STAGE_BYTES
static_assert(sizeof(Stage) == 640, "a stage is 32 slots of 20 bytes");

struct Args {
  const void* x;
  const int32_t* idx;
  const uint2* vals;
  const float* scale;
  const float* zero;
  float* y;
  int T, N, M, K;
  int n_tiles;   // token tiles: block b takes tile b % n_tiles
  int depth;     // kDepth, read at run time (see the design note)
};

// A group's staged line: TT tokens of 16 values, P 16-byte chunks each.
template <typename T, int TT>
struct Tile {
  static constexpr int kParts = static_cast<int>(sizeof(T));
  static constexpr int kElems = 16 / kParts;          // values a chunk
  static constexpr int kChunks = TT * kParts;         // chunks a line
  static constexpr int kRot = kChunks < 8 ? kChunks : 8;  // lane rotations
};

// Shared memory of a launch: the x tile, its group sums (rounded up to
// 16 bytes), the rings.
__host__ __device__ inline size_t x_bytes(int K, int tt, int elem) {
  return static_cast<size_t>(K / kGroup) * tt * elem * 16;
}

__host__ __device__ inline size_t sum_bytes(int K, int tt) {
  return (static_cast<size_t>(K / kGroup) * tt * 4 + 15) / 16 * 16;
}

inline size_t smem_bytes(int K, int tt, int elem) {
  return x_bytes(K, tt, elem) + sum_bytes(K, tt)
      + static_cast<size_t>(kWarps) * kDepth * sizeof(Stage);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `bytes` of src, zeros for the rest of the copy (0: a token past T)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// wait until at most `depth` - 1 of this thread's groups are in flight;
// `depth` is kDepth (any other value waits for all, which is always safe)
__device__ __forceinline__ void cp_async_wait_ring(int depth) {
  if (depth == kDepth)
    cp_async_wait<kDepth - 1>();
  else
    cp_async_wait<0>();
}

// The 8 codes of w (element 2i in the low nibble of byte i) as exact
// floats: byte permute {code, 0, 0, 0x4B} = 2^23 + code, minus 2^23.
__device__ __forceinline__ void codes8(uint32_t w, float o[8]) {
  const uint32_t even = w & 0x0F0F0F0Fu, odd = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    o[2 * b] = __uint_as_float(__byte_perm(even, 0x4B000000u, 0x7440u | b))
        - 8388608.f;
    o[2 * b + 1] =
        __uint_as_float(__byte_perm(odd, 0x4B000000u, 0x7440u | b))
        - 8388608.f;
  }
}

// One 16-byte chunk of the staged x as f32.
__device__ __forceinline__ void chunk(const __nv_bfloat16* p, float o[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void chunk(const float* p, float o[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  o[0] = f.x;
  o[1] = f.y;
  o[2] = f.z;
  o[3] = f.w;
}

// One kept group against the tile's TT tokens. acc[j] is the lane's sum
// for token (j + u) mod TT; chunk step sp of a token reads part sp ^ v,
// so the codes are permuted to match once for the group.
template <typename T, int TT>
__device__ __forceinline__ void group(uint2 pk, int col, float s, float z,
                                      const uint8_t* xg, const float* xsum,
                                      int u, int v, float (&acc)[TT]) {
  using L = Tile<T, TT>;
  uint32_t lo = pk.x, hi = pk.y;
  if (v & (L::kParts / 2)) {       // whole words: bf16 v = 1, f32 v & 2
    const uint32_t t = lo;
    lo = hi;
    hi = t;
  }
  if (L::kParts == 4 && (v & 1)) {  // f32: the halves of each word
    lo = __byte_perm(lo, 0, 0x1032);
    hi = __byte_perm(hi, 0, 0x1032);
  }
  float w[16];
  codes8(lo, w);
  codes8(hi, w + 8);
  const uint8_t* line = xg + static_cast<size_t>(col) * (L::kChunks * 16);
  const float* xs = xsum + col * TT;
  const float nsz = -(s * z);
#pragma unroll
  for (int j = 0; j < TT; ++j) {
    const int tok = (j + u) & (TT - 1);
    float d[L::kParts];
#pragma unroll
    for (int sp = 0; sp < L::kParts; ++sp) {
      float xv[L::kElems];
      chunk(reinterpret_cast<const T*>(
                line + 16 * (tok * L::kParts + (sp ^ v))), xv);
      float dd = 0.f;
#pragma unroll
      for (int e = 0; e < L::kElems; ++e)
        dd = fmaf(w[sp * L::kElems + e], xv[e], dd);
      d[sp] = dd;
    }
    // pairwise: the same sum for every order part ^ v
    float dsum;
    if constexpr (L::kParts == 2)
      dsum = d[0] + d[1];
    else
      dsum = (d[0] + d[1]) + (d[2] + d[3]);
    acc[j] = fmaf(nsz, xs[tok], fmaf(s, dsum, acc[j]));
  }
}

// A finished row: undo the lane's token rotation, add the warp's lanes
// (a butterfly, the same total in every lane) and write y[t0 + t][row].
template <int TT>
__device__ __forceinline__ void write_row(float (&acc)[TT], float* y,
                                          int row, int t0, int T, int N,
                                          int lane, int u) {
  float r[TT];
#pragma unroll
  for (int t = 0; t < TT; ++t) r[t] = acc[t];
#pragma unroll
  for (int sh = 1; sh < TT; sh <<= 1) {   // r[t] = acc[(t - u) mod TT]
    const bool on = (u & sh) != 0;
    float n[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) n[t] = on ? r[(t - sh) & (TT - 1)] : r[t];
#pragma unroll
    for (int t = 0; t < TT; ++t) r[t] = n[t];
  }
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      r[t] += __shfl_xor_sync(0xffffffffu, r[t], off);
  float out = r[0];
#pragma unroll
  for (int t = 1; t < TT; ++t)
    if (lane == t) out = r[t];
  if (lane < TT && t0 + lane < T)
    y[static_cast<size_t>(t0 + lane) * N + row] = out;
}

template <typename T, int TT>
__global__ void __launch_bounds__(kThreads, 1)
gqsa_gemv_stream_kernel(const Args a) {
  using L = Tile<T, TT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int groups = a.K / kGroup;
  uint8_t* xg = smem;                                  // [groups][TT][16]
  float* xsum = reinterpret_cast<float*>(
      smem + x_bytes(a.K, TT, L::kParts));             // [groups][TT]
  Stage* ring = reinterpret_cast<Stage*>(
      smem + x_bytes(a.K, TT, L::kParts) + sum_bytes(a.K, TT));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = (blockIdx.x % a.n_tiles) * TT;
  const int W = gridDim.x / a.n_tiles * kWarps;        // the tile's warps
  const int g = blockIdx.x / a.n_tiles * kWarps + warp;
  const int trips = (a.M + 31) / 32;
  const int steps = g < a.N ? ((a.N - 1 - g) / W + 1) * trips : 0;
  const int D = a.depth;
  Stage* ring_w = ring + warp * D;

  // the x tile (zeros past T), in the line layout
  {
    const T* x = static_cast<const T*>(a.x);
    for (int p = threadIdx.x; p < groups * L::kChunks; p += kThreads) {
      const int part = p % L::kParts;
      const int t = (p / L::kParts) % TT;
      const int c = p / L::kChunks;
      const bool ok = t0 + t < a.T;
      cp_async16(xg + 16 * p,
                 x + static_cast<size_t>(ok ? t0 + t : 0) * a.K
                   + c * kGroup + part * L::kElems,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  }

  // the ring: each lane copies its own slot of every step
  int ld_row = g, ld_trip = 0, ld_stage = 0;
  auto load_next = [&]() {
    const int m = ld_trip * 32 + lane;
    if (m < a.M) {
      const size_t f = static_cast<size_t>(ld_row) * a.M + m;
      Stage& st = ring_w[ld_stage];
      cp_async4(&st.idx[lane], a.idx + f, 4);
      cp_async4(&st.scale[lane], a.scale + f, 4);
      cp_async4(&st.zero[lane], a.zero + f, 4);
      cp_async8(&st.vals[lane], a.vals + f, 8);
    }
    if (++ld_stage == D) ld_stage = 0;
    if (++ld_trip == trips) {
      ld_trip = 0;
      ld_row += W;
    }
  };
  for (int s = 0; s < D - 1; ++s) {
    if (s < steps) load_next();
    cp_async_commit();
  }

  cp_async_wait_ring(D);   // the x tile has landed (the ring may not)
  __syncthreads();
  for (int q = threadIdx.x; q < groups * TT; q += kThreads) {
    const uint8_t* line = xg + 16 * L::kParts * q;
    float sum = 0.f;
#pragma unroll
    for (int part = 0; part < L::kParts; ++part) {
      float xv[L::kElems];
      chunk(reinterpret_cast<const T*>(line + 16 * part), xv);
#pragma unroll
      for (int e = 0; e < L::kElems; ++e) sum += xv[e];
    }
    xsum[q] = sum;
  }
  __syncthreads();

  const int rq = lane & (L::kRot - 1);
  const int v = rq & (L::kParts - 1);
  const int u = rq / L::kParts;
  float acc[TT];
#pragma unroll
  for (int t = 0; t < TT; ++t) acc[t] = 0.f;
  int row = g, trip = 0, stage = 0;
  for (int s = 0; s < steps; ++s) {
    if (s + D - 1 < steps) load_next();
    cp_async_commit();
    cp_async_wait_ring(D);   // this step's slot has landed
    const int m = trip * 32 + lane;
    if (m < a.M) {
      const Stage& st = ring_w[stage];
      // padding slots carry idx -1: read group 0 instead (their scale is
      // 0, so they add nothing), as the TPU kernel's clamp does
      group<T, TT>(st.vals[lane], max(st.idx[lane], 0), st.scale[lane],
                   st.zero[lane], xg, xsum, u, v, acc);
    }
    if (++stage == D) stage = 0;
    if (++trip == trips) {
      write_row<TT>(acc, a.y, row, t0, a.T, a.N, lane, u);
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] = 0.f;
      trip = 0;
      row += W;
    }
  }
}

template <typename T, int TT>
int launch(const Args& a, int blocks, size_t smem, cudaStream_t stream) {
  static unsigned sized = 0;       // devices whose limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 32 && !(sized & (1u << dev))) {
    e = cudaFuncSetAttribute(gqsa_gemv_stream_kernel<T, TT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized |= 1u << dev;
  }
  gqsa_gemv_stream_kernel<T, TT><<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace streaming

}  // namespace

// One matrix, any T: x [T, K] (f32 or bf16), y [T, N] f32. `tt`: x rows
// a token tile (1, 2, 4, 8; f32 x at most 4); `n_tiles` = ceil(T / tt);
// `blocks`: a multiple of n_tiles; `smem`: the block's dynamic shared
// memory as the wrapper's plan counts it (kernels/gqsa_gemv.py:smem_bytes),
// refused unless it is this layout's. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int gqsa_gemv_launch(const void* x, int x_is_bf16,
                                const void* idx, const void* vals,
                                const void* scale, const void* zero, void* y,
                                int T, int N, int M, int K, int tt,
                                int n_tiles, int blocks, long long smem,
                                void* stream) {
  const int elem = x_is_bf16 ? 2 : 4;
  if (T < 1 || N < 1 || M < 1 || K < kGroup || K % kGroup != 0
      || (tt != 1 && tt != 2 && tt != 4 && (tt != 8 || !x_is_bf16))
      || n_tiles != (T + tt - 1) / tt || blocks < n_tiles
      || blocks % n_tiles != 0
      || smem != static_cast<long long>(streaming::smem_bytes(K, tt, elem))
      || smem > streaming::kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const streaming::Args a{x, static_cast<const int32_t*>(idx),
                       static_cast<const uint2*>(vals),
                       static_cast<const float*>(scale),
                       static_cast<const float*>(zero),
                       static_cast<float*>(y), T, N, M, K, n_tiles,
                       streaming::kDepth};
  const size_t sm = static_cast<size_t>(smem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    switch (tt) {
      case 1: return streaming::launch<__nv_bfloat16, 1>(a, blocks, sm, s);
      case 2: return streaming::launch<__nv_bfloat16, 2>(a, blocks, sm, s);
      case 4: return streaming::launch<__nv_bfloat16, 4>(a, blocks, sm, s);
      default: return streaming::launch<__nv_bfloat16, 8>(a, blocks, sm, s);
    }
  }
  switch (tt) {
    case 1: return streaming::launch<float, 1>(a, blocks, sm, s);
    case 2: return streaming::launch<float, 2>(a, blocks, sm, s);
    default: return streaming::launch<float, 4>(a, blocks, sm, s);
  }
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
  if (c0 < 0 || B < 1 || c0 + B > C || E < 1 || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t esz = x_is_bf16 ? 2 : 4;
  const Args a{static_cast<const char*>(x) + esz * c0 * K, idx, vals, scale,
               zero, static_cast<float*>(y) + static_cast<size_t>(c0) * N,
               N, M, K, E, static_cast<size_t>(C) * K,
               static_cast<size_t>(C) * N,
               static_cast<const int32_t*>(rows), c0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? dispatch<__nv_bfloat16>(a, B, s)
                   : dispatch<float>(a, B, s);
}
