// Dense grouped-dequant W4 matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/w4_matmul.py:w4_matmul_pallas,
// which every projection of the dense-W4 baseline (--compress w4) reaches
// in prefill and decode, and the w4l* drafts of speculation.
//
//   y[t, n] = sum_k x[t, k] * ((q[n, k] - zero[n, k/G]) * scale[n, k/G])
//
// Layouts: x [T, K] f32 or bf16; qw [N, K/2] uint8, two 4-bit codes per
// byte, element 2i in the low nibble; scale, zero [N, K/G] f32; y [T, N]
// f32. G is even and divides K.
//
// Expert axis (w4_matmul_experts_launch): the routed experts of an MoE
// layer packed as dense W4, which the reference runs as a vmap of the same
// Pallas kernel over its stacked weights (src/repro/models/moe.py:
// _expert_ffn): x [E, C, K], qw [E, N, K/2], scale, zero [E, N, K/G],
// y [E, C, N], y[e] = x[e] @ deq(expert e).T. Both paths below take it:
// blockIdx.z is the expert, whose operands start one expert's stride
// past the given pointers. An optional rows [E] int32, read on the card,
// says how many leading buffer rows of each expert hold tokens: rows at or
// past rows[e] are written as exact zeros, x rows past it are not read,
// and a block whose token tile starts at or past rows[e] writes its zeros
// and returns before any load, so an idle expert's weights are never
// read. At 4-slot decode of deepseek-moe-16b (24 routed entries, buffers
// of one row) about 20 of the 64 experts hold a row; DeepSeek-V2 about 23
// of 160. One launch a projection for any C, K never split (S = 1), so
// the sums run in a fixed order and repeats are bit-identical. The
// reference computes every expert on its zero rows; the caller's keep
// mask discards those products, so the skip changes no number.
//
// Bound on the card: bytes. At decode (T = 4 slots) every code byte and
// every f32 scale/zero is used for T multiply-adds, far below the H100's
// flop/byte balance, so the floor is (N*K/2 + 8*N*K/G + x + y) bytes over
// 3.35 TB/s (wq of llama2-7b at G16: 16.9 MB -> 5.0 us).
//
// Two paths, chosen by the wrapper from shapes and pointers alone:
//
// * Tensor cores (w4_matmul_tc_launch): G in {16, 32, 64, 128}, K a
//   multiple of 128, and x, qw, scale and zero 16-byte aligned. Every
//   projection of llama2-7b at G16 takes it.
//   - One mma.sync m16n8k16 (bf16 in, f32 out) is one G16 group of 16
//     weight rows against 8 x rows. The weights are the A operand: the raw
//     codes q, exact in bf16, made from two nibbles a lop3 as 0x4300 | q
//     (= 128 + q) and one packed subtract of 128. x is the B operand,
//     zero past T. The group's scale applies to the f32 fragment after
//     the step, and the zero point is folded out of the product:
//       acc += s * (sum_k q x) - (s * z) * (sum_k x),
//     the group sums of x coming from a second MMA with an all-ones A.
//     Any f32 zero is honoured exactly (no rounding of z is assumed).
//   - A lane's four k of a group may be any four, if x is staged in the
//     same order: lane t of a quad takes bytes 2t, 2t+1 of each group
//     (codes 4t .. 4t+3), one aligned 32-bit shared-memory read of each
//     of two groups and one byte permute give both groups' fragments, and
//     x[4t .. 4t+3] is one 8-byte read permuted to match.
//   - f32 x is split into bf16 hi + lo (two MMAs a step): x = hi + lo to
//     2^-18 relative, the products exact, so the result stays within a
//     few 1e-6 of the f32 product (TF32 would lose 2^-11).
//   - A block of 4 warps owns 64 output rows (an m16 tile a warp) and up
//     to 64 x rows (1, 2, 4 or 8 n8 tiles, from T), and walks its share
//     of K in stages of 128 elements through a 3-stage cp.async ring in
//     shared memory (4 or 6 stages, or stages of 256, were no faster):
//     codes, scale and zero tiles and x, rows padded so that no read
//     conflicts on a bank. K is split across S blocks (S from shapes and
//     the SM count, so that every projection puts about 3 blocks on each
//     SM at T <= 16 and 2 above, N = 4096 included); each block writes
//     its partial tile to a workspace, and the last block of a tile to
//     arrive (an integer counter, reset by that block) adds the S
//     partials in split order, so repeats are bit-identical. Prefill
//     reads the weights once per 64 x rows.
//   - wgmma is left out: at decode the product is a few percent of the
//     card's tensor rate, and the bytes, not the MMA issue, bound it.
//
// * CUDA cores (w4_matmul_launch): every other shape (G = 6, K = 48, G of
//   256, misaligned codes). A block of 8 warps owns 32 output rows (one
//   per lane) and a tile of BT <= 8 rows of x, and walks K in chunks of
//   512 elements. For each chunk the block stages x[tile, chunk] in shared
//   memory as f32 (zeros past T and past K), and each warp takes 64
//   elements of it: every lane holds its row's 32 code bytes (two 16-byte
//   loads), dequantises them in registers with their group's scale and
//   zero as (q - z) * s, the reference's order, and accumulates BT dot
//   products in f32 registers against x read from shared memory as
//   broadcasts. The next chunk's codes are loaded a chunk ahead. The
//   warps' partial sums are added in shared memory at the end. Ragged
//   edges are masked: rows past N skip their loads and stores, rows past T
//   are zero in shared memory, and a K that is not a multiple of 64 (or a
//   misaligned qw) takes a byte-load path bounded per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The expert axis of a launch: blockIdx.z is the expert (0 for one
// matrix), whose operands lie e * stride elements past the given
// pointers; rows [E] (null: every row) counts its buffer rows that hold
// tokens.
struct Experts {
  const int32_t* rows;
  long long x, qw, sz, y;   // strides: x, codes (bytes), scale/zero, y

  // expert e's rows that hold tokens, of `tokens`
  __device__ __forceinline__ int live(int e, int tokens) const {
    return rows == nullptr ? tokens : min(max(__ldg(rows + e), 0), tokens);
  }
};

// ---------------------------------------------------------------------------
// CUDA-core path
// ---------------------------------------------------------------------------
namespace simt {

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
                 int Trows, int N, int K, int G, const Experts ex) {
  __shared__ __align__(16) float xs[BT][kChunk];
  __shared__ float part[kWarps][BT][kRows];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = blockIdx.x * kRows + lane;
  const int t0 = blockIdx.y * BT;
  const int rows = min(BT, Trows - t0);
  const size_t e = blockIdx.z;
  x += e * ex.x;
  qw += e * ex.qw;
  scale += e * ex.sz;
  zero += e * ex.sz;
  y += e * ex.y;
  // rows of the tile that hold tokens; the rest are written as zeros
  const int live = min(max(ex.live(blockIdx.z, Trows) - t0, 0), rows);
  if (live == 0) {            // an idle tile: zeros, and nothing is read
    for (int i = tid; i < rows * kRows; i += kWarps * 32) {
      const int nn = blockIdx.x * kRows + i % kRows;
      if (nn < N) y[static_cast<size_t>(t0 + i / kRows) * N + nn] = 0.f;
    }
    return;
  }
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
      xs[t][kk] = (t < live && kc + kk < K)
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
      y[static_cast<size_t>(t0 + t) * N + nn] = t < live ? sum : 0.f;
    }
  }
}

template <typename T, int BT, bool kVec>
void launch(const void* x, const void* qw, const void* scale,
            const void* zero, void* y, int Trows, int N, int K, int G,
            int E, const Experts& ex, cudaStream_t stream) {
  const dim3 grid((N + kRows - 1) / kRows, (Trows + BT - 1) / BT, E);
  w4_matmul_kernel<T, BT, kVec><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(qw),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<float*>(y), Trows, N, K, G, ex);
}

template <typename T, bool kVec>
void dispatch(const void* x, const void* qw, const void* scale,
              const void* zero, void* y, int Trows, int N, int K, int G,
              int E, const Experts& ex, cudaStream_t s) {
  // the x tile: the smallest power of two >= T, at most 8 rows
  if (Trows <= 1)
    launch<T, 1, kVec>(x, qw, scale, zero, y, Trows, N, K, G, E, ex, s);
  else if (Trows <= 2)
    launch<T, 2, kVec>(x, qw, scale, zero, y, Trows, N, K, G, E, ex, s);
  else if (Trows <= 4)
    launch<T, 4, kVec>(x, qw, scale, zero, y, Trows, N, K, G, E, ex, s);
  else
    launch<T, 8, kVec>(x, qw, scale, zero, y, Trows, N, K, G, E, ex, s);
}

// Validates and launches the CUDA-core path for E experts (E = 1: one
// matrix); returns cudaGetLastError().
int run(const void* x, int x_is_bf16, const void* qw, const void* scale,
        const void* zero, void* y, int T, int N, int K, int G, int vec,
        int E, const Experts& ex, cudaStream_t s) {
  if (T < 1 || N < 1 || K < 2 || G < 2 || G % 2 != 0 || K % G != 0
      || E < 1 || E > 65535 || (vec && K % kSlice != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_is_bf16) {
    if (vec)
      dispatch<__nv_bfloat16, true>(x, qw, scale, zero, y, T, N, K, G, E,
                                    ex, s);
    else
      dispatch<__nv_bfloat16, false>(x, qw, scale, zero, y, T, N, K, G, E,
                                     ex, s);
  } else {
    if (vec)
      dispatch<float, true>(x, qw, scale, zero, y, T, N, K, G, E, ex, s);
    else
      dispatch<float, false>(x, qw, scale, zero, y, T, N, K, G, E, ex, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// Tensor-core path
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;      // output rows a block (m16 a warp)
constexpr int kK = 128;                 // K elements a stage
constexpr int kSteps = kK / 16;         // k16 MMA steps a stage
constexpr int kCodeRow = kK / 2 + 16;   // bytes a staged code row (80: the
                                        // quads' 4-byte reads hit 16 banks)
constexpr int kSzRow = kK / 16 + 4;     // floats a staged scale/zero row
constexpr int kXPad = 16;               // elements of pad a staged x row
constexpr uint32_t kBias = 0x43004300u; // bf16x2 {128, 128}
constexpr uint32_t kOnes = 0x3F803F80u; // bf16x2 {1, 1}

template <typename T, int NT>
struct Layout {                          // one stage of the ring, in bytes
  static constexpr int kTok = 8 * NT;    // x rows a block
  static constexpr int kCodes = kRows * kCodeRow;
  static constexpr int kSz = kRows * kSzRow * 4;      // scale, then zero
  static constexpr int kXRow = (kK + kXPad) * static_cast<int>(sizeof(T));
  static constexpr int kStage = kCodes + 2 * kSz + kTok * kXRow;
  static constexpr int kStages = 3;      // 2 in flight while one computes
  static constexpr int kBytes = kStage * kStages;
};

template <typename T>
struct Args {
  const T* x;
  const uint8_t* qw;
  const float* scale;
  const float* zero;
  float* y;
  float* work;       // S > 1: partials [S, T, N]
  int* counters;     // S > 1: one per (row tile, x tile), zero between launches
  int tokens, N, K, G, gshift;
  int n_split;       // S, over blockIdx.z; > 1 only for one matrix
  Experts ex;        // the expert axis (over blockIdx.z when S = 1)

  // the operands of expert e
  __device__ __forceinline__ Args at(size_t e) const {
    Args b = *this;
    b.x += e * ex.x;
    b.qw += e * ex.qw;
    b.scale += e * ex.sz;
    b.zero += e * ex.sz;
    b.y += e * ex.y;
    return b;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `bytes` of src, zeros for the rest of the copy (0: rows past N or T).
// L2 fetches the whole 128-byte line: the next stages read the rest of it
// (232 -> 216 us a llama2-7b layer at T = 4 on an H100 SXM, 700 W).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
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

// d = a * b + c: a 16x16 bf16 (row), b 16x8 bf16 (col), c and d f32
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1,
                                    const float c[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// nibbles 0 and 4 of v as the bf16x2 codes {q0, q4}: (128 + q) - 128
__device__ __forceinline__ uint32_t codes(uint32_t v) {
  const uint32_t biased = (v & 0x000F000Fu) | kBias;
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(out) : "r"(biased), "r"(kOnes), "r"(kBias | 0x80008000u));
  return out;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One group: d = sum_k q x and xs = sum_k x for this lane's accumulator
// columns (x rows 2t, 2t+1 of the n8 tile). `xp`: x[row][4t .. 4t+3] of
// the group, staged raw; the B fragment takes them in the order
// {4t, 4t+2} (k slots 2t, 2t+1) and {4t+1, 4t+3} (slots 2t+8, 2t+9), the
// order of the codes in `a`.
__device__ __forceinline__ void group_product(const uint32_t a[4],
                                              const uint8_t* xp,
                                              __nv_bfloat16, float d[4],
                                              float xs[2]) {
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  const uint32_t ones[4] = {kOnes, kOnes, kOnes, kOnes};
  const uint2 v = *reinterpret_cast<const uint2*>(xp);
  const uint32_t b0 = __byte_perm(v.x, v.y, 0x5410);
  const uint32_t b1 = __byte_perm(v.x, v.y, 0x7632);
  float o[4];
  mma(d, a, b0, b1, zero);
  mma(o, ones, b0, b1, zero);
  xs[0] = o[0];
  xs[1] = o[1];
}

// f32 x as bf16 hi + lo: two MMAs each, the lo terms added to the hi ones
__device__ __forceinline__ void group_product(const uint32_t a[4],
                                              const uint8_t* xp, float,
                                              float d[4], float xs[2]) {
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  const uint32_t ones[4] = {kOnes, kOnes, kOnes, kOnes};
  const float4 v = *reinterpret_cast<const float4*>(xp);
  const uint32_t h0 = pack_bf16(v.x, v.z);
  const uint32_t h1 = pack_bf16(v.y, v.w);
  const uint32_t l0 = pack_bf16(v.x - __uint_as_float(h0 << 16),
                                v.z - __uint_as_float(h0 & 0xFFFF0000u));
  const uint32_t l1 = pack_bf16(v.y - __uint_as_float(h1 << 16),
                                v.w - __uint_as_float(h1 & 0xFFFF0000u));
  float o[4];
  mma(d, a, h0, h1, zero);
  mma(d, a, l0, l1, d);
  mma(o, ones, h0, h1, zero);
  mma(o, ones, l0, l1, o);
  xs[0] = o[0];
  xs[1] = o[1];
}

// A thread's share of the copies of every stage, its addresses worked out
// once for the block: 16-byte code pieces (at kK = 128, rows tid/4 and
// tid/4 + 32), one or two pieces of scale or zero, then x rows (indexed
// per stage, at compile-time strides).
template <typename T, int NT>
struct Loader {
  using L = Layout<T, NT>;
  static constexpr int kPieces = kK / 32;            // 16 B of codes a row
  static constexpr int kCodeCopies = kRows * kPieces / kThreads;
  static constexpr int kSzCopies = kK / 64;          // at most, at G16
  const uint8_t* code[kCodeCopies];   // at the block's first stage
  const float* sz[kSzCopies];
  int code_dst[kCodeCopies], code_bytes[kCodeCopies];
  int sz_dst[kSzCopies], sz_bytes[kSzCopies];
  int n_sz, sz_size, sz_step;   // copies, bytes a copy, floats a stage
  int k0;

  __device__ __forceinline__ Loader(const Args<T>& a, int n0, int k_first)
      : k0(k_first) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < kCodeCopies; ++i) {
      const int c = tid + kThreads * i;
      const int r = c / kPieces, part = c % kPieces;
      const bool ok = n0 + r < a.N;
      code[i] = a.qw + static_cast<size_t>(ok ? n0 + r : 0) * (a.K / 2)
          + k0 / 2 + 16 * part;
      code_dst[i] = r * kCodeRow + 16 * part;
      code_bytes[i] = ok ? 16 : 0;
    }
    const int per_row = kK / a.G;             // floats a row: 8, 4, 2, 1
    const int pieces = per_row >= 4 ? per_row / 4 : 1;
    sz_size = per_row >= 4 ? 16 : 4 * per_row;
    sz_step = per_row;
    n_sz = pieces * 2 * kRows / kThreads;     // 2 * kRows * pieces copies
#pragma unroll
    for (int i = 0; i < kSzCopies; ++i) {
      const int c = tid + kThreads * i;
      const int arr = c / (kRows * pieces);
      const int j = c - arr * kRows * pieces;
      const int r = j / pieces, part = j - r * pieces;
      const bool ok = n0 + r < a.N;
      sz[i] = (arr ? a.zero : a.scale)
          + static_cast<size_t>(ok ? n0 + r : 0) * (a.K / a.G) + k0 / a.G
          + 4 * part;
      sz_dst[i] = L::kCodes + arr * L::kSz + r * kSzRow * 4 + 16 * part;
      sz_bytes[i] = ok ? sz_size : 0;
    }
  }

  // Issue the copies of the block's stage `c` (K elements k0 + 128c ..)
  // into `st`; x rows at or past `live` are zeros.
  __device__ __forceinline__ void load(uint8_t* st, const Args<T>& a,
                                       int t0, int live, int c) const {
#pragma unroll
    for (int i = 0; i < kCodeCopies; ++i)
      cp_async16(st + code_dst[i], code[i] + c * (kK / 2), code_bytes[i]);
#pragma unroll
    for (int i = 0; i < kSzCopies; ++i) {
      if (i == n_sz) break;
      const float* src = sz[i] + c * sz_step;
      if (sz_size == 16)
        cp_async16(st + sz_dst[i], src, sz_bytes[i]);
      else if (sz_size == 8)
        cp_async8(st + sz_dst[i], src, sz_bytes[i]);
      else
        cp_async4(st + sz_dst[i], src, sz_bytes[i]);
    }
    constexpr int kParts = kK * static_cast<int>(sizeof(T)) / 16;
    uint8_t* xs = st + L::kCodes + 2 * L::kSz;
    const int kc = k0 + c * kK;
#pragma unroll
    for (int i = 0; i < L::kTok * kParts / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int t = e / kParts, part = e - t * kParts;
      const bool ok = t0 + t < live;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(
          a.x + static_cast<size_t>(ok ? t0 + t : 0) * a.K + kc)
          + 16 * part;
      cp_async16(xs + t * L::kXRow + 16 * part, src, ok ? 16 : 0);
    }
  }
};

// The warp's 16 rows against every x tile over one staged stage.
template <typename T, int NT>
__device__ __forceinline__ void compute_stage(const uint8_t* st,
                                              float (&acc)[NT][4],
                                              int gshift) {
  using L = Layout<T, NT>;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row = (threadIdx.x >> 5) * 16 + gid;
  // the 32-bit word holding bytes 2*tig, 2*tig+1 of a group
  const uint8_t* c0 = st + row * kCodeRow + 4 * (tig >> 1);
  const uint8_t* c8 = c0 + 8 * kCodeRow;
  const float* s0 = reinterpret_cast<const float*>(st + L::kCodes)
      + row * kSzRow;
  const float* s8 = s0 + 8 * kSzRow;
  const float* z0 = s0 + L::kSz / 4;
  const float* z8 = s8 + L::kSz / 4;
  const uint8_t* xr = st + L::kCodes + 2 * L::kSz + gid * L::kXRow
      + 4 * tig * static_cast<int>(sizeof(T));
  // bytes (2t, 2t+1) of two groups' words, interleaved: [g.b, g'.b,
  // g.b+1, g'.b+1], so one mask takes one group's codes {4t, 4t+2}
  const uint32_t sel = (tig & 1) ? 0x7362u : 0x5140u;
#pragma unroll
  for (int p = 0; p < kSteps / 2; ++p) {
    const uint32_t* w0 = reinterpret_cast<const uint32_t*>(c0 + 16 * p);
    const uint32_t* w8 = reinterpret_cast<const uint32_t*>(c8 + 16 * p);
    const uint32_t r0 = __byte_perm(w0[0], w0[2], sel);
    const uint32_t r8 = __byte_perm(w8[0], w8[2], sel);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = 2 * p + h;
      // rows gid, gid+8 x k slots {2t, 2t+1}, then {2t+8, 2t+9}
      const uint32_t a[4] = {codes(r0 >> (8 * h)), codes(r8 >> (8 * h)),
                             codes(r0 >> (8 * h + 4)),
                             codes(r8 >> (8 * h + 4))};
      const int gi = s >> gshift;
      const float sc0 = s0[gi], sc8 = s8[gi];
      const float nz0 = -(sc0 * z0[gi]), nz8 = -(sc8 * z8[gi]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float d[4], xs[2];
        group_product(a, xr + 8 * j * L::kXRow
                          + 16 * s * static_cast<int>(sizeof(T)),
                      T(), d, xs);
        acc[j][0] = fmaf(nz0, xs[0], fmaf(sc0, d[0], acc[j][0]));
        acc[j][1] = fmaf(nz0, xs[1], fmaf(sc0, d[1], acc[j][1]));
        acc[j][2] = fmaf(nz8, xs[0], fmaf(sc8, d[2], acc[j][2]));
        acc[j][3] = fmaf(nz8, xs[1], fmaf(sc8, d[3], acc[j][3]));
      }
    }
  }
}

// acc[j][e] is y[t0 + 8j + 2*tig + (e & 1)][n0 + row + 8 * (e >> 1)]
template <int NT, typename F>
__device__ __forceinline__ void for_each_output(int n0, int t0, int N,
                                                int tokens, F&& f) {
  const int lane = threadIdx.x & 31;
  const int row = n0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int col = t0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = row + 8 * (e >> 1), t = col + 8 * j + (e & 1);
      if (n < N && t < tokens) f(j, e, static_cast<size_t>(t) * N + n);
    }
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
w4_matmul_tc_kernel(const Args<T> args) {
  using L = Layout<T, NT>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last;
  const int n0 = blockIdx.x * kRows, t0 = blockIdx.y * L::kTok;
  // blockIdx.z is the split (one matrix) or the expert (S = 1)
  const int S = args.n_split;
  const int split = S > 1 ? blockIdx.z : 0, expert = S > 1 ? 0 : blockIdx.z;
  const Args<T> a = args.at(expert);
  const int live = args.ex.live(expert, a.tokens);
  if (t0 >= live) {     // an idle tile: zeros, and nothing is read
    for_each_output<NT>(n0, t0, a.N, a.tokens,
                        [&](int, int, size_t o) { a.y[o] = 0.f; });
    return;
  }
  const int chunks = a.K / kK;
  const int c_lo = split * chunks / S;
  const int n_ch = (split + 1) * chunks / S - c_lo;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const Loader<T, NT> ld(a, n0, c_lo * kK);
#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (i < n_ch) ld.load(smem + i * L::kStage, a, t0, live, i);
    cp_async_commit();
  }
  for (int i = 0; i < n_ch; ++i) {
    cp_async_wait<L::kStages - 2>();
    __syncthreads();      // stage i landed; stage i-1's buffer is free
    const int next = i + L::kStages - 1;
    if (next < n_ch)
      ld.load(smem + (next % L::kStages) * L::kStage, a, t0, live, next);
    cp_async_commit();
    compute_stage<T, NT>(smem + (i % L::kStages) * L::kStage, acc,
                         a.gshift);
  }

  // rows past the expert's tokens: exact zeros, whatever its weights hold
  const int col = t0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + 8 * j + (e & 1) >= live) acc[j][e] = 0.f;

  if (S == 1) {
    for_each_output<NT>(n0, t0, a.N, a.tokens,
                        [&](int j, int e, size_t o) { a.y[o] = acc[j][e]; });
    return;
  }
  // split K: partials to the workspace; the tile's last block adds them
  const size_t plane = static_cast<size_t>(a.tokens) * a.N;
  float* mine = a.work + split * plane;
  for_each_output<NT>(n0, t0, a.N, a.tokens,
                      [&](int j, int e, size_t o) { mine[o] = acc[j][e]; });
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(a.counters + tile, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for_each_output<NT>(n0, t0, a.N, a.tokens, [&](int j, int e, size_t o) {
    float v = split == 0 ? acc[j][e] : __ldcg(a.work + o);
    for (int s = 1; s < S; ++s)       // split order, whoever came last
      v += s == split ? acc[j][e] : __ldcg(a.work + s * plane + o);
    a.y[o] = v;
  });
  if (threadIdx.x == 0) a.counters[tile] = 0;
}

template <typename T, int NT>
int launch(const Args<T>& a, int E, cudaStream_t stream) {
  using L = Layout<T, NT>;
  static unsigned sized = 0;       // devices whose limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 32 && !(sized & (1u << dev))) {
    e = cudaFuncSetAttribute(w4_matmul_tc_kernel<T, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized |= 1u << dev;
  }
  const dim3 grid((a.N + kRows - 1) / kRows,
                  (a.tokens + L::kTok - 1) / L::kTok, E * a.n_split);
  w4_matmul_tc_kernel<T, NT><<<grid, kThreads, L::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args<T>& a, int nt, int E, cudaStream_t s) {
  switch (nt) {
    case 1: return launch<T, 1>(a, E, s);
    case 2: return launch<T, 2>(a, E, s);
    case 4: return launch<T, 4>(a, E, s);
    default: return launch<T, 8>(a, E, s);
  }
}

// Validates and launches the tensor-core path for E experts (E = 1: one
// matrix; S > 1 only there); returns cudaGetLastError().
int run(const void* x, int x_is_bf16, const void* qw, const void* scale,
        const void* zero, void* y, void* work, void* counters, int T, int N,
        int K, int G, int nt, int n_split, int E, const Experts& ex,
        cudaStream_t s) {
  int gshift = -1;
  for (int g = 16, i = 0; g <= kK; g *= 2, ++i)
    if (G == g) gshift = i;
  if (T < 1 || N < 1 || gshift < 0 || K < kK || K % kK != 0
      || n_split < 1 || n_split > K / kK || E < 1
      || E * n_split > 65535 || (E > 1 && n_split > 1)
      || (n_split > 1 && ex.rows != nullptr)
      || (nt != 1 && nt != 2 && nt != 4 && nt != 8)
      || (n_split > 1 && (work == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_is_bf16) {
    const Args<__nv_bfloat16> a{
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const uint8_t*>(qw), static_cast<const float*>(scale),
        static_cast<const float*>(zero), static_cast<float*>(y),
        static_cast<float*>(work), static_cast<int*>(counters), T, N, K, G,
        gshift, n_split, ex};
    return dispatch(a, nt, E, s);
  }
  const Args<float> a{
      static_cast<const float*>(x), static_cast<const uint8_t*>(qw),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<float*>(y), static_cast<float*>(work),
      static_cast<int*>(counters), T, N, K, G, gshift, n_split, ex};
  return dispatch(a, nt, E, s);
}

}  // namespace tc

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// `vec`: K % 64 == 0 and qw 16-byte aligned (the 16-byte code loads).
extern "C" int w4_matmul_launch(const void* x, int x_is_bf16, const void* qw,
                                const void* scale, const void* zero, void* y,
                                int T, int N, int K, int G, int vec,
                                void* stream) {
  return simt::run(x, x_is_bf16, qw, scale, zero, y, T, N, K, G, vec, 1,
                   Experts{nullptr, 0, 0, 0, 0},
                   static_cast<cudaStream_t>(stream));
}

// The tensor-core path. `nt`: n8 tiles of x rows a block (1, 2, 4, 8);
// `n_split`: blocks K is split over (1 .. K/128); with n_split > 1,
// `work` holds n_split * T * N floats and `counters` one zero int per
// (64-row tile, 8*nt-row x tile), which the launch leaves at zero.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int w4_matmul_tc_launch(const void* x, int x_is_bf16,
                                   const void* qw, const void* scale,
                                   const void* zero, void* y, void* work,
                                   void* counters, int T, int N, int K,
                                   int G, int nt, int n_split,
                                   void* stream) {
  return tc::run(x, x_is_bf16, qw, scale, zero, y, work, counters, T, N, K,
                 G, nt, n_split, 1, Experts{nullptr, 0, 0, 0, 0},
                 static_cast<cudaStream_t>(stream));
}

// The expert axis: x [E, C, K], qw [E, N, K/2], scale, zero [E, N, K/G],
// y [E, C, N], all contiguous; rows [E] int32 or null (every row holds a
// token). `tc` picks the tensor-core path (then `nt` as above, no split),
// else the CUDA-core one (then `vec` as above). One launch for every
// expert and any C; returns cudaGetLastError() (0 = launched).
extern "C" int w4_matmul_experts_launch(const void* x, int x_is_bf16,
                                        const void* qw, const void* scale,
                                        const void* zero, void* y,
                                        const void* rows, int E, int C,
                                        int N, int K, int G, int tc, int nt,
                                        int vec, void* stream) {
  if (E < 1 || C < 1 || N < 1 || K < 2 || G < 2 || K % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Experts ex{static_cast<const int32_t*>(rows),
                   static_cast<long long>(C) * K,
                   static_cast<long long>(N) * (K / 2),
                   static_cast<long long>(N) * (K / G),
                   static_cast<long long>(C) * N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc)
    return tc::run(x, x_is_bf16, qw, scale, zero, y, nullptr, nullptr, C, N,
                   K, G, nt, 1, E, ex, s);
  return simt::run(x, x_is_bf16, qw, scale, zero, y, C, N, K, G, vec, E, ex,
                   s);
}
