// GQSA sparse-quantized GEMV / skinny GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gqsa_gemv.py:gqsa_gemv_pallas.
//
//   y[t, n] = sum_m sum_j ((q[n,m,j] - zero[n,m]) * scale[n,m])
//                         * x[t, idx[n,m]*g + j]
//
// Layouts (the padded BSR form of src/repro_torch/core/bsr.py): x [T, K]
// f32 or bf16; idx [N, M] int32 (-1 = padding); vals [N, M, g/2] uint8,
// two 4-bit codes per byte, element 2i in the low nibble; scale, zero
// [N, M] f32 (scale 0 on padding); y [T, N] f32. The group size g is 8,
// 16, 32, 64 or 128, a template parameter (G) of every kernel; the
// launchers refuse any other.
//
// Bound on the card (H100 SXM): bytes at every T the model sends. Each
// kept group streams g/2 + 12 bytes of payload (codes, idx, scale, zero:
// 16, 20, 28, 44 and 76 bytes at g = 8, 16, 32, 64 and 128) for g * T
// multiply-adds of bf16 x and exact 4-bit codes, which the card's tensor
// cores take at 989 TFLOP/s; at g = 16 the bytes over 3.35 TB/s stay the larger time up to
// T of about 280 (4.05 GB per llama2-7b decode step -> 1.21 ms; a
// llama2-7b layer: 38 us at T = 4, 46 us at T = 116). The design below
// runs on CUDA cores (f32, 67 TFLOP/s, 350 us a layer of multiply-adds
// alone at T = 116) and is bound by that arithmetic at every T: about 41
// instructions a kept group and x row at g = 16 (16 bf16 widenings, 16
// multiply-adds, two 16-byte reads, the zero fold), so it stays far above
// the byte floor (PERF.md); a group's fixed costs (its slot's payload, the
// zero fold) weigh more at g = 8 and less at g = 32; above 32 they are
// paid per 32-code part (below), as at g = 32. Tensor cores on a
// densified stage are the next step (ROADMAP.md B.3).
//
// Design (gqsa_gemv_launch, any T in one launch): one block of 16 warps
// per SM, each block on one token tile of TT <= 8 x rows.
//  * x out of the dependent chain: the block stages its tile of x once,
//    with cp.async, in shared memory as [K/g groups][TT tokens][g], and
//    the group sums of x beside it ([K/g][TT] f32), so a group's gather
//    is one line of TT * g values. Lanes read a line in 16-byte chunks,
//    P = g * sizeof(x) / 16 of them a token (bf16: 1, 2, 4 at g = 8, 16,
//    32; f32: 2, 4, 8). With R = min(8, TT * P) rotations, lane l starts
//    at token (l % R) / P and takes a token's P chunks in the order
//    part ^ (l % R % P), so the 8 lanes of each quarter warp hit 8
//    distinct 16-byte bank groups whatever the columns: no bank conflict
//    once a line (TT * P chunks) is 128 bytes or more (g = 16: bf16 TT >=
//    4, f32 TT >= 2; g = 8: bf16 TT = 8, f32 TT >= 4; g = 32: bf16 TT >=
//    2, f32 any TT; above 32 the lines are g = 32's); below that, at most
//    the columns' collisions of one or two lines, where bytes dominate.
//  * The payload streams: a warp owns whole rows (rows r, r + W, ... of
//    its tile's W warps), its lanes take slots m = 32 p + lane, so a
//    warp's copy of a field is 128 consecutive bytes. Each lane copies its
//    own slot's idx, scale, zero and codes (one cp.async of 4, 8 or 16
//    bytes) into its warp's ring of kDepth = 3 stages (512, 640 or 896
//    bytes a stage at g = 8, 16, 32; 896 above), two slots ahead of
//    the arithmetic. An 8-stage ring was slower at decode (PERF.md,
//    scripts/gemv_variants.py), since the kernel is bound by its
//    arithmetic and a deeper prologue delays the x tile behind the
//    payload's requests. The kernel reads the depth from its arguments,
//    not as a constant: a compile-time depth was slower at 8 rows and
//    more (ptxas schedules the loop differently).
//  * The zero folds out: acc += s * sum_j q_j x_j - (s z) * sum_j x_j, on
//    the raw codes (a nibble becomes the exact float by a byte permute and
//    one subtract), per group; the codes are converted once and used for
//    the TT tokens of the tile (g floats a lane).
//  * Group sizes above 32 (64, 128): a kept group is g / 32 work items,
//    its parts of 32 codes, which share its idx, scale and zero; a lane
//    takes a work item where it would take a slot at g <= 32 (item m of a
//    row: part m % (g/32) of slot m / (g/32)), its codes one 16-byte copy,
//    and computes it as a g = 32 group on x staged as at g = 32 ([K/32]
//    lines, a sum per 32-column part): acc += s * d_p - (s z) * xs_p. The
//    fold is linear, so the parts add to the group's value; a lane never
//    converts more than 32 codes (registers as at g = 32), and a row's
//    M * g / 32 items fill a warp's lanes where its M groups would not
//    (llama2-7b's wq at g = 128: M = 16, 64 items; deepseek-moe-16b's
//    expert w_d: M = 6, 24 items). The lanes of a group's parts copy its
//    idx, scale and zero from the same 4 bytes, one request for the warp;
//    the codes of a row's items are consecutive 16-byte chunks.
//  * Any T: ceil(T / TT) tiles, each on its own blocks (one wave up to
//    132 tiles). The blocks of every tile read all the weights; they run
//    at the same time, so a byte comes from device memory once and from
//    L2 for the other tiles.
// Fixed order, no atomics: a row's sums are one lane's slots in order, the
// P chunks of a group added as a pairwise tree (the same for every
// rotation), and a butterfly across the warp; the result of a (row, token)
// depends on neither the tile, the grid nor the other rows of x, so
// repeats are bit-identical. Nothing is read on the host; the wrapper
// (kernels/gqsa_gemv.py) picks TT and the grid from shapes and the SM
// count.
//
// Expert axis (gqsa_gemv_experts_launch, gqsa_gemv_experts_kernel): the
// routed experts of an MoE layer, which the reference runs as a vmap of
// the same Pallas kernel over its stacked weights
// (src/repro/models/moe.py:_expert_ffn). Leaves [E, N, M] (idx, scale,
// zero) and [E, N, M, g/2] (vals), x [E, C, K], y [E, C, N] f32, rows [E]
// (the leading buffer rows of each expert that hold tokens; null: all C).
// One launch at any C, on the same streaming design:
//  * One block of 16 warps per SM, any grid: every block counts the
//    occupied (expert, token tile) pairs from rows (a block scan, each
//    thread over E / 512 experts), so nothing is read on the host and the
//    grid needs no count. The pairs' output rows, in units of 16 rows,
//    are cut into gridDim.x equal spans in pair order; a block walks its
//    span pair by pair: it stages that expert's x tile and group sums
//    (rows at or past rows[e] as zeros, by 0-byte copies), then its warps
//    stream the pair's rows through their rings (kExpertDepth stages).
//  * Short rows: where a row's work items (M groups; M * g / 32 above g =
//    32) would leave half a warp or more idle on its last 32-item trip
//    (w_d at g = 16: M = 48 and 44), a warp
//    takes two rows at once, 16 lanes each (kRowLanes = 16; the wrapper
//    picks it from them): a DeepSeek-V2 w_d at C = 1 74 -> 64 us, at C = 3
//    630 -> 462 us; rows of M = 64 and 160 lose by it (PERF.md).
//  * Buffer rows at or past rows[e], all of an idle expert's, are written
//    as zeros in the same launch; an idle expert's payload and x rows past
//    rows[e] are never read. At 4-slot DeepSeek-V2 decode (24 routed
//    entries, C = 1) at most 24 of the 160 experts hold a row: a layer's
//    three expert projections stream at most 24 experts' payload (14.7 MB
//    each at g = 16) of 2.36 GB. The reference computes every expert on
//    its zero rows; its keep mask discards them, so the skip changes no
//    number.
//  * Bound: bytes at decode (C = 1: the arithmetic is a quarter of T =
//    4's a byte), the CUDA-core arithmetic at prefill capacities, as the
//    single-matrix kernel at many rows. Its arithmetic and order of sums
//    are the single-matrix kernel's (a row's lanes added by a butterfly
//    over its 16 or 32 lanes), so a (row, token) result depends on
//    neither the grid, the other experts nor the other tokens of its
//    tile: repeats are bit-identical.
// The first design, one warp an output row over a grid (N / 8, E) with
// <= 8 buffer rows a launch, lost 31% of a DeepSeek-V2 decode layer to
// the blocks of idle experts and ran at 40% of the byte bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace streaming {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kDepth = 3;          // stages of each warp's ring
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block, sm_90

// A work item's codes at group size G, one vector load: a kept group's
// G / 2 bytes at G <= 32, one 32-code part of it (16 bytes) above.
template <int G> struct Codes;
template <> struct Codes<8> { using type = uint32_t; };
template <> struct Codes<16> { using type = uint2; };
template <> struct Codes<32> { using type = uint4; };
template <> struct Codes<64> { using type = uint4; };
template <> struct Codes<128> { using type = uint4; };

inline bool takes_group(int g) { return g == 8 || g == 16 || g == 32 || g == 64 || g == 128; }

// The work of group size G: a staged line of x holds kLine values (G, at
// most 32), and a kept group is kItems = G / kLine work items, its parts
// of kLine codes, which share its idx, scale and zero.
__host__ __device__ constexpr int line_of(int g) { return g < 32 ? g : 32; }

template <int G>
struct Width {
  static constexpr int kLine = line_of(G);
  static constexpr int kItems = G / kLine;
};

// One stage of a warp's ring: the payload of 32 work items, one a lane.
template <int G>
struct Stage {
  int32_t idx[32];
  float scale[32];
  float zero[32];
  typename Codes<G>::type vals[32];
};
// kernels/gqsa_gemv.py:STAGE_BYTES
static_assert(sizeof(Stage<8>) == 512, "g = 8: 32 slots of 16 bytes");
static_assert(sizeof(Stage<16>) == 640, "g = 16: 32 slots of 20 bytes");
static_assert(sizeof(Stage<32>) == 896, "g = 32: 32 slots of 28 bytes");
static_assert(sizeof(Stage<64>) == 896, "g = 64: 32 parts of 28 bytes");
static_assert(sizeof(Stage<128>) == 896, "g = 128: 32 parts of 28 bytes");

inline size_t stage_bytes(int g) {
  return g == 8 ? sizeof(Stage<8>)
                : g == 16 ? sizeof(Stage<16>) : sizeof(Stage<32>);
}

struct Args {
  const void* x;
  const int32_t* idx;
  const void* vals;      // Codes<G>::type [N, M]
  const float* scale;
  const float* zero;
  float* y;
  int T, N, M, K;
  int n_tiles;   // token tiles: block b takes tile b % n_tiles
  int depth;     // kDepth, read at run time (see the design note)
};

// The expert axis (gqsa_gemv_experts_kernel).
constexpr int kExpertDepth = 4;    // stages of each warp's ring
constexpr int kCtrlInts = 32;      // block-shared ints: warp totals, segment

struct ExpertArgs {
  const void* x;          // [E, C, K]
  const int32_t* idx;     // [E, N, M], and so vals, scale, zero
  const void* vals;       // Codes<G>::type [E, N, M]
  const float* scale;
  const float* zero;
  float* y;               // [E, C, N]
  const int32_t* rows;    // [E] buffer rows holding tokens; null: all C
  int E, C, N, M, K;
  int depth;              // kExpertDepth, read at run time
};

// A staged line: TT tokens of G (at most 32) values, P 16-byte chunks
// each.
template <typename T, int TT, int G>
struct Tile {
  static constexpr int kParts = G * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  static constexpr int kChunks = TT * kParts;         // chunks a line
  static constexpr int kRot = kChunks < 8 ? kChunks : 8;  // lane rotations
};

// Shared memory of a launch: the x tile ([K/l][tt][l] for lines of l =
// line_of(g) values, K * tt values whatever g), its line sums (rounded up
// to 16 bytes), the rings.
__host__ __device__ inline size_t x_bytes(int K, int tt, int elem) {
  return static_cast<size_t>(K) * tt * elem;
}

__host__ __device__ inline size_t sum_bytes(int K, int line, int tt) {
  return (static_cast<size_t>(K / line) * tt * 4 + 15) / 16 * 16;
}

inline size_t smem_bytes(int K, int g, int tt, int elem) {
  return x_bytes(K, tt, elem) + sum_bytes(K, line_of(g), tt)
      + static_cast<size_t>(kWarps) * kDepth * stage_bytes(g);
}

// The expert axis's: the same, its rings kExpertDepth deep, then kCtrlInts.
inline size_t experts_smem_bytes(int K, int g, int tt, int elem) {
  return x_bytes(K, tt, elem) + sum_bytes(K, line_of(g), tt)
      + static_cast<size_t>(kWarps) * kExpertDepth * stage_bytes(g)
      + kCtrlInts * sizeof(int);
}

inline bool takes_tile(int tt, int x_is_bf16) {
  return tt == 1 || tt == 2 || tt == 4 || (tt == 8 && x_is_bf16);
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

// A slot's codes: one copy of their size (16 bytes may take .cg)
__device__ __forceinline__ void cp_async_codes(uint32_t* dst,
                                               const uint32_t* src) {
  cp_async4(dst, src, 4);
}

__device__ __forceinline__ void cp_async_codes(uint2* dst, const uint2* src) {
  cp_async8(dst, src, 8);
}

__device__ __forceinline__ void cp_async_codes(uint4* dst, const uint4* src) {
  cp_async16(dst, src, 16);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// wait until at most `depth` - 1 of this thread's groups are in flight;
// `depth` is the ring's constant kD (any other value waits for all, which
// is always safe)
template <int kD>
__device__ __forceinline__ void cp_async_wait_ring(int depth) {
  if (depth == kD)
    cp_async_wait<kD - 1>();
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

// A slot's codes as 32-bit words of 8 codes each
__device__ __forceinline__ void words(uint32_t p, uint32_t (&w)[1]) {
  w[0] = p;
}

__device__ __forceinline__ void words(uint2 p, uint32_t (&w)[2]) {
  w[0] = p.x;
  w[1] = p.y;
}

__device__ __forceinline__ void words(uint4 p, uint32_t (&w)[4]) {
  w[0] = p.x;
  w[1] = p.y;
  w[2] = p.z;
  w[3] = p.w;
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

// d[0] + ... + d[N - 1] as a pairwise tree: ((d0 + d1) + (d2 + d3)) + ...
template <int N>
__device__ __forceinline__ float pairwise(const float* d) {
  if constexpr (N == 1)
    return d[0];
  else
    return pairwise<N / 2>(d) + pairwise<N / 2>(d + N / 2);
}

// One kept group against the tile's TT tokens. acc[j] is the lane's sum
// for token (j + u) mod TT; chunk step sp of a token reads part sp ^ v,
// so the codes are permuted to match once for the group: a part is a
// word of 8 codes (bf16) or half of one (f32), and each bit of v swaps
// halves or words at its distance.
template <typename T, int TT, int G>
__device__ __forceinline__ void group(typename Codes<G>::type pk, int col,
                                      float s, float z, const uint8_t* xg,
                                      const float* xsum, int u, int v,
                                      float (&acc)[TT]) {
  using L = Tile<T, TT, G>;
  constexpr int kWords = G / 8;
  constexpr int kHalf = L::kElems == 4 ? 1 : 0;   // f32: a part is a half
  uint32_t wd[kWords];
  words(pk, wd);
  if (kHalf && (v & 1)) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) wd[i] = __byte_perm(wd[i], 0, 0x1032);
  }
#pragma unroll
  for (int b = kHalf; (1 << b) < L::kParts; ++b) {
    const int d = 1 << (b - kHalf);
    if (v & (1 << b)) {
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        if (!(i & d)) {
          const uint32_t t = wd[i];
          wd[i] = wd[i + d];
          wd[i + d] = t;
        }
      }
    }
  }
  float w[G];
#pragma unroll
  for (int i = 0; i < kWords; ++i) codes8(wd[i], w + 8 * i);
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
    const float dsum = pairwise<L::kParts>(d);
    acc[j] = fmaf(nsz, xs[tok], fmaf(s, dsum, acc[j]));
  }
}

// A finished row: undo the lane's token rotation, add the row's kLanes
// lanes (a butterfly within each aligned group of kLanes, the same total
// in every lane of it) and write y[t0 + t][row].
template <int TT, int kLanes = 32>
__device__ __forceinline__ void write_row(float (&acc)[TT], float* y,
                                          int row, int t0, int T, int N,
                                          int lane, int u) {
  const int sub = lane & (kLanes - 1);   // the lane within the row's lanes
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
    for (int off = kLanes / 2; off > 0; off >>= 1)
      r[t] += __shfl_xor_sync(0xffffffffu, r[t], off);
  float out = r[0];
#pragma unroll
  for (int t = 1; t < TT; ++t)
    if (sub == t) out = r[t];
  if (sub < TT && t0 + sub < T)
    y[static_cast<size_t>(t0 + sub) * N + row] = out;
}

// The line sums of the staged x tile: xsum[q] = the sum of line q's G
// values in order, q over (line, token); a line is a group at g <= 32, a
// 32-column part above
template <typename T, int TT, int G>
__device__ __forceinline__ void stage_sums(const uint8_t* xg, float* xsum,
                                           int groups) {
  using L = Tile<T, TT, G>;
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
}

template <typename T, int TT, int G>
__global__ void __launch_bounds__(kThreads, 1)
gqsa_gemv_stream_kernel(const Args a) {
  constexpr int kLine = Width<G>::kLine, kItems = Width<G>::kItems;
  using L = Tile<T, TT, kLine>;
  using V = typename Codes<G>::type;
  extern __shared__ __align__(16) uint8_t smem[];
  const int groups = a.K / kLine;                      // staged lines
  uint8_t* xg = smem;                                  // [groups][TT][kLine]
  float* xsum = reinterpret_cast<float*>(
      smem + x_bytes(a.K, TT, sizeof(T)));             // [groups][TT]
  Stage<G>* ring = reinterpret_cast<Stage<G>*>(
      smem + x_bytes(a.K, TT, sizeof(T)) + sum_bytes(a.K, kLine, TT));
  const V* vals = static_cast<const V*>(a.vals);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = (blockIdx.x % a.n_tiles) * TT;
  const int W = gridDim.x / a.n_tiles * kWarps;        // the tile's warps
  const int r0 = blockIdx.x / a.n_tiles * kWarps + warp;
  const int items = a.M * kItems;                      // work items a row
  const int trips = (items + 31) / 32;
  const int steps = r0 < a.N ? ((a.N - 1 - r0) / W + 1) * trips : 0;
  const int D = a.depth;
  Stage<G>* ring_w = ring + warp * D;

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
                   + c * kLine + part * L::kElems,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  }

  // the ring: each lane copies its own work item of every step (item m
  // of a row: part m % kItems of slot m / kItems)
  int ld_row = r0, ld_trip = 0, ld_stage = 0;
  auto load_next = [&]() {
    const int m = ld_trip * 32 + lane;
    if (m < items) {
      const size_t f = static_cast<size_t>(ld_row) * a.M + m / kItems;
      Stage<G>& st = ring_w[ld_stage];
      cp_async4(&st.idx[lane], a.idx + f, 4);
      cp_async4(&st.scale[lane], a.scale + f, 4);
      cp_async4(&st.zero[lane], a.zero + f, 4);
      cp_async_codes(&st.vals[lane],
                     vals + (static_cast<size_t>(ld_row) * items + m));
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

  cp_async_wait_ring<kDepth>(D);   // the x tile has landed (the ring may not)
  __syncthreads();
  stage_sums<T, TT, kLine>(xg, xsum, groups);
  __syncthreads();

  const int rq = lane & (L::kRot - 1);
  const int v = rq & (L::kParts - 1);
  const int u = rq / L::kParts;
  float acc[TT];
#pragma unroll
  for (int t = 0; t < TT; ++t) acc[t] = 0.f;
  int row = r0, trip = 0, stage = 0;
  for (int s = 0; s < steps; ++s) {
    if (s + D - 1 < steps) load_next();
    cp_async_commit();
    cp_async_wait_ring<kDepth>(D);   // this step's slot has landed
    const int m = trip * 32 + lane;
    if (m < items) {
      const Stage<G>& st = ring_w[stage];
      // padding slots carry idx -1: read group 0 instead (their scale is
      // 0, so they add nothing), as the TPU kernel's clamp does; a part
      // reads its own line of the group
      group<T, TT, kLine>(st.vals[lane],
                          max(st.idx[lane], 0) * kItems + m % kItems,
                          st.scale[lane], st.zero[lane], xg, xsum, u, v,
                          acc);
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

// Buffer rows of expert e that hold tokens, clipped to [0, C].
__device__ __forceinline__ int expert_rows(const ExpertArgs& a, int e) {
  return a.rows == nullptr ? a.C : min(max(a.rows[e], 0), a.C);
}

// The expert axis, any C in one launch. A work item is one occupied
// (expert, token tile) pair's output rows; the pairs are counted and
// ordered on the card, and block b takes the b-th of gridDim.x equal
// spans of all pairs' rows, in units of one pass of its warps. A span
// is cut into segments, one a pair: the block stages that expert's x tile
// (zeros at or past rows[e]) and its group sums, then each warp streams
// its rows of the segment through its ring, as the single-matrix kernel
// does. Buffer rows at or past rows[e] (all of an idle expert's) are
// written as zeros, strided over the grid; nothing of an idle expert, and
// no x row past rows[e], is read.
template <typename T, int TT, int G, int kRowLanes>
__global__ void __launch_bounds__(kThreads, 1)
gqsa_gemv_experts_kernel(const ExpertArgs a) {
  constexpr int kLine = Width<G>::kLine, kItems = Width<G>::kItems;
  using L = Tile<T, TT, kLine>;
  using V = typename Codes<G>::type;
  constexpr int kRowsPerWarp = 32 / kRowLanes;
  extern __shared__ __align__(16) uint8_t smem[];
  const int groups = a.K / kLine;                      // staged lines
  const int D = a.depth;
  uint8_t* xg = smem;                                  // [groups][TT][kLine]
  float* xsum = reinterpret_cast<float*>(
      smem + x_bytes(a.K, TT, sizeof(T)));             // [groups][TT]
  Stage<G>* ring = reinterpret_cast<Stage<G>*>(
      smem + x_bytes(a.K, TT, sizeof(T)) + sum_bytes(a.K, kLine, TT));
  int* ctrl = reinterpret_cast<int*>(ring + kWarps * D);
  const V* vals = static_cast<const V*>(a.vals);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the occupied pairs: thread i counts the token tiles of experts
  // [i * per, (i + 1) * per); a block scan gives each thread the index of
  // its first pair (`first`) and the block the count (`pairs`)
  const int per = (a.E + kThreads - 1) / kThreads;
  const int e_lo = min(static_cast<int>(threadIdx.x) * per, a.E);
  const int e_hi = min(e_lo + per, a.E);
  int mine = 0;
  for (int e = e_lo; e < e_hi; ++e) mine += (expert_rows(a, e) + TT - 1) / TT;
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) ctrl[warp] = incl;
  __syncthreads();
  int first = incl - mine, pairs = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = ctrl[w];
    if (w < warp) first += c;
    pairs += c;
  }

  // zeros for every buffer row at or past its expert's rows
  if (a.rows != nullptr) {
    const long long rows_all = static_cast<long long>(a.E) * a.C;
    for (long long i = blockIdx.x; i < rows_all; i += gridDim.x) {
      const int e = static_cast<int>(i / a.C);
      if (static_cast<int>(i % a.C) < expert_rows(a, e)) continue;
      float* yr = a.y + i * a.N;
      for (int n = threadIdx.x; n < a.N; n += kThreads) yr[n] = 0.f;
    }
  }

  // this block's span of the pairs' row units (kUnit rows each: one
  // pass of every warp)
  constexpr int kUnit = kWarps * kRowsPerWarp;
  const int units = (a.N + kUnit - 1) / kUnit;        // units a pair
  const long long total = static_cast<long long>(pairs) * units;
  const long long hi = total * (blockIdx.x + 1) / gridDim.x;
  const int items = a.M * kItems;                    // work items a row
  const int trips = (items + kRowLanes - 1) / kRowLanes;
  const int sub = lane & (kRowLanes - 1);            // lane within the row
  const int rq = lane & (L::kRot - 1);
  const int v = rq & (L::kParts - 1);
  const int u = rq / L::kParts;
  Stage<G>* ring_w = ring + warp * D;
  for (long long f = total * blockIdx.x / gridDim.x; f < hi;) {
    const int p = static_cast<int>(f / units);
    const long long base = static_cast<long long>(p) * units;
    const int n0 = static_cast<int>(f - base) * kUnit;
    const int n1 = min(static_cast<int>(min(hi - base,
                                            static_cast<long long>(units)))
                       * kUnit, a.N);
    f = base + units;
    // the pair's expert and tile, found by the thread that counted it
    __syncthreads();   // the last segment's x tile and sums are read out
    if (first <= p && p < first + mine) {
      int c = first;
      for (int e = e_lo; e < e_hi; ++e) {
        const int n_t = (expert_rows(a, e) + TT - 1) / TT;
        if (p < c + n_t) {
          ctrl[kWarps] = e;
          ctrl[kWarps + 1] = p - c;
          break;
        }
        c += n_t;
      }
    }
    __syncthreads();
    const int e = ctrl[kWarps];
    const int t0 = ctrl[kWarps + 1] * TT;
    const int R = expert_rows(a, e);

    // the expert's x tile (zeros at or past R), in the line layout
    {
      const T* x = static_cast<const T*>(a.x);
      const size_t x0 = (static_cast<size_t>(e) * a.C + t0) * a.K;
      for (int q = threadIdx.x; q < groups * L::kChunks; q += kThreads) {
        const int part = q % L::kParts;
        const int t = (q / L::kParts) % TT;
        const int c = q / L::kChunks;
        const bool ok = t0 + t < R;
        cp_async16(xg + 16 * q,
                   x + (ok ? x0 + static_cast<size_t>(t) * a.K : 0)
                     + c * kLine + part * L::kElems,
                   ok ? 16 : 0);
      }
      cp_async_commit();
    }

    // the ring over this warp's rows: a pass takes kRowsPerWarp rows from
    // n0 + warp * kRowsPerWarp, the next pass kUnit rows on, up to n1;
    // lane l works on the pass's row l / kRowLanes
    const size_t eoff = static_cast<size_t>(e) * a.N * a.M;
    const int r0 = n0 + warp * kRowsPerWarp;
    const int steps = r0 < n1 ? ((n1 - 1 - r0) / kUnit + 1) * trips : 0;
    int ld_row = r0 + lane / kRowLanes, ld_trip = 0, ld_stage = 0;
    auto load_next = [&]() {
      const int m = ld_trip * kRowLanes + sub;
      if (m < items && ld_row < n1) {
        const size_t fo = eoff + static_cast<size_t>(ld_row) * a.M
            + m / kItems;
        Stage<G>& st = ring_w[ld_stage];
        cp_async4(&st.idx[lane], a.idx + fo, 4);
        cp_async4(&st.scale[lane], a.scale + fo, 4);
        cp_async4(&st.zero[lane], a.zero + fo, 4);
        cp_async_codes(&st.vals[lane],
                       vals + ((eoff + static_cast<size_t>(ld_row) * a.M)
                               * kItems + m));
      }
      if (++ld_stage == D) ld_stage = 0;
      if (++ld_trip == trips) {
        ld_trip = 0;
        ld_row += kUnit;
      }
    };
    for (int s = 0; s < D - 1; ++s) {
      if (s < steps) load_next();
      cp_async_commit();
    }

    cp_async_wait_ring<kExpertDepth>(D);   // the x tile has landed
    __syncthreads();
    stage_sums<T, TT, kLine>(xg, xsum, groups);
    __syncthreads();

    float* y = a.y + static_cast<size_t>(e) * a.C * a.N;
    float acc[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t] = 0.f;
    int row = r0 + lane / kRowLanes, trip = 0, stage = 0;
    for (int s = 0; s < steps; ++s) {
      if (s + D - 1 < steps) load_next();
      cp_async_commit();
      cp_async_wait_ring<kExpertDepth>(D);   // this step's slot has landed
      const int m = trip * kRowLanes + sub;
      if (m < items && row < n1) {
        const Stage<G>& st = ring_w[stage];
        group<T, TT, kLine>(st.vals[lane],
                            max(st.idx[lane], 0) * kItems + m % kItems,
                            st.scale[lane], st.zero[lane], xg, xsum, u, v,
                            acc);
      }
      if (++stage == D) stage = 0;
      if (++trip == trips) {   // every lane: the butterfly is warp-wide
        write_row<TT, kRowLanes>(acc, y, row, t0, row < n1 ? R : 0, a.N,
                                 lane, u);
#pragma unroll
        for (int t = 0; t < TT; ++t) acc[t] = 0.f;
        trip = 0;
        row += kUnit;
      }
    }
  }
}

template <typename T, int TT, int G, int kRowLanes>
auto kernel_of(const Args&) { return gqsa_gemv_stream_kernel<T, TT, G>; }

template <typename T, int TT, int G, int kRowLanes>
auto kernel_of(const ExpertArgs&) {
  return gqsa_gemv_experts_kernel<T, TT, G, kRowLanes>;
}

// One kernel instantiation (its arguments' type picks the kernel; the
// expert kernel's lanes a row, kRowLanes, too), with its shared-memory
// limit raised once per device.
template <typename T, int TT, int G, int kRowLanes, typename A>
int launch(const A& a, int blocks, size_t smem, cudaStream_t stream) {
  static unsigned sized = 0;       // devices whose limit is raised
  const auto kernel = kernel_of<T, TT, G, kRowLanes>(a);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 32 && !(sized & (1u << dev))) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized |= 1u << dev;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of x's type and token tile `tt` (takes_tile).
template <int G, int kRowLanes, typename A>
int launch_tile(const A& a, int x_is_bf16, int tt, int blocks, size_t smem,
                cudaStream_t s) {
  using B = __nv_bfloat16;
  if (x_is_bf16) {
    switch (tt) {
      case 1: return launch<B, 1, G, kRowLanes>(a, blocks, smem, s);
      case 2: return launch<B, 2, G, kRowLanes>(a, blocks, smem, s);
      case 4: return launch<B, 4, G, kRowLanes>(a, blocks, smem, s);
      default: return launch<B, 8, G, kRowLanes>(a, blocks, smem, s);
    }
  }
  switch (tt) {
    case 1: return launch<float, 1, G, kRowLanes>(a, blocks, smem, s);
    case 2: return launch<float, 2, G, kRowLanes>(a, blocks, smem, s);
    default: return launch<float, 4, G, kRowLanes>(a, blocks, smem, s);
  }
}

// The instantiation of the group size `g` (takes_group).
template <int kRowLanes = 32, typename A>
int launch_group(const A& a, int g, int x_is_bf16, int tt, int blocks,
                 size_t smem, cudaStream_t s) {
  switch (g) {
    case 8:
      return launch_tile<8, kRowLanes>(a, x_is_bf16, tt, blocks, smem, s);
    case 16:
      return launch_tile<16, kRowLanes>(a, x_is_bf16, tt, blocks, smem, s);
    case 32:
      return launch_tile<32, kRowLanes>(a, x_is_bf16, tt, blocks, smem, s);
    case 64:
      return launch_tile<64, kRowLanes>(a, x_is_bf16, tt, blocks, smem, s);
    default:
      return launch_tile<128, kRowLanes>(a, x_is_bf16, tt, blocks, smem, s);
  }
}

}  // namespace streaming

}  // namespace

// One matrix, any T: x [T, K] (f32 or bf16), y [T, N] f32, group size
// `g` (8, 16, 32, 64 or 128; K a multiple of it). `tt`: x rows a token
// tile (1, 2, 4, 8; f32 x at most 4); `n_tiles` = ceil(T / tt);
// `blocks`: a multiple of n_tiles; `smem`: the block's dynamic shared memory as the wrapper's
// plan counts it (kernels/gqsa_gemv.py:smem_bytes), refused unless it is
// this layout's. Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
extern "C" int gqsa_gemv_launch(const void* x, int x_is_bf16,
                                const void* idx, const void* vals,
                                const void* scale, const void* zero, void* y,
                                int T, int N, int M, int K, int g, int tt,
                                int n_tiles, int blocks, long long smem,
                                void* stream) {
  const int elem = x_is_bf16 ? 2 : 4;
  if (!streaming::takes_group(g) || T < 1 || N < 1 || M < 1 || K < g
      || K % g != 0 || !streaming::takes_tile(tt, x_is_bf16)
      || n_tiles != (T + tt - 1) / tt || blocks < n_tiles
      || blocks % n_tiles != 0
      || smem != static_cast<long long>(streaming::smem_bytes(K, g, tt, elem))
      || smem > streaming::kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const streaming::Args a{x, static_cast<const int32_t*>(idx), vals,
                          static_cast<const float*>(scale),
                          static_cast<const float*>(zero),
                          static_cast<float*>(y), T, N, M, K, n_tiles,
                          streaming::kDepth};
  return streaming::launch_group(a, g, x_is_bf16, tt, blocks,
                                 static_cast<size_t>(smem),
                                 static_cast<cudaStream_t>(stream));
}

// The expert axis, any C: x [E, C, K] (f32 or bf16), y [E, C, N] f32,
// stacked leaves [E, N, M(, g/2)], group size `g` as gqsa_gemv_launch
// takes it; rows [E] int32 (buffer rows of each expert that hold tokens)
// or null (all C). `tt`: buffer rows a token tile, as gqsa_gemv_launch
// takes it; `row_lanes`: lanes a row, 32 or 16 (two rows a warp);
// `blocks`: any grid (the wrapper's plan: one block an SM); `smem`: as
// kernels/gqsa_gemv.py:experts_plan counts it, refused unless it is this
// layout's. Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
extern "C" int gqsa_gemv_experts_launch(const void* x, int x_is_bf16,
                                        const void* idx, const void* vals,
                                        const void* scale, const void* zero,
                                        void* y, const void* rows, int E,
                                        int C, int N, int M, int K, int g,
                                        int tt, int row_lanes, int blocks,
                                        long long smem, void* stream) {
  const int elem = x_is_bf16 ? 2 : 4;
  if (!streaming::takes_group(g) || E < 1 || E > 65535 || C < 1
      || static_cast<long long>(E) * C > (1 << 30)
      || N < 1 || M < 1 || K < g || K % g != 0
      || !streaming::takes_tile(tt, x_is_bf16)
      || (row_lanes != 16 && row_lanes != 32) || blocks < 1
      || smem != static_cast<long long>(
             streaming::experts_smem_bytes(K, g, tt, elem))
      || smem > streaming::kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const streaming::ExpertArgs a{x, static_cast<const int32_t*>(idx), vals,
                                static_cast<const float*>(scale),
                                static_cast<const float*>(zero),
                                static_cast<float*>(y),
                                static_cast<const int32_t*>(rows), E, C, N,
                                M, K, streaming::kExpertDepth};
  const size_t sm = static_cast<size_t>(smem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return row_lanes == 16
      ? streaming::launch_group<16>(a, g, x_is_bf16, tt, blocks, sm, s)
      : streaming::launch_group<32>(a, g, x_is_bf16, tt, blocks, sm, s);
}
