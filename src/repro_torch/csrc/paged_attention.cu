// Paged decode attention (plain, int8, tree and latent modes) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/paged_attention.py:paged_attention_pallas in its plain
// mode (bf16/f32 pages), its int8 mode (int8 pages with f32 per-token
// scales), its tree mode (ancestor bitmaps over the fed window, which
// token-tree speculation runs at every draft level and verify) and its
// latent mode (v_pages = None: the MLA latent pool, which every
// DeepSeek-V2 decode step runs in every layer).
//
// Attention computed in place on the paged KV pool, with no dense page
// gather. Layouts (one layer's view of the pool):
//   q            [B, KH, TR, D] f32   query rows grouped by KV head,
//                                     T-major inside the row dim (TR = T*R)
//   k/v_pages    [P, PS, KH, D]       bf16, f32 or int8
//   k/v_scales   [P, PS, KH] f32      int8 mode only (null otherwise)
//   lengths      [B, T] int32         query t sees positions < lengths[b,t]
//   block_tables [B, MP] int32        page ids; entries >= P are sentinels
//   live         [B] int32            pages to visit (ceil(max_t len / PS))
//   anc          [B, T] int32         tree mode only (null otherwise): for
//   anc_base     [B] int32            a position s with 0 <= s - anc_base[b]
//   window       int                  < window, query t also needs bit
//                                     s - anc_base[b] of anc[b, t]
//   out          [B, KH, TR, DV] f32  (DV = D outside the latent mode)
//   workspace    [B, KH, S, TR, DV] f32 partial acc, then [B, KH, S, TR]
//                float2 (m, l): S > 1 only
// Scale 1/sqrt(D). A row whose length is 0 returns exact zeros.
//
// Bound on the card: bytes. Each live K/V element is read once and used
// for 2*TR flops per operand, below the bf16 tensor cores' flop/byte
// balance, so the floor is the live K/V bytes (int8: codes plus scales)
// over 3.35 TB/s. A tree verify of T = 29 rows does 29x the operations on
// the same bytes and the latent mode serves 128 rows from every row it
// reads: there this kernel's f32 products outlast the bytes.
//
// One page walk, paged_attention_split_kernel, runs every mode:
//   Split. The grid is (split x row group, KV head, slot). Split s of S
//     takes the slot's live pages s, s+S, s+2S, ... (strided, so a 2-page
//     request still uses two splits) and writes, per query row, its
//     partial (m, l, acc[DV]) to a workspace the wrapper allocates; a
//     second small kernel (paged_attention_combine_kernel, one block a
//     row) merges the S partials in split order: m = max m_i,
//     l = sum l_i e^(m_i - m), o = sum acc_i e^(m_i - m) / l. No atomics
//     touch the data, so two launches give bit-identical output. S comes
//     from host-known shapes only (slots, KV heads, row groups and the
//     block-table width; kernels/paged_attention.py:split_count), never
//     from live or lengths, so the decode step stays free of host syncs.
//     With S = 1 the split kernel normalises and writes the output
//     itself.
//   Whole dot products. Warps go over query rows and lanes over positions
//     (lane and lane + 32 of a chunk; a chunk of at most 32 positions
//     computes only the first): a thread computes whole q.k products over
//     D with no shuffles, q a broadcast read from shared memory, each
//     staged K row padded by 16 bytes and read as 16-byte vectors, so the
//     eight threads of a quarter-warp hit distinct banks. The softmax
//     statistics are computed once per chunk of pages, in registers of
//     the warp that owns the row (two 5-step shuffles a row a chunk). A
//     warp's rows have no branch between them, so their FMA chains
//     interleave. A block takes up to 32 rows (kSplitRows; 256 threads,
//     else 128), so a tree verify of T <= 31 walks K/V once per split,
//     not once per row group.
//   Several pages in flight. A chunk of up to 64 positions (4 pages of
//     16) is staged raw (bf16 stays bf16, int8 stays int8) with cp.async
//     16-byte copies, into a double-buffered ring when a split has more
//     than one chunk, and converted to f32 where it is read; q rides in
//     the first chunk's copies. In P.V a
//     thread owns a pair of adjacent output columns of a group of rows
//     (kGroups groups: 2 * threads / kGroups >= DV), so a V row is read as
//     pairs and each probability (a float4 broadcast of 4 positions)
//     serves two columns.
//   The contractions stay in f32 on CUDA cores. With 29 rows the score
//     and P.V loops issue about one shared-memory read (the broadcast q
//     and probabilities) per two to four FMA instructions, so by count
//     they are bound by shared memory, not by the f32 rate; tensor cores
//     are the next step there. Sentinel pages clamp to P-1 and are masked
//     by length; the -inf guards of the TPU kernel are kept: a split with
//     no visible position for a row writes m = -inf, l = 0, which the
//     combine skips, and a row of length 0 ends as zeros. Tree mode adds
//     one mask term: a position inside the fed window is visible to a row
//     only if the row's ancestor bit for it is set (the shift stays in
//     0..31).
//
// int8 mode (Page = int8_t, plain and tree): the codes are staged raw, 16
// a vector (D = 128 is 8 vectors and the pad), and each token's K and V
// scales are staged into the 16-byte pads of its K and V rows with 4-byte
// cp.async.ca copies (the scales of one head lie KH * 4 bytes apart, too
// sparse for 16-byte copies). The scales are folded in, not multiplied
// into every code: a score is (q . codes) * (k_scale / sqrt(D)), and the
// probability that enters P.V is e^(s - m) * v_scale against the raw
// codes, while l sums the unscaled e^(s - m). That saves 2*D multiplies a
// position over dequantizing each code (the TPU kernel's order); the sums
// are equal up to f32 rounding. kernels/ref.py:paged_attention_split_ref
// does the same math.
//
// Latent mode (v_pages null, bf16/f32 pages): the pool holds one logical
// KV head, KH = 1, of D = kv_lora_rank + qk_rope_dim = 576 at DeepSeek-V2
// width, and a token's value is the leading DV = kv_lora_rank = 512 dims
// of its own row. So a chunk stages one ring of rows, not two, and P.V
// reads V from the staged K rows. Past DV = 256 a block takes kWideRows =
// 16 rows and 256 threads in one group (each thread a column pair over
// DV = 512 for all 16 rows): decode's T*H = 128 rows on the one head make
// 8 row groups a slot. 16 rows, not 32, because the latent mode is bound
// by the score loop's broadcast reads of q, which grow with rows x D x
// chunks: at serve lengths 2 live pages leave few splits, so more, smaller
// row groups keep the card busy; and q of 16 rows x 576 f32 (36,864 bytes)
// leaves room for a double-buffered ring of 4 bf16 pages (149,504), so a
// lane scores two positions a chunk, which halves the q reads per score.
// scripts/wide_rows.py times kWideRows in {8, 16, 32} on the card
// (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kSplitRows = 32;      // query rows a block (a row group)
constexpr int kSplitPos = 64;       // positions a chunk: lane, lane + 32
constexpr int kWideRows = 16;       // rows a block past DV = 256 (latent)
constexpr int kMaxValueDim = 512;   // a column pair a thread, 256 threads
constexpr int kCombineThreads = 128;
constexpr int kDefaultSmem = 48 * 1024;  // dynamic smem without opting in
constexpr int kMaxSmem = 232448;         // Hopper's opt-in limit a block

// Everything a launch needs, passed to the kernel by value.
struct Args {
  const float* q;             // 16-byte aligned
  const void* k_pages;
  const void* v_pages;        // null: the latent mode
  const float* k_scales;      // int8 mode only
  const float* v_scales;
  const int32_t* lengths;
  const int32_t* block_tables;
  const int32_t* live;
  const int32_t* anc;         // null outside the tree mode
  const int32_t* anc_base;
  float* out;
  float* part_acc;            // S > 1: [B, KH, S, TR, DV]
  float2* part_ml;            // S > 1: [B, KH, S, TR]
  int window, B, KH, TR, T, D, DV, P, PS, MP, n_split;
  int chunk_pages, n_stages;  // set by launch_split
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// a staged 16-byte vector as f32 values
__device__ __forceinline__ void unpack16(const uint4& u, float* o, float) {
  const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = f[i];
}

__device__ __forceinline__ void unpack16(const uint4& u, float* o,
                                         __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack16(const uint4& u, float* o, int8_t) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    o[i] = static_cast<float>(
        static_cast<int8_t>((w[i >> 2] >> (8 * (i & 3))) & 0xFFu));
}

// two adjacent values of a staged row (2-, 4- or 8-byte aligned)
__device__ __forceinline__ float2 load_pair(const unsigned char* p, float) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const unsigned char* p,
                                            __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const unsigned char* p, int8_t) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

// a compile-time count of positions a lane scores
template <int N>
struct Lanes {
  static constexpr int value = N;
};

// One block per (split, row group of kRows) x KV head x slot, of kThreads
// threads. Scores: warps over rows, lanes over positions. P.V: thread t
// owns the column pair 2 * (t % n2), 2 * (t % n2) + 1 (n2 = kThreads /
// kGroups >= DV / 2) of the rows r with r % kGroups == t / n2, so a staged
// V row is read as pairs and each probability read serves two columns.
// Shared memory:
// [n_stages][K, V (not in the latent mode)][cpos][rowb] raw page rows
// (rowb = D * size + 16 bytes; int8: the token's scale in the pad), then
// q [kRows][D] f32, probabilities [kRows][kSplitPos] f32, and the per-row
// correction factor and denominator [kRows] each.
template <typename Page, int kRows, int kGroups, int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_split_kernel(const Args a) {
  constexpr int E = 16 / sizeof(Page);   // elements a 16-byte vector
  constexpr bool kInt8 = std::is_same<Page, int8_t>::value;
  constexpr int kRPW = (kRows + kThreads / 32 - 1) / (kThreads / 32);
  constexpr int kAcc = kRows / kGroups;  // rows a thread accumulates
  const int D = a.D, DV = a.DV, PS = a.PS, TR = a.TR;
  const int n_split = a.n_split, chunk_pages = a.chunk_pages;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int split = blockIdx.x % n_split;
  const int r0 = (blockIdx.x / n_split) * kRows;  // this row group
  const int nr = min(kRows, TR - r0);
  const bool tree = a.anc != nullptr;
  const bool latent = a.v_pages == nullptr;      // V: the K row's lead
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = kThreads;
  const int nwarps = kThreads / 32;
  constexpr int kPairs = kThreads / kGroups;     // >= DV / 2
  const int col = 2 * (tid % kPairs);            // this thread's columns
  const int grp = tid / kPairs;                  // and its rows' residue
  const int R = TR / a.T;
  const size_t row0 = (static_cast<size_t>(b) * a.KH + kh) * TR + r0;
  const size_t part0 =
      ((static_cast<size_t>(b) * a.KH + kh) * n_split + split) * TR + r0;

  const int n_live = min(max(a.live[b], 0), a.MP);
  // this split's pages: split, split + S, ... below n_live
  const int n_mine =
      split < n_live ? (n_live - split + n_split - 1) / n_split : 0;
  if (n_mine == 0) {
    if (n_split == 1) {
      for (int e = tid; e < nr * DV; e += nthreads)
        a.out[row0 * DV + e] = 0.f;
    } else if (tid < nr) {
      a.part_ml[part0 + tid] = make_float2(-INFINITY, 0.f);
    }
    return;
  }

  const int rowb = D * static_cast<int>(sizeof(Page)) + 16;
  const int cpos = chunk_pages * PS;
  const size_t stage_bytes = static_cast<size_t>(latent ? 1 : 2) * cpos
                             * rowb;
  extern __shared__ __align__(16) unsigned char split_smem[];
  unsigned char* ring = split_smem;
  float* q_s = reinterpret_cast<float*>(ring + a.n_stages * stage_bytes);
  float* p_s = q_s + kRows * D;          // [kRows][kSplitPos]
  float* c_s = p_s + kRows * kSplitPos;  // [kRows] correction factor
  float* l_s = c_s + kRows;              // [kRows] denominator
  __shared__ int len_s[kRows];
  __shared__ int anc_s[kRows];

  const int vrow = D * static_cast<int>(sizeof(Page)) / 16;  // vectors a row
  const unsigned char* kg = static_cast<const unsigned char*>(a.k_pages);
  const unsigned char* vg = static_cast<const unsigned char*>(a.v_pages);
  const int32_t* table = a.block_tables + static_cast<size_t>(b) * a.MP;
  // stage chunk c (this split's pages c*chunk_pages ...) raw into `stage`
  auto issue = [&](int c, int stage) {
    const int j0 = c * chunk_pages;
    const int nvec = min(chunk_pages, n_mine - j0) * PS * vrow;
    unsigned char* kd = ring + stage * stage_bytes;
    unsigned char* vd = kd + static_cast<size_t>(cpos) * rowb;
    for (int v = tid; v < nvec; v += nthreads) {
      const int p = v / vrow;           // position in the chunk
      const int x = v - p * vrow;       // vector in the row
      const int jj = p / PS;
      const int s = p - jj * PS;
      // sentinel entries (>= P) clamp to the last page; their positions
      // are masked by the length below
      const int page =
          min(max(__ldg(table + split + (j0 + jj) * n_split), 0), a.P - 1);
      const size_t tok = (static_cast<size_t>(page) * PS + s) * a.KH + kh;
      const size_t off = tok * D * sizeof(Page) + static_cast<size_t>(x) * 16;
      cp_async16(kd + p * rowb + x * 16, kg + off);
      if (!latent) cp_async16(vd + p * rowb + x * 16, vg + off);
      if (kInt8 && x == 0) {          // the token's scales, in the pads
        cp_async4(kd + p * rowb + D, a.k_scales + tok);
        cp_async4(vd + p * rowb + D, a.v_scales + tok);
      }
    }
  };
  // q rides in the first chunk's copy group: 16-byte copies all in
  // flight at once (a load-then-store loop waits a memory round trip per
  // iteration, 36 of them for 16 latent rows of 576)
  const float* qg = a.q + row0 * D;
  for (int v = tid; v < nr * D / 4; v += nthreads)
    cp_async16(q_s + 4 * v, qg + 4 * v);
  issue(0, 0);
  cp_async_commit();

  if (tid < nr) {
    const int t = (r0 + tid) / R;
    len_s[tid] = a.lengths[b * a.T + t];
    anc_s[tid] = tree ? a.anc[b * a.T + t] : 0;
  }
  const int base = tree ? a.anc_base[b] : 0;

  float m_r[kRPW], l_r[kRPW];   // rows warp + i * nwarps, lane-replicated
#pragma unroll
  for (int i = 0; i < kRPW; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
  }
  float2 acc[kAcc];             // columns col, col + 1 of rows grp + kGroups a
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = make_float2(0.f, 0.f);

  const int n_chunks = (n_mine + chunk_pages - 1) / chunk_pages;
  for (int c = 0; c < n_chunks; ++c) {
    const int stage = a.n_stages == 2 ? (c & 1) : 0;
    if (a.n_stages == 2) {      // the next chunk's copies fly meanwhile
      if (c + 1 < n_chunks) issue(c + 1, (c + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* ks = ring + stage * stage_bytes;
    const unsigned char* vs =
        latent ? ks : ks + static_cast<size_t>(cpos) * rowb;
    const int j0 = c * chunk_pages;
    const int npos = min(chunk_pages, n_mine - j0) * PS;

    // scores: lane holds positions lane and lane + 32 of the chunk for
    // each of its warp's rows; whole dot products over D. A lane past the
    // chunk reads the chunk's last row and is masked below. kmul is the
    // score's factor (int8: times the token's k scale), vmul the
    // probability's (int8: the token's v scale).
    bool in[2];
    int pos[2];
    const unsigned char* krow[2];
    float kmul[2], vmul[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int p = lane + 32 * j;
      const int pc = min(p, npos - 1);
      in[j] = p < npos;
      const int jj = p / PS;
      pos[j] = (split + (j0 + jj) * n_split) * PS + (p - jj * PS);
      krow[j] = ks + pc * rowb;
      kmul[j] = kInt8 ? a.scale * *reinterpret_cast<const float*>(krow[j] + D)
                      : a.scale;
      vmul[j] = kInt8 ? *reinterpret_cast<const float*>(vs + pc * rowb + D)
                      : 1.f;
    }
    float sc[kRPW][2];
#pragma unroll
    for (int i = 0; i < kRPW; ++i) sc[i][0] = sc[i][1] = 0.f;
    // kJ positions a lane: 1 when the chunk has at most 32
    auto dots = [&](auto kj) {
      constexpr int kJ = decltype(kj)::value;
      for (int d0 = 0; d0 < D; d0 += E) {
        float kf[kJ][E];
#pragma unroll
        for (int j = 0; j < kJ; ++j)
          unpack16(*reinterpret_cast<const uint4*>(krow[j]
                                                   + d0 * sizeof(Page)),
                   kf[j], Page());
        // no branch per row, so the rows' FMA chains interleave: a row
        // past nr scores row nr - 1 and is never stored
#pragma unroll
        for (int i = 0; i < kRPW; ++i) {
          const int r = min(warp + i * nwarps, nr - 1);
          const float4* qv =
              reinterpret_cast<const float4*>(q_s + r * D + d0);
#pragma unroll
          for (int e4 = 0; e4 < E / 4; ++e4) {
            const float4 qq = qv[e4];
#pragma unroll
            for (int j = 0; j < kJ; ++j) {
              float x = sc[i][j];
              x = fmaf(qq.x, kf[j][4 * e4], x);
              x = fmaf(qq.y, kf[j][4 * e4 + 1], x);
              x = fmaf(qq.z, kf[j][4 * e4 + 2], x);
              x = fmaf(qq.w, kf[j][4 * e4 + 3], x);
              sc[i][j] = x;
            }
          }
        }
      }
    };
    if (warp < nr) {            // warp-uniform: the warp owns a row
      if (npos > 32)
        dots(Lanes<2>());
      else
        dots(Lanes<1>());
    }

    // online softmax statistics, once a chunk, in the owning warp
#pragma unroll
    for (int i = 0; i < kRPW; ++i) {
      const int r = warp + i * nwarps;
      if (r < nr) {
        float s2[2];
        bool ok[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          bool v = in[j] && pos[j] < len_s[r];
          if (tree) {  // inside the fed window only the row's ancestors
            const int fed = pos[j] - base;
            if (fed >= 0 && fed < a.window)
              v = v && ((anc_s[r] >> min(fed, 31)) & 1);
          }
          ok[j] = v;
          s2[j] = v ? sc[i][j] * kmul[j] : -INFINITY;
        }
        float mx = fmaxf(s2[0], s2[1]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_r[i];
        const float m_new = fmaxf(m_old, mx);
        const float m_safe = isinf(m_new) ? 0.f : m_new;
        const float e0 = ok[0] ? expf(s2[0] - m_safe) : 0.f;
        const float e1 = ok[1] ? expf(s2[1] - m_safe) : 0.f;
        float sum = e0 + e1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float corr = isinf(m_old) ? 0.f : expf(m_old - m_safe);
        l_r[i] = l_r[i] * corr + sum;
        m_r[i] = m_new;
        p_s[r * kSplitPos + lane] = kInt8 ? e0 * vmul[0] : e0;
        p_s[r * kSplitPos + lane + 32] = kInt8 ? e1 * vmul[1] : e1;
        if (lane == 0) {
          c_s[r] = corr;
          l_s[r] = l_r[i];
        }
      }
    }
    __syncthreads();

    // P.V (rows past nr carry values nothing stores)
    if (col < DV) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const float f = c_s[grp + kGroups * i];
        acc[i].x *= f;
        acc[i].y *= f;
      }
      const unsigned char* vcol = vs + col * sizeof(Page);
      int p = 0;
      for (; p + 4 <= npos; p += 4) {
        float2 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = load_pair(vcol + (p + u) * rowb, Page());
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const float4 pp = *reinterpret_cast<const float4*>(
              p_s + (grp + kGroups * i) * kSplitPos + p);
          float2 x = acc[i];
          x.x = fmaf(pp.x, v[0].x, x.x);
          x.y = fmaf(pp.x, v[0].y, x.y);
          x.x = fmaf(pp.y, v[1].x, x.x);
          x.y = fmaf(pp.y, v[1].y, x.y);
          x.x = fmaf(pp.z, v[2].x, x.x);
          x.y = fmaf(pp.z, v[2].y, x.y);
          x.x = fmaf(pp.w, v[3].x, x.x);
          x.y = fmaf(pp.w, v[3].y, x.y);
          acc[i] = x;
        }
      }
      for (; p < npos; ++p) {
        const float2 v = load_pair(vcol + p * rowb, Page());
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const float pr = p_s[(grp + kGroups * i) * kSplitPos + p];
          acc[i].x = fmaf(pr, v.x, acc[i].x);
          acc[i].y = fmaf(pr, v.y, acc[i].y);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the ring and p_s
    if (a.n_stages == 1 && c + 1 < n_chunks) {
      issue(c + 1, 0);
      cp_async_commit();
    }
  }

  if (n_split == 1) {
    if (col < DV) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int r = grp + kGroups * i;
        if (r < nr) {
          const float den = fmaxf(l_s[r], 1e-30f);
          *reinterpret_cast<float2*>(a.out + (row0 + r) * DV + col) =
              make_float2(acc[i].x / den, acc[i].y / den);
        }
      }
    }
    return;
  }
  if (col < DV) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int r = grp + kGroups * i;
      if (r < nr)
        *reinterpret_cast<float2*>(a.part_acc + (part0 + r) * DV + col) =
            acc[i];
    }
  }
#pragma unroll
  for (int i = 0; i < kRPW; ++i) {
    const int r = warp + i * nwarps;
    if (r < nr && lane == 0)
      a.part_ml[part0 + r] = make_float2(m_r[i], l_r[i]);
  }
}

// Merges the S partials of one (slot, KV head, row) a block, in split
// order. The (m, l) pairs are read at once into shared memory, and each
// thread's S partial values are independent loads, so the merge costs two
// memory round trips, not one per split. Splits with m = -inf (nothing
// visible) are skipped; a row with none left writes zeros.
__global__ void __launch_bounds__(kCombineThreads)
paged_attention_combine_kernel(
    const float* __restrict__ part_acc, const float2* __restrict__ part_ml,
    float* __restrict__ out, int TR, int DV, int n_split) {
  extern __shared__ float comb_smem[];
  float* m_s = comb_smem;                // [n_split]
  float* w_s = comb_smem + n_split;      // [n_split]
  const int row = blockIdx.x;            // (b * KH + kh) * TR + r
  const int bkh = row / TR;
  // split i of this row: part_ml[p0 + i * TR], part_acc[(p0 + i * TR) * DV]
  const size_t p0 =
      static_cast<size_t>(bkh) * n_split * TR + (row - bkh * TR);
  for (int i = threadIdx.x; i < n_split; i += blockDim.x) {
    const float2 ml = part_ml[p0 + static_cast<size_t>(i) * TR];
    m_s[i] = ml.x;
    w_s[i] = ml.y;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, m_s[i]);
  float l = 0.f;
  for (int i = 0; i < n_split; ++i)
    if (!isinf(m_s[i])) l = fmaf(w_s[i], expf(m_s[i] - m), l);
  float* o = out + static_cast<size_t>(row) * DV;
  for (int d = threadIdx.x; d < DV; d += blockDim.x) {
    float x = 0.f;
#pragma unroll 4
    for (int i = 0; i < n_split; ++i) {
      if (!isinf(m_s[i])) {
        const float y =
            part_acc[(p0 + static_cast<size_t>(i) * TR) * DV + d];
        x = fmaf(y, expf(m_s[i] - m), x);
      }
    }
    o[d] = isinf(m) ? 0.f : x / fmaxf(l, 1e-30f);
  }
}

// Shared memory of the split kernel for a chunk of `chunk_pages` pages;
// `rings` is 2 (K and V) or 1 (the latent mode).
size_t split_smem_bytes(int page_bytes, int D, int PS, int rows,
                        int chunk_pages, int n_stages, int rings) {
  return static_cast<size_t>(n_stages) * rings * chunk_pages * PS
             * (static_cast<size_t>(D) * page_bytes + 16)
         + sizeof(float) * (static_cast<size_t>(rows) * (D + kSplitPos)
                            + 2 * rows);
}

template <typename Page, int kRows, int kGroups, int kThreads>
int launch_split(Args a, cudaStream_t s) {
  // the largest chunk (<= the mode's positions, <= a split's pages) whose
  // ring fits; a second stage only when a split can have two chunks
  const bool latent = a.v_pages == nullptr;
  const int rings = latent ? 1 : 2;
  const int per_split = (a.MP + a.n_split - 1) / a.n_split;
  int chunk = std::max(1, std::min(kSplitPos / a.PS, per_split));
  int stages = per_split > chunk ? 2 : 1;
  size_t smem = split_smem_bytes(sizeof(Page), a.D, a.PS, kRows, chunk,
                                 stages, rings);
  while (smem > static_cast<size_t>(kMaxSmem) - 1024 && chunk > 1) {
    --chunk;
    stages = per_split > chunk ? 2 : 1;
    smem = split_smem_bytes(sizeof(Page), a.D, a.PS, kRows, chunk, stages,
                            rings);
  }
  if (smem > static_cast<size_t>(kMaxSmem) - 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_split_kernel<Page, kRows, kGroups, kThreads>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  a.chunk_pages = chunk;
  a.n_stages = stages;
  const int groups = (a.TR + kRows - 1) / kRows;
  const dim3 grid(a.n_split * groups, a.KH, a.B);
  paged_attention_split_kernel<Page, kRows, kGroups, kThreads>
      <<<grid, kThreads, smem, s>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return static_cast<int>(e);
  paged_attention_combine_kernel<<<a.B * a.KH * a.TR, kCombineThreads,
                                   2 * a.n_split * sizeof(float), s>>>(
      a.part_acc, a.part_ml, a.out, a.TR, a.DV, a.n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename Page>
int launch_split_rows(const Args& a, cudaStream_t s) {
  // the smallest row template that holds a block's rows and whose threads
  // cover DV in column pairs: 4 or 8 rows take 128 threads (DV <= 256);
  // 32 rows take 256 threads in four groups of 8 rows (DV <= 128) or two
  // of 16 (DV <= 256); past DV = 256, kWideRows rows take 256 threads in
  // one group
  if (a.DV > 256) return launch_split<Page, kWideRows, 1, 256>(a, s);
  if (a.TR <= 4) return launch_split<Page, 4, 1, 128>(a, s);
  if (a.TR <= 8) return launch_split<Page, 8, 1, 128>(a, s);
  if (a.DV <= 128) return launch_split<Page, kSplitRows, 4, 256>(a, s);
  return launch_split<Page, kSplitRows, 2, 256>(a, s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// page_kind: 0 f32 pages, 1 bf16 pages, 2 int8 pages with f32 scales
// (k_scales/v_scales, null in the other modes). anc/anc_base non-null
// select the tree mode (with the fed window's width), on any page kind.
// v_pages null selects the latent mode (KH = 1, bf16/f32 pages, the
// leading DV <= D columns of each row are its value); elsewhere DV = D.
// Every mode walks the pages over n_split splits (1 <= n_split <=
// max(MP, 1); DV even and <= 512, PS <= 64) with `workspace` of
// B*KH*n_split*TR*(DV + 2) floats when n_split > 1.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, int page_kind,
    const void* k_scales, const void* v_scales, const void* lengths,
    const void* block_tables, const void* live, const void* anc,
    const void* anc_base, int window, void* out, int B, int KH, int TR,
    int T, int D, int DV, int P, int PS, int MP, void* workspace,
    int n_split, void* stream) {
  const bool latent = v_pages == nullptr;
  const bool int8 = page_kind == 2;
  const int vec = int8 ? 16 : page_kind == 1 ? 8 : 4;
  if (page_kind < 0 || page_kind > 2 || TR < 1 || T < 1 || TR % T != 0
      || D < 1 || D % vec != 0 || DV < 2 || DV % 2 != 0
      || DV > kMaxValueDim || PS < 1 || PS > kSplitPos
      || (latent ? (int8 || KH != 1 || DV > D) : DV != D)
      || (int8 && (k_scales == nullptr || v_scales == nullptr))
      || n_split < 1 || n_split > std::max(MP, 1)
      || (n_split > 1 && workspace == nullptr)
      || (anc == nullptr) != (anc_base == nullptr) || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.block_tables = static_cast<const int32_t*>(block_tables);
  a.live = static_cast<const int32_t*>(live);
  a.anc = static_cast<const int32_t*>(anc);
  a.anc_base = static_cast<const int32_t*>(anc_base);
  a.out = static_cast<float*>(out);
  a.part_acc = static_cast<float*>(workspace);
  a.part_ml = n_split > 1
      ? reinterpret_cast<float2*>(a.part_acc
                                  + static_cast<size_t>(B) * KH * n_split
                                        * TR * DV)
      : nullptr;
  a.window = window;
  a.B = B;
  a.KH = KH;
  a.TR = TR;
  a.T = T;
  a.D = D;
  a.DV = DV;
  a.P = P;
  a.PS = PS;
  a.MP = MP;
  a.n_split = n_split;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8) return launch_split_rows<int8_t>(a, s);
  if (page_kind == 1) return launch_split_rows<__nv_bfloat16>(a, s);
  return launch_split_rows<float>(a, s);
}
