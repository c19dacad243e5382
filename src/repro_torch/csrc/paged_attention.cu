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
//   out          [B, KH, TR, DV] f32   (DV = D outside the latent mode)
//   workspace    [B, KH, S, TR, D] f32 partial acc, then [B, KH, S, TR]
//                float2 (m, l): the split path with S > 1 only
// Scale 1/sqrt(D). A row whose length is 0 returns exact zeros.
//
// Bound on the card: bytes. Each live K/V element is read once and used
// for 2*TR flops per operand, far below the f32 flop/byte balance, so the
// floor is the live K/V bytes (int8: codes plus scales) over 3.35 TB/s.
// A tree verify of T = 29 rows does 29x the operations on the same bytes
// and is bound by f32 operations instead.
//
// bf16/f32 pages, plain and tree modes (the split page walk,
// paged_attention_split_kernel; every decode step and every tree verify
// and draft level of the main path):
//   Split. The grid is (split x row group, KV head, slot). Split s of S
//     takes the slot's live pages s, s+S, s+2S, ... (strided, so a 2-page
//     request still uses two splits) and writes, per query row, its
//     partial (m, l, acc[D]) to a workspace the wrapper allocates; a
//     second small kernel (paged_attention_combine_kernel, one block a
//     row) merges the S partials in split order: m = max m_i,
//     l = sum l_i e^(m_i - m), o = sum acc_i e^(m_i - m) / l. No atomics
//     touch the data, so two launches give bit-identical output. S comes
//     from host-known shapes only (slots, KV heads, row groups and the
//     block-table width; kernels/paged_attention.py:split_count), never
//     from live or lengths, so the decode step stays free of host syncs.
//     With S = 1 the split kernel normalises and writes the output itself.
//   Whole dot products. Warps go over query rows and lanes over positions
//     (lane and lane + 32 of a chunk): a thread computes whole q.k
//     products over D with no shuffles, q a broadcast read from shared
//     memory, each staged K row padded by 16 bytes and read as 16-byte
//     vectors, so the eight threads of a quarter-warp hit distinct banks.
//     The softmax statistics are computed once per chunk of pages, in
//     registers of the warp that owns the row (two 5-step shuffles a row
//     a chunk). A block takes up to 32 rows (kSplitRows; 256 threads, else
//     128), so a tree verify of T <= 31 walks K/V once per split, not once
//     per row group.
//   Several pages in flight. A chunk of up to 64 positions (4 pages of
//     16) is staged raw (bf16 stays bf16) with cp.async 16-byte copies,
//     into a double-buffered ring when a split has more than one chunk,
//     and converted to f32 where it is read. In P.V a thread owns a pair
//     of adjacent output columns of a group of rows, so a V row is read
//     as pairs and each probability (a float4 broadcast of 4 positions)
//     serves two columns.
//   The contractions stay in f32 on CUDA cores. With 29 rows the score
//     and P.V loops issue about one shared-memory read (the broadcast q
//     and probabilities) per two to four FMA instructions, so by count
//     they are bound by shared memory, not by the f32 rate; tensor cores
//     are the next step there. Sentinel pages clamp to P-1 and are masked
//     by length; the -inf guards of the TPU kernel are kept: a split with
//     no visible position for a row writes m = -inf, l = 0, which the
//     combine skips, and a row of length 0 ends as zeros.
//
// int8 mode (paged_attention_kernel<int8_t, false>, plain and tree):
// one block per (slot, KV head, group of at most kMaxRows query rows),
// which loads its own block-table row and walks the slot's live pages in
// order with an online softmax (the TPU grid's sequential page axis
// becomes a loop in the block, since blocks carry nothing between each
// other). Each page's [PS, D] K and V tiles are fetched with coalesced
// 16-byte loads (a head's D values are contiguous in the pool), all
// issued at once into registers, so a page costs one memory round trip;
// the next page's loads are issued before the current page is computed,
// hiding that trip. Tiles are kept in shared memory as f32; warps compute
// the rows x PS scores with lane-split dot products and the softmax
// statistics with one warp per row; thread d owns output column d of
// every row. A 16-byte vector holds 16 codes of one token, and the
// token's K and V scales are loaded with it; each code is dequantised as
// code * scale while the tile is staged, before the f32 contractions, as
// the TPU kernel's body does (the reference's jnp path instead
// re-quantises q and the softmax weights for int8 x int8 products: not
// this kernel's math). Tree mode is the same walk with one more mask
// term: each row's ancestor bitmap and the slot's window base are loaded
// once per block, and a position inside the fed window is visible only
// if the row's bit for it is set (the shift stays in 0..31). Row groups:
// the per-thread accumulator holds kMaxRows rows (about 128 registers, no
// spill), so a block takes at most kMaxRows rows and a third grid axis
// covers the rest; every group walks its slot's pages. This walk moves to
// the split design in a later change.
//
// Latent mode (v_pages null, bf16/f32 pages): the pool holds one logical
// KV head, KH = 1, of D = kv_lora_rank + qk_rope_dim = 576 at DeepSeek-V2
// width, and a token's value is the leading DV = kv_lora_rank = 512 dims
// of its own row. So a page costs one tile fetch, not two, and the V tile
// is the K tile read with the same stride. Only the DV value columns are
// accumulated and written (each is independent of the others). Bound:
// operations at long lengths, since every page byte serves all T*H = 128
// query rows (2 x 128 x (576 + 512) flops per 1152 bytes of a bf16 row).
// Three limits of the plain-mode layout change here:
//   registers: one thread per column would be 576 threads of ~128
//     registers, over the 65,536 of a block, so a thread owns
//     kLatentCols = 2 value columns (256 threads at DV = 512); the freed
//     V staging registers stage twice as many K vectors;
//   shared memory: one f32 tile is ~37 KB and the launcher raises the
//     kernel's dynamic shared memory limit past the default 48 KB when
//     the rows need it (Hopper allows 227 KB a block);
//   row groups: decode has T*H = 128 rows on the one head. A block takes
//     kLatentRows = 4 of them, so a slot's pages are walked by 32 blocks
//     (128 at 4 slots, about one per SM): each re-stages every page (the
//     re-reads hit L2), but the walks run side by side. With the plain
//     modes' 16 rows a block, 32 blocks left 100 SMs idle and ran 3.1-3.5x
//     slower on an H100 (700 W; scripts/latent_rows.py, PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kMaxRows = 16;  // query rows per block (a row group)
constexpr int kLatentRows = 4;  // latent mode: rows per block
constexpr int kStage = 8;     // 16-byte vectors per thread per K/V tile
constexpr int kLatentCols = 2;  // latent mode: value columns per thread
constexpr int kDefaultSmem = 48 * 1024;  // dynamic smem without opting in
constexpr int kMaxSmem = 232448;         // Hopper's opt-in limit a block

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

template <typename Page>
struct TileLoader {
  // One page's [PS, D] K or V tile of one KV head, as 16-byte vectors:
  // vector v covers elements v*E .. v*E+E-1 of the tile (E = 16 / size of
  // Page), i.e. row s = v*E / D, columns d0 .. d0+E-1 (a head's D values
  // are contiguous in the pool).
  static constexpr int E = 16 / sizeof(Page);
  int nvec, D, KH;
  __device__ size_t offset(int v, size_t pbase) const {
    const int e = v * E;
    const int s = e / D;
    return pbase + static_cast<size_t>(s) * KH * D + (e - s * D);
  }
};

template <typename Page, bool kLatent>
__global__ void paged_attention_kernel(
    const float* __restrict__ q, const Page* __restrict__ k_pages,
    const Page* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ live, const int32_t* __restrict__ anc,
    const int32_t* __restrict__ anc_base, int window,
    float* __restrict__ out, int KH, int TR, int T, int D, int DV, int P,
    int PS, int MP, float scale) {
  // value columns per thread; vectors per thread per tile (the latent
  // mode stages one tile, so it takes the V tile's registers too)
  constexpr int kCols = kLatent ? kLatentCols : 1;
  constexpr int kStg = kLatent ? 2 * kStage : kStage;
  constexpr int kRows = kLatent ? kLatentRows : kMaxRows;  // a row group
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int r0 = blockIdx.z * kRows;         // this block's row group
  const int nr = min(kRows, TR - r0);
  const bool tree = anc != nullptr;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int R = TR / T;

  extern __shared__ float smem[];
  float* q_s = smem;              // [nr, D]
  float* k_s = q_s + nr * D;      // [PS, D]
  // [PS, D]; the latent mode's value is the K tile (row stride D)
  float* v_s = kLatent ? k_s : k_s + PS * D;
  float* p_s = v_s + PS * D;      // [nr, PS] scores, then probabilities
  float* m_s = p_s + nr * PS;     // [nr] running max
  float* l_s = m_s + nr;          // [nr] running denominator
  float* c_s = l_s + nr;          // [nr] this page's correction factor
  __shared__ int len_s[kMaxRows];
  __shared__ int anc_s[kMaxRows];  // tree mode: each row's ancestor bits
  const int base = tree ? anc_base[b] : 0;

  const size_t row0 = (static_cast<size_t>(b) * KH + kh) * TR + r0;
  const float* qb = q + row0 * D;
  for (int e = tid; e < nr * D; e += nthreads) q_s[e] = qb[e];
  if (tid < nr) {
    const int t = (r0 + tid) / R;
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
    len_s[tid] = lengths[b * T + t];
    anc_s[tid] = tree ? anc[b * T + t] : 0;
  }
  float acc[kCols * kRows];  // [column c][row r]
#pragma unroll
  for (int r = 0; r < kCols * kRows; ++r) acc[r] = 0.f;
  const int n_live = min(max(live[b], 0), MP);

  const TileLoader<Page> ld{PS * D / TileLoader<Page>::E, D, KH};
  const uint4* kv4 = reinterpret_cast<const uint4*>(k_pages);
  const uint4* vv4 = reinterpret_cast<const uint4*>(v_pages);
  constexpr int E = TileLoader<Page>::E;
  constexpr bool kInt8 = std::is_same<Page, int8_t>::value;
  uint4 kr[kStg], vr[kStg];
  float ksr[kStg], vsr[kStg];   // int8 mode: each vector's token scale
  // issue every load of page pi's tiles at once (register staging), so a
  // page costs one memory round trip, and the next page's loads are in
  // flight while the current page is computed
  auto fetch = [&](int pi) {
    // sentinel entries (>= P) clamp to the last page; their positions are
    // masked by the length below
    const int page = min(max(block_tables[static_cast<size_t>(b) * MP + pi],
                             0), P - 1);
    const size_t pbase = (static_cast<size_t>(page) * PS * KH + kh) * D;
#pragma unroll
    for (int j = 0; j < kStg; ++j) {
      const int v = j * nthreads + tid;
      if (v < ld.nvec) {
        const size_t o = ld.offset(v, pbase) / E;
        kr[j] = __ldg(kv4 + o);
        if (!kLatent) vr[j] = __ldg(vv4 + o);
        if (kInt8) {
          const size_t so = (static_cast<size_t>(page) * PS + v * E / D) * KH
                            + kh;
          ksr[j] = __ldg(k_scales + so);
          vsr[j] = __ldg(v_scales + so);
        }
      }
    }
  };
  if (n_live > 0) fetch(0);
  __syncthreads();

  for (int pi = 0; pi < n_live; ++pi) {
#pragma unroll
    for (int j = 0; j < kStg; ++j) {
      const int v = j * nthreads + tid;
      if (v < ld.nvec) {
        float kf[E], vf[E];
        unpack16(kr[j], kf, Page());
        if (!kLatent) unpack16(vr[j], vf, Page());
        if (kInt8) {  // dequantise before the f32 contractions
#pragma unroll
          for (int e = 0; e < E; ++e) {
            kf[e] *= ksr[j];
            vf[e] *= vsr[j];
          }
        }
        float4* kd = reinterpret_cast<float4*>(k_s + v * E);
        float4* vd = reinterpret_cast<float4*>(v_s + v * E);
#pragma unroll
        for (int e = 0; e < E / 4; ++e) {
          kd[e] = make_float4(kf[4 * e], kf[4 * e + 1], kf[4 * e + 2],
                              kf[4 * e + 3]);
          if (!kLatent)
            vd[e] = make_float4(vf[4 * e], vf[4 * e + 1], vf[4 * e + 2],
                                vf[4 * e + 3]);
        }
      }
    }
    __syncthreads();
    if (pi + 1 < n_live) fetch(pi + 1);

    for (int pr = warp; pr < nr * PS; pr += nwarps) {
      const int r = pr / PS;
      const int s = pr - r * PS;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32)
        dot = fmaf(q_s[r * D + d], k_s[s * D + d], dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) {
        const int pos = pi * PS + s;
        bool ok = pos < len_s[r];
        if (tree) {  // inside the fed window only the row's ancestors
          const int fed = pos - base;
          if (fed >= 0 && fed < window)
            ok = ok && ((anc_s[r] >> min(fed, 31)) & 1);
        }
        p_s[pr] = ok ? dot * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax statistics: one warp per row, lanes over positions
    for (int r = warp; r < nr; r += nwarps) {
      float* row = p_s + r * PS;
      const float m_old = m_s[r];
      float mx = -INFINITY;
      for (int s = lane; s < PS; s += 32) mx = fmaxf(mx, row[s]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      float sum = 0.f;
      for (int s = lane; s < PS; s += 32) {
        const float e = isinf(row[s]) ? 0.f : expf(row[s] - m_safe);
        row[s] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = isinf(m_old) ? 0.f : expf(m_old - m_safe);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // thread tid owns value columns tid + c * nthreads
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tid + c * nthreads;
      if (col < DV) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < nr) {
            float a = acc[c * kRows + r] * c_s[r];
            for (int s = 0; s < PS; ++s)
              a = fmaf(p_s[r * PS + s], v_s[s * D + col], a);
            acc[c * kRows + r] = a;
          }
        }
      }
    }
    __syncthreads();  // the next page overwrites k_s, v_s and p_s
  }

  float* ob = out + row0 * DV;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = tid + c * nthreads;
    if (col < DV) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr)
          ob[r * DV + col] = acc[c * kRows + r] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

template <typename Page, bool kLatent>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* lengths,
           const void* block_tables, const void* live, const void* anc,
           const void* anc_base, int window, void* out, int B, int KH,
           int TR, int T, int D, int DV, int P, int PS, int MP, int threads,
           size_t smem, cudaStream_t s) {
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    // above 48 KB only after opting in (per kernel, per device)
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<Page, kLatent>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows = kLatent ? kLatentRows : kMaxRows;   // a row group
  const dim3 grid(B, KH, (TR + rows - 1) / rows);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  paged_attention_kernel<Page, kLatent><<<grid, threads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const Page*>(k_pages),
      static_cast<const Page*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(live), static_cast<const int32_t*>(anc),
      static_cast<const int32_t*>(anc_base), window,
      static_cast<float*>(out), KH, TR, T, D, DV, P, PS, MP, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// The split page walk: bf16/f32 pages, plain and tree modes.
// ---------------------------------------------------------------------

constexpr int kSplitRows = 32;      // query rows a block (a row group)
constexpr int kSplitPos = 64;       // positions a chunk: lane, lane + 32
constexpr int kSplitMaxDim = 256;   // head dim: a column pair a thread
constexpr int kCombineThreads = 128;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// two adjacent values of a staged row (4- or 8-byte aligned)
__device__ __forceinline__ float2 load_pair(const unsigned char* p, float) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const unsigned char* p,
                                            __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// threads of a split block: 256 for the 32-row template, else 128
template <int kRows>
__host__ __device__ constexpr int split_threads() {
  return kRows > 8 ? 256 : 128;
}

// One block per (split, row group) x KV head x slot, of
// split_threads<kRows>() threads. Scores: warps over rows, lanes over
// positions. P.V: thread t owns the column pair 2 * (t % n2), 2 * (t % n2)
// + 1 (n2 = threads / kGroups >= D / 2) of the rows r with r % kGroups ==
// t / n2, so a staged V row is read as pairs and each probability read
// serves two columns. Shared memory:
// [n_stages][K, V][cpos][rowb] raw page rows (rowb = D * size + 16 bytes),
// then q [kRows][D] f32, probabilities [kRows][kSplitPos] f32, and the
// per-row correction factor and denominator [kRows] each.
template <typename Page, int kRows, int kGroups>
__global__ void __launch_bounds__(split_threads<kRows>(), 1)
paged_attention_split_kernel(
    const float* __restrict__ q, const Page* __restrict__ k_pages,
    const Page* __restrict__ v_pages, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ live, const int32_t* __restrict__ anc,
    const int32_t* __restrict__ anc_base, int window,
    float* __restrict__ out, float* __restrict__ part_acc,
    float2* __restrict__ part_ml, int KH, int TR, int T, int D, int P,
    int PS, int MP, int n_split, int chunk_pages, int n_stages,
    float scale) {
  constexpr int E = 16 / sizeof(Page);   // elements a 16-byte vector
  constexpr int kThreads = split_threads<kRows>();
  constexpr int kRPW = (kRows + kThreads / 32 - 1) / (kThreads / 32);
  constexpr int kAcc = kRows / kGroups;  // rows a thread accumulates
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int split = blockIdx.x % n_split;
  const int r0 = (blockIdx.x / n_split) * kSplitRows;
  const int nr = min(kSplitRows, TR - r0);       // <= kRows
  const bool tree = anc != nullptr;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = kThreads;
  const int nwarps = kThreads / 32;
  constexpr int kPairs = kThreads / kGroups;     // >= D / 2
  const int col = 2 * (tid % kPairs);            // this thread's columns
  const int grp = tid / kPairs;                  // and its rows' residue
  const int R = TR / T;
  const size_t row0 = (static_cast<size_t>(b) * KH + kh) * TR + r0;
  const size_t part0 =
      ((static_cast<size_t>(b) * KH + kh) * n_split + split) * TR + r0;

  const int n_live = min(max(live[b], 0), MP);
  // this split's pages: split, split + S, ... below n_live
  const int n_mine =
      split < n_live ? (n_live - split + n_split - 1) / n_split : 0;
  if (n_mine == 0) {
    if (n_split == 1) {
      for (int e = tid; e < nr * D; e += nthreads) out[row0 * D + e] = 0.f;
    } else if (tid < nr) {
      part_ml[part0 + tid] = make_float2(-INFINITY, 0.f);
    }
    return;
  }

  const int rowb = D * static_cast<int>(sizeof(Page)) + 16;
  const int cpos = chunk_pages * PS;
  extern __shared__ __align__(16) unsigned char split_smem[];
  unsigned char* ring = split_smem;
  float* q_s = reinterpret_cast<float*>(
      ring + static_cast<size_t>(n_stages) * 2 * cpos * rowb);
  float* p_s = q_s + kRows * D;          // [kRows][kSplitPos]
  float* c_s = p_s + kRows * kSplitPos;  // [kRows] correction factor
  float* l_s = c_s + kRows;              // [kRows] denominator
  __shared__ int len_s[kRows];
  __shared__ int anc_s[kRows];

  const int vrow = D * static_cast<int>(sizeof(Page)) / 16;  // vectors a row
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(k_pages);
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(v_pages);
  const int32_t* table = block_tables + static_cast<size_t>(b) * MP;
  // stage chunk c (this split's pages c*chunk_pages ...) raw into `stage`
  auto issue = [&](int c, int stage) {
    const int j0 = c * chunk_pages;
    const int nvec = min(chunk_pages, n_mine - j0) * PS * vrow;
    unsigned char* kd = ring + static_cast<size_t>(stage) * 2 * cpos * rowb;
    unsigned char* vd = kd + static_cast<size_t>(cpos) * rowb;
    for (int v = tid; v < nvec; v += nthreads) {
      const int p = v / vrow;           // position in the chunk
      const int x = v - p * vrow;       // vector in the row
      const int jj = p / PS;
      const int s = p - jj * PS;
      // sentinel entries (>= P) clamp to the last page; their positions
      // are masked by the length below
      const int page =
          min(max(__ldg(table + split + (j0 + jj) * n_split), 0), P - 1);
      const size_t off =
          ((static_cast<size_t>(page) * PS + s) * KH + kh) * D
              * sizeof(Page) + static_cast<size_t>(x) * 16;
      cp_async16(kd + p * rowb + x * 16, kg + off);
      cp_async16(vd + p * rowb + x * 16, vg + off);
    }
  };
  issue(0, 0);
  cp_async_commit();

  for (int e = tid; e < nr * D; e += nthreads) q_s[e] = q[row0 * D + e];
  if (tid < nr) {
    const int t = (r0 + tid) / R;
    len_s[tid] = lengths[b * T + t];
    anc_s[tid] = tree ? anc[b * T + t] : 0;
  }
  const int base = tree ? anc_base[b] : 0;

  float m_r[kRPW], l_r[kRPW];   // rows warp + i * nwarps, lane-replicated
#pragma unroll
  for (int i = 0; i < kRPW; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
  }
  float2 acc[kAcc];             // columns col, col + 1 of rows grp + kGroups a
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = make_float2(0.f, 0.f);

  const int n_chunks = (n_mine + chunk_pages - 1) / chunk_pages;
  for (int c = 0; c < n_chunks; ++c) {
    const int stage = n_stages == 2 ? (c & 1) : 0;
    if (n_stages == 2) {        // the next chunk's copies fly meanwhile
      if (c + 1 < n_chunks) issue(c + 1, (c + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* ks =
        ring + static_cast<size_t>(stage) * 2 * cpos * rowb;
    const unsigned char* vs = ks + static_cast<size_t>(cpos) * rowb;
    const int j0 = c * chunk_pages;
    const int npos = min(chunk_pages, n_mine - j0) * PS;

    // scores: lane holds positions lane and lane + 32 of the chunk for
    // each of its warp's rows; whole dot products over D. A lane past the
    // chunk reads the chunk's last row and is masked below.
    bool in[2];
    int pos[2];
    const unsigned char* krow[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int p = lane + 32 * j;
      in[j] = p < npos;
      const int jj = p / PS;
      pos[j] = (split + (j0 + jj) * n_split) * PS + (p - jj * PS);
      krow[j] = ks + min(p, npos - 1) * rowb;
    }
    float sc[kRPW][2];
#pragma unroll
    for (int i = 0; i < kRPW; ++i) sc[i][0] = sc[i][1] = 0.f;
    for (int d0 = 0; d0 < D; d0 += E) {
      float kf[2][E];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        unpack16(*reinterpret_cast<const uint4*>(krow[j] + d0 * sizeof(Page)),
                 kf[j], Page());
#pragma unroll
      for (int i = 0; i < kRPW; ++i) {
        const int r = warp + i * nwarps;
        if (r < nr) {           // warp-uniform
          const float4* qv = reinterpret_cast<const float4*>(q_s + r * D + d0);
#pragma unroll
          for (int e4 = 0; e4 < E / 4; ++e4) {
            const float4 qq = qv[e4];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float a = sc[i][j];
              a = fmaf(qq.x, kf[j][4 * e4], a);
              a = fmaf(qq.y, kf[j][4 * e4 + 1], a);
              a = fmaf(qq.z, kf[j][4 * e4 + 2], a);
              a = fmaf(qq.w, kf[j][4 * e4 + 3], a);
              sc[i][j] = a;
            }
          }
        }
      }
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
            if (fed >= 0 && fed < window)
              v = v && ((anc_s[r] >> min(fed, 31)) & 1);
          }
          ok[j] = v;
          s2[j] = v ? sc[i][j] * scale : -INFINITY;
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
        p_s[r * kSplitPos + lane] = e0;
        p_s[r * kSplitPos + lane + 32] = e1;
        if (lane == 0) {
          c_s[r] = corr;
          l_s[r] = l_r[i];
        }
      }
    }
    __syncthreads();

    // P.V (rows past nr carry values nothing stores)
    if (col < D) {
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
        const float c = c_s[grp + kGroups * a];
        acc[a].x *= c;
        acc[a].y *= c;
      }
      const unsigned char* vcol = vs + col * sizeof(Page);
      int p = 0;
      for (; p + 4 <= npos; p += 4) {
        float2 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = load_pair(vcol + (p + u) * rowb, Page());
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
          const float4 pp = *reinterpret_cast<const float4*>(
              p_s + (grp + kGroups * a) * kSplitPos + p);
          float2 x = acc[a];
          x.x = fmaf(pp.x, v[0].x, x.x);
          x.y = fmaf(pp.x, v[0].y, x.y);
          x.x = fmaf(pp.y, v[1].x, x.x);
          x.y = fmaf(pp.y, v[1].y, x.y);
          x.x = fmaf(pp.z, v[2].x, x.x);
          x.y = fmaf(pp.z, v[2].y, x.y);
          x.x = fmaf(pp.w, v[3].x, x.x);
          x.y = fmaf(pp.w, v[3].y, x.y);
          acc[a] = x;
        }
      }
      for (; p < npos; ++p) {
        const float2 v = load_pair(vcol + p * rowb, Page());
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
          const float pr = p_s[(grp + kGroups * a) * kSplitPos + p];
          acc[a].x = fmaf(pr, v.x, acc[a].x);
          acc[a].y = fmaf(pr, v.y, acc[a].y);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the ring and p_s
    if (n_stages == 1 && c + 1 < n_chunks) {
      issue(c + 1, 0);
      cp_async_commit();
    }
  }

  if (n_split == 1) {
    if (col < D) {
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
        const int r = grp + kGroups * a;
        if (r < nr) {
          const float den = fmaxf(l_s[r], 1e-30f);
          *reinterpret_cast<float2*>(out + (row0 + r) * D + col) =
              make_float2(acc[a].x / den, acc[a].y / den);
        }
      }
    }
    return;
  }
  if (col < D) {
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int r = grp + kGroups * a;
      if (r < nr)
        *reinterpret_cast<float2*>(part_acc + (part0 + r) * D + col) =
            acc[a];
    }
  }
#pragma unroll
  for (int i = 0; i < kRPW; ++i) {
    const int r = warp + i * nwarps;
    if (r < nr && lane == 0) part_ml[part0 + r] = make_float2(m_r[i], l_r[i]);
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
    float* __restrict__ out, int TR, int D, int n_split) {
  extern __shared__ float comb_smem[];
  float* m_s = comb_smem;                // [n_split]
  float* w_s = comb_smem + n_split;      // [n_split]
  const int row = blockIdx.x;            // (b * KH + kh) * TR + r
  const int bkh = row / TR;
  // split i of this row: part_ml[p0 + i * TR], part_acc[(p0 + i * TR) * D]
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
  float* o = out + static_cast<size_t>(row) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
#pragma unroll 4
    for (int i = 0; i < n_split; ++i) {
      if (!isinf(m_s[i])) {
        const float x = part_acc[(p0 + static_cast<size_t>(i) * TR) * D + d];
        a = fmaf(x, expf(m_s[i] - m), a);
      }
    }
    o[d] = isinf(m) ? 0.f : a / fmaxf(l, 1e-30f);
  }
}

// Shared memory of the split kernel for a chunk of `chunk_pages` pages.
size_t split_smem_bytes(int page_bytes, int D, int PS, int rows,
                        int chunk_pages, int n_stages) {
  return static_cast<size_t>(n_stages) * 2 * chunk_pages * PS
             * (static_cast<size_t>(D) * page_bytes + 16)
         + sizeof(float) * (static_cast<size_t>(rows) * (D + kSplitPos)
                            + 2 * rows);
}

template <typename Page, int kRows, int kGroups>
int launch_split(const void* q, const void* k_pages, const void* v_pages,
                 const void* lengths, const void* block_tables,
                 const void* live, const void* anc, const void* anc_base,
                 int window, void* out, void* workspace, int B, int KH,
                 int TR, int T, int D, int P, int PS, int MP, int n_split,
                 cudaStream_t s) {
  // the largest chunk (<= kSplitPos positions, <= a split's pages) whose
  // ring fits; a second stage only when a split can have two chunks
  const int per_split = (MP + n_split - 1) / n_split;
  int chunk = std::max(1, std::min(kSplitPos / PS, per_split));
  int stages = per_split > chunk ? 2 : 1;
  size_t smem = split_smem_bytes(sizeof(Page), D, PS, kRows, chunk, stages);
  while (smem > static_cast<size_t>(kMaxSmem) - 1024 && chunk > 1) {
    --chunk;
    stages = per_split > chunk ? 2 : 1;
    smem = split_smem_bytes(sizeof(Page), D, PS, kRows, chunk, stages);
  }
  if (smem > static_cast<size_t>(kMaxSmem) - 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_split_kernel<Page, kRows, kGroups>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int groups = (TR + kSplitRows - 1) / kSplitRows;
  const dim3 grid(n_split * groups, KH, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const size_t acc_floats = static_cast<size_t>(B) * KH * n_split * TR * D;
  float* part_acc = static_cast<float*>(workspace);
  float2* part_ml = n_split > 1
      ? reinterpret_cast<float2*>(part_acc + acc_floats) : nullptr;
  paged_attention_split_kernel<Page, kRows, kGroups>
      <<<grid, split_threads<kRows>(), smem, s>>>(
          static_cast<const float*>(q), static_cast<const Page*>(k_pages),
          static_cast<const Page*>(v_pages),
          static_cast<const int32_t*>(lengths),
          static_cast<const int32_t*>(block_tables),
          static_cast<const int32_t*>(live),
          static_cast<const int32_t*>(anc),
          static_cast<const int32_t*>(anc_base), window,
          static_cast<float*>(out), part_acc, part_ml, KH, TR, T, D, P, PS,
          MP, n_split, chunk, stages, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return static_cast<int>(e);
  paged_attention_combine_kernel<<<B * KH * TR, kCombineThreads,
                                   2 * n_split * sizeof(float), s>>>(
      part_acc, part_ml, static_cast<float*>(out), TR, D, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename Page>
int launch_split_rows(const void* q, const void* k_pages,
                      const void* v_pages, const void* lengths,
                      const void* block_tables, const void* live,
                      const void* anc, const void* anc_base, int window,
                      void* out, void* workspace, int B, int KH, int TR,
                      int T, int D, int P, int PS, int MP, int n_split,
                      cudaStream_t s) {
  // the smallest row template that holds a block's rows; 32 rows take
  // 256 threads in four groups of 8 rows (two of 16 where D > 128)
  if (TR <= 4)
    return launch_split<Page, 4, 1>(q, k_pages, v_pages, lengths,
                                    block_tables, live, anc, anc_base,
                                    window, out, workspace, B, KH, TR, T, D,
                                    P, PS, MP, n_split, s);
  if (TR <= 8)
    return launch_split<Page, 8, 1>(q, k_pages, v_pages, lengths,
                                    block_tables, live, anc, anc_base,
                                    window, out, workspace, B, KH, TR, T, D,
                                    P, PS, MP, n_split, s);
  if (D <= 128)
    return launch_split<Page, kSplitRows, 4>(
        q, k_pages, v_pages, lengths, block_tables, live, anc, anc_base,
        window, out, workspace, B, KH, TR, T, D, P, PS, MP, n_split, s);
  return launch_split<Page, kSplitRows, 2>(
      q, k_pages, v_pages, lengths, block_tables, live, anc, anc_base,
      window, out, workspace, B, KH, TR, T, D, P, PS, MP, n_split, s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// page_kind: 0 f32 pages, 1 bf16 pages, 2 int8 pages with f32 scales
// (k_scales/v_scales, null in the other modes). anc/anc_base non-null
// select the tree mode (with the fed window's width), on any page kind.
// v_pages null selects the latent mode (KH = 1, bf16/f32 pages, the
// leading DV <= D columns of each row are its value); elsewhere DV = D.
// bf16/f32 pages outside the latent mode take the split page walk over
// n_split splits (1 <= n_split <= max(MP, 1); D <= 256, PS <= 64) with
// `workspace` of B*KH*n_split*TR*(D + 2) floats when n_split > 1; the
// int8 and latent modes ignore both.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, int page_kind,
    const void* k_scales, const void* v_scales, const void* lengths,
    const void* block_tables, const void* live, const void* anc,
    const void* anc_base, int window, void* out, int B, int KH, int TR,
    int T, int D, int DV, int P, int PS, int MP, void* workspace,
    int n_split, void* stream) {
  const bool latent = v_pages == nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!latent && (page_kind == 0 || page_kind == 1)) {
    const int vec = page_kind == 1 ? 8 : 4;
    if (TR < 1 || T < 1 || TR % T != 0 || D < 1 || D > kSplitMaxDim
        || D % vec != 0 || DV != D || PS < 1 || PS > kSplitPos
        || n_split < 1 || n_split > std::max(MP, 1)
        || (n_split > 1 && workspace == nullptr)
        || (anc == nullptr) != (anc_base == nullptr) || window < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (page_kind == 1)
      return launch_split_rows<__nv_bfloat16>(
          q, k_pages, v_pages, lengths, block_tables, live, anc, anc_base,
          window, out, workspace, B, KH, TR, T, D, P, PS, MP, n_split, s);
    return launch_split_rows<float>(
        q, k_pages, v_pages, lengths, block_tables, live, anc, anc_base,
        window, out, workspace, B, KH, TR, T, D, P, PS, MP, n_split, s);
  }
  const int threads = latent
      ? ((DV + kLatentCols - 1) / kLatentCols + 31) / 32 * 32
      : ((D + 31) / 32) * 32;
  const int stage = latent ? 2 * kStage : kStage;
  const int vec = page_kind == 2 ? 16 : page_kind == 1 ? 8 : 4;
  if (page_kind < 0 || page_kind > 2 || TR < 1 || T < 1 || TR % T != 0
      || D > 1024 || D % vec != 0 || PS * D / vec > stage * threads
      || (page_kind == 2 && (k_scales == nullptr || v_scales == nullptr))
      || (anc == nullptr) != (anc_base == nullptr) || window < 0
      || (latent ? (page_kind == 2 || KH != 1 || DV < 1 || DV > D)
                 : DV != D))
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = latent ? kLatentRows : kMaxRows;
  const int rows = TR < group ? TR : group;   // rows per block
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(rows) * D
                       + (latent ? 1 : 2) * PS * D + rows * PS + 3 * rows);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (latent) {
    if (page_kind == 1)
      return launch<__nv_bfloat16, true>(
          q, k_pages, nullptr, nullptr, nullptr, lengths, block_tables,
          live, anc, anc_base, window, out, B, KH, TR, T, D, DV, P, PS, MP,
          threads, smem, s);
    return launch<float, true>(q, k_pages, nullptr, nullptr, nullptr,
                               lengths, block_tables, live, anc, anc_base,
                               window, out, B, KH, TR, T, D, DV, P, PS, MP,
                               threads, smem, s);
  }
  return launch<int8_t, false>(q, k_pages, v_pages, k_scales, v_scales,
                               lengths, block_tables, live, anc, anc_base,
                               window, out, B, KH, TR, T, D, DV, P, PS, MP,
                               threads, smem, s);
}
