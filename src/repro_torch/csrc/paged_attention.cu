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
// Scale 1/sqrt(D). A row whose length is 0 returns exact zeros.
//
// Bound on the card: bytes. Each live K/V element is read once and used
// for 2*TR flops per operand, far below the f32 flop/byte balance, so the
// floor is the live K/V bytes (int8: codes plus scales) over 3.35 TB/s.
//
// Design: one block per (slot, KV head, group of at most kMaxRows query
// rows), which loads its own block-table row and walks the slot's live
// pages in order with an online softmax (the TPU grid's sequential page
// axis becomes a loop in the block, since blocks carry nothing between
// each other). Each page's [PS, D] K and V tiles are fetched with
// coalesced 16-byte loads (a head's D values are contiguous in the pool),
// all issued at once into registers, so a page costs one memory round
// trip; the next page's loads are issued before the current page is
// computed, hiding that trip. Tiles are kept in shared memory as f32;
// warps compute the rows x PS scores with lane-split dot products and the
// softmax statistics with one warp per row; thread d owns output column d
// of every row. Sentinel pages are clamped to P-1 and masked by length, as
// the TPU kernel does. The -inf guards of the TPU kernel are kept, so a
// fully masked row ends with l = 0 and writes 0.
// In int8 mode a 16-byte vector holds 16 codes of one token, and the
// token's K and V scales are loaded with it; each code is dequantised as
// code * scale while the tile is staged, before the f32 contractions, as
// the TPU kernel's body does (the reference's jnp path instead
// re-quantises q and the softmax weights for int8 x int8 products: not
// this kernel's math).
// Tree mode is the same walk with one more mask term: each row's ancestor
// bitmap and the slot's window base are loaded once per block, and a
// position inside the fed window is visible only if the row's bit for it
// is set (the shift stays in 0..31). It runs on every page type.
// Row groups: the TPU kernel takes any T*R rows; here the per-thread
// accumulator holds kMaxRows rows (about 128 registers, no spill), so a
// block takes at most kMaxRows rows and a third grid axis covers the rest.
// Every group walks its slot's pages, so K/V are read once per group: a
// tree verify of T = 29 rows at R = 1 reads them twice. The groups run as
// separate blocks at the same time and the second read mostly hits L2: on
// an H100 (700 W) T = 29 took 1-2% longer than T = 16 at the same lengths
// (PERF.md). What does cost is the work per page of a 16-row block (one
// warp reduction per row and position, at 1-2 blocks per SM): 7-8x
// the T = 1 time per page.
// Fewer blocks than SMs at small batch (4 slots x 32 heads = 128 blocks)
// is accepted here: a split over pages with a combine step is later work.
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

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// page_kind: 0 f32 pages, 1 bf16 pages, 2 int8 pages with f32 scales
// (k_scales/v_scales, null in the other modes). anc/anc_base non-null
// select the tree mode (with the fed window's width), on any page kind.
// v_pages null selects the latent mode (KH = 1, bf16/f32 pages, the
// leading DV <= D columns of each row are its value); elsewhere DV = D.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, int page_kind,
    const void* k_scales, const void* v_scales, const void* lengths,
    const void* block_tables, const void* live, const void* anc,
    const void* anc_base, int window, void* out, int B, int KH, int TR,
    int T, int D, int DV, int P, int PS, int MP, void* stream) {
  const bool latent = v_pages == nullptr;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  if (page_kind == 2)
    return launch<int8_t, false>(q, k_pages, v_pages, k_scales, v_scales,
                                 lengths, block_tables, live, anc, anc_base,
                                 window, out, B, KH, TR, T, D, DV, P, PS,
                                 MP, threads, smem, s);
  if (page_kind == 1)
    return launch<__nv_bfloat16, false>(
        q, k_pages, v_pages, nullptr, nullptr, lengths, block_tables, live,
        anc, anc_base, window, out, B, KH, TR, T, D, DV, P, PS, MP, threads,
        smem, s);
  return launch<float, false>(q, k_pages, v_pages, nullptr, nullptr,
                              lengths, block_tables, live, anc, anc_base,
                              window, out, B, KH, TR, T, D, DV, P, PS, MP,
                              threads, smem, s);
}
