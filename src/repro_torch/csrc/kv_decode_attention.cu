// int8-KV decode attention over a contiguous cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ops.py:kv_decode_attention
// (paged_attention_pallas in its int8 mode over the contiguous cache
// viewed as pages under identity block tables), which the static-batch
// serve step reaches in every layer (src/repro/models/layers.py:532).
//
// Layouts:
//   q          [B, KH, R, D] f32    query rows grouped by KV head
//   k/v        [B, S, KH, D] int8   codes; a value is code * scale
//   k/v_scale  [B, S, KH] f32
//   length     [B] int32 or int64   slot b sees positions < length[b]
//                                   (len_stride 0: one value for all)
//   out        [B, KH, R, D] f32
//   workspace  n_split > 1 only: [B, KH, n_split, R, D] f32 partial acc,
//              then [B, KH, n_split, R] float2 (m, l)
// Scale 1/sqrt(D). A row of length 0 returns zeros.
//
// Bound on the card: bytes. Every live code and scale is read once, and a
// code pair (K and V) feeds 4 R flops (R = 1 at llama2-7b width): the
// floor is 2 * B * length * KH * (D + 4) bytes over 3.35 TB/s (4 x 32768
// positions x 32 heads x 128: 1.107 GB, 330.6 us). At R = 16 that is ~32
// flops a byte, far under the bf16 tensor cores' ~295. This kernel
// multiplies in f32 on the CUDA cores (67 TFLOP/s, 20 flops a byte), so
// from R = 11 on its own multiply-adds outlast the bytes: at
// starcoder2-3b's R = 12 (24 heads over 2 KV heads), 4 x 32768, 24.0 us
// of f32 work against a 20.7 us bound. R runs up to 16; a template of
// kRows = R rounded up to a power of two computes its padding rows too.
//
// Design, for that bound:
//   Blocks. One block per (split, group of `heads` KV heads, slot), one
//     warp per head of the group, so every warp scores. Lanes go over
//     positions: a stage holds kChunk = 32 positions and lane p computes
//     whole q.k products over D for position p and each of its head's R
//     query rows (q read as broadcast float4s from shared memory), with no
//     shuffle in the score loop. P.V turns the lanes over D: lane
//     (sub, dl) owns dims 4 dl .. 4 dl + 3 of the D / 4 positions from
//     sub * D / 4 (one subgroup of all 32 positions at D = 128, whose V
//     codes a warp reads as one 128-byte run a position); the
//     subgroups' sums meet in xor shuffles once, after the last chunk.
//   Reads. Heads of a group are adjacent in the cache, so one position's
//     codes for the whole group are one contiguous run of heads * D bytes
//     (1 KB at 8 heads of 128) and its scales one 4-32-byte run: both are
//     copied with cp.async (16-byte copies; the scales in copies of
//     min(16, heads * 4) bytes), never a 4-byte copy a head.
//   Bytes in flight. A ring of n_stages stages (3 by default): while one
//     chunk is scored, the next n_stages - 1 are in flight, 135 KB an SM
//     at 8 heads of D = 128 (3.35 TB/s x ~1.2 us of latency over 132 SMs
//     asks for ~30 KB). A staged position's codes are padded by 16 bytes,
//     so the 8 lanes of a quarter-warp that read 8 positions hit 8
//     distinct 16-byte bank groups.
//   Conversion. No I2F: a code byte, xor 0x80, is permuted (prmt) into
//     the low byte of 0x4B000000, the f32 2^23 + 128 + code, and one f32
//     subtraction of 8388736 gives the code exactly: a PRMT (64 an SM a
//     clock) and an FADD (128) a code, against an I2F (16).
//   Scales folded in, as the paged kernel's int8 mode folds them: a score
//     is (q . codes) * (k_scale / sqrt(D)), the probability that enters
//     P.V is e^(s - m) * v_scale against the raw codes, and l sums the
//     unscaled e^(s - m). One online-softmax update a chunk: the max is a
//     warp reduction (the scores are spread over lanes), l stays a
//     per-lane share until the end.
//   Splits. Each slot's live length (read on the card) is cut into
//     ceil(length / 32) chunks, and split i of n_split takes chunks
//     [i * n / n_split, (i + 1) * n / n_split): a short context spends no
//     block on empty positions, and positions past the length are never
//     copied. n_split comes from host-known shapes only
//     (kernels/kv_decode_attention.py:plan), so the decode step reads
//     nothing on the host. With n_split > 1 each block writes its partial
//     (m, l, acc) and kv_decode_combine_kernel merges them in split order:
//     m = max m_i, l = sum l_i e^(m_i - m), o = sum acc_i e^(m_i - m) / l.
//     No atomics touch the data, so two launches give bit-identical
//     output. kernels/ref.py:kv_decode_split_ref does the same math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kChunk = 32;          // positions a stage: a lane each
constexpr int kRowPad = 16;         // bytes after a staged position's codes
constexpr int kMaxHeads = 8;        // heads (warps) a block
constexpr int kMaxRows = 16;        // query rows a KV head
constexpr int kMaxStages = 8;
constexpr int kCombineThreads = 128;
constexpr int kDefaultSmem = 48 * 1024;  // dynamic smem without opting in
constexpr int kMaxSmem = 232448;         // Hopper's opt-in limit a block

// Everything a launch needs, passed to the kernel by value.
struct Args {
  const float* q;             // 16-byte aligned
  const int8_t* k;            // 16-byte aligned
  const int8_t* v;
  const float* k_scale;       // aligned to the scale copy's size
  const float* v_scale;
  const void* length;
  float* out;
  float* part_acc;            // n_split > 1: [B, KH, n_split, R, D]
  float2* part_ml;            // n_split > 1: [B, KH, n_split, R]
  int len_stride, len64;
  int B, S, KH, R, heads, n_stages, n_split;
  float scale;
};

// Shared memory of a block: the ring, then q [heads][R][D] f32, then each
// warp's probabilities [rows][kChunk] f32. A stage is K codes
// [kChunk][heads * D + kRowPad], V codes the same, then K scales
// [kChunk][heads] and V scales [kChunk][heads] f32.
__host__ __device__ inline int stage_bytes(int heads, int D) {
  return 2 * kChunk * (heads * D + kRowPad) + 2 * kChunk * heads * 4;
}

__host__ __device__ inline size_t smem_bytes(int heads, int R, int rows,
                                             int D, int n_stages) {
  return static_cast<size_t>(n_stages) * stage_bytes(heads, D)
         + sizeof(float) * (static_cast<size_t>(heads) * R * D
                            + static_cast<size_t>(heads) * rows * kChunk);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
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

// wait until at most `pending` copy groups are in flight (a runtime count:
// the instruction takes an immediate)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// four int8 codes (one 32-bit word) as exact f32 values, without I2F:
// byte j of w ^ 0x80808080 permuted into 0x4B0000xx is 2^23 + 128 + code
__device__ __forceinline__ void codes4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + j))
           - 8388736.f;
}

// One block per (split, head group, slot), one warp per head. kRows: R
// rounded up to a power of two (a row past R scores row R - 1 and is never
// stored); kD: the head dim.
template <int kRows, int kD>
__global__ void __launch_bounds__(kMaxHeads * 32)
kv_decode_split_kernel(const Args a) {
  constexpr int kL = kD / 4;            // P.V: lanes over D, 4 dims each
  constexpr int kSub = 32 / kL;         // position subgroups
  constexpr int kPer = kChunk / kSub;   // positions a subgroup takes
  const int heads = a.heads, R = a.R, KH = a.KH;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;    // this warp's head in the group
  const int nthreads = heads * 32;
  const int split = blockIdx.x;
  const int h0 = blockIdx.y * heads;
  const int b = blockIdx.z;
  const int kh = h0 + warp;
  const size_t row0 = (static_cast<size_t>(b) * KH + kh) * R;
  const size_t part0 =
      ((static_cast<size_t>(b) * KH + kh) * a.n_split + split) * R;

  // the slot's live chunks and this split's share of them
  const long long raw =
      a.len64 ? static_cast<const long long*>(a.length)[b * a.len_stride]
              : static_cast<const int*>(a.length)[b * a.len_stride];
  const int len = static_cast<int>(
      min(max(raw, 0LL), static_cast<long long>(a.S)));
  const int n_chunks = (len + kChunk - 1) / kChunk;
  const int c0 = static_cast<int>(static_cast<long long>(split) * n_chunks
                                  / a.n_split);
  const int n = static_cast<int>(static_cast<long long>(split + 1)
                                 * n_chunks / a.n_split) - c0;
  if (n == 0) {               // block-uniform: nothing visible here
    if (a.n_split == 1) {
      for (int e = lane; e < R * kD; e += 32) a.out[row0 * kD + e] = 0.f;
    } else {
      for (int r = lane; r < R; r += 32)
        a.part_ml[part0 + r] = make_float2(-INFINITY, 0.f);
    }
    return;
  }

  const int row = heads * kD + kRowPad;   // bytes a staged position
  const int sbytes = stage_bytes(heads, kD);
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + a.n_stages * sbytes);
  float* p_s = q_s + heads * R * kD + warp * kRows * kChunk;

  // q of the group's heads: heads * R * D contiguous floats
  {
    const float4* src = reinterpret_cast<const float4*>(
        a.q + (static_cast<size_t>(b) * KH + h0) * R * kD);
    float4* dst = reinterpret_cast<float4*>(q_s);
    for (int i = threadIdx.x; i < heads * R * kD / 4; i += nthreads)
      dst[i] = __ldg(src + i);
  }

  // position 0 of this slot, head h0
  const size_t pos_bytes = static_cast<size_t>(KH) * kD;
  const int8_t* kg = a.k + (static_cast<size_t>(b) * a.S * KH + h0) * kD;
  const int8_t* vg = a.v + (static_cast<size_t>(b) * a.S * KH + h0) * kD;
  const float* ksg = a.k_scale + static_cast<size_t>(b) * a.S * KH + h0;
  const float* vsg = a.v_scale + static_cast<size_t>(b) * a.S * KH + h0;
  const int vecs = heads * kD / 16;          // 16-byte copies a position
  const int sc_copy = min(16, heads * 4);    // bytes a scale copy
  const int sc_vecs = heads * 4 / sc_copy;   // scale copies a position
  // stage chunk c (positions 32c .. below the length) into stage st
  auto issue = [&](int c, int st) {
    unsigned char* kd = smem + st * sbytes;
    unsigned char* vd = kd + kChunk * row;
    float* ksd = reinterpret_cast<float*>(vd + kChunk * row);
    float* vsd = ksd + kChunk * heads;
    const int p0 = c * kChunk;
    const int np = min(kChunk, len - p0);
    for (int i = threadIdx.x; i < np * vecs; i += nthreads) {
      const int p = i / vecs;
      const int x = i - p * vecs;
      const size_t off = (p0 + p) * pos_bytes + x * 16;
      cp_async16(kd + p * row + x * 16, kg + off);
      cp_async16(vd + p * row + x * 16, vg + off);
    }
    for (int i = threadIdx.x; i < np * sc_vecs; i += nthreads) {
      const int p = i / sc_vecs;
      const int x = (i - p * sc_vecs) * (sc_copy / 4);   // first head
      const size_t off = static_cast<size_t>(p0 + p) * KH + x;
      float* kdst = ksd + p * heads + x;
      float* vdst = vsd + p * heads + x;
      if (sc_copy == 16) {
        cp_async16(kdst, ksg + off);
        cp_async16(vdst, vsg + off);
      } else if (sc_copy == 8) {
        cp_async8(kdst, ksg + off);
        cp_async8(vdst, vsg + off);
      } else {
        cp_async4(kdst, ksg + off);
        cp_async4(vdst, vsg + off);
      }
    }
  };

  const int ns = a.n_stages;
  for (int i = 0; i < ns - 1; ++i) {   // one group a stage, empty or not
    if (i < n) issue(c0 + i, i);
    cp_async_commit();
  }

  float m_r[kRows], l_r[kRows];       // m warp-uniform, l this lane's share
  float acc[kRows][4];                // dims 4 dl .. of this lane's positions
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }
  const int dl = lane % kL;
  const int sub = lane / kL;
  const float* qw = q_s + warp * R * kD;

  for (int i = 0; i < n; ++i) {
    cp_async_wait(ns - 2);            // chunk i has landed (this thread's)
    __syncthreads();                  // everyone's; stage i - 1 is free
    if (i + ns - 1 < n) issue(c0 + i + ns - 1, (i + ns - 1) % ns);
    cp_async_commit();
    const unsigned char* ks = smem + (i % ns) * sbytes;
    const unsigned char* vs = ks + kChunk * row;
    const float* kss = reinterpret_cast<const float*>(vs + kChunk * row);
    const float* vss = kss + kChunk * heads;
    const int p0 = (c0 + i) * kChunk;
    const bool valid = p0 + lane < len;

    // scores: lane = position, whole dot products over D; one sum a row,
    // 16 codes read at a time (one conflict-free 16-byte load) and
    // converted 8 at a time. Two sums a row and 16 codes converted at a
    // time took the 16-row thread past 255 registers (80 bytes of spill
    // stores at D = 128, against 24 this way), and were no faster at 1 row
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
    const unsigned char* krow = ks + lane * row + warp * kD;
#pragma unroll
    for (int d0 = 0; d0 < kD; d0 += 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(krow + d0);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int h = 0; h < 16; h += 8) {
        float kf[8];
        codes4(w[h / 4], kf);
        codes4(w[h / 4 + 1], kf + 4);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4* qv = reinterpret_cast<const float4*>(
              qw + min(r, R - 1) * kD + d0 + h);
          float x = sc[r];
#pragma unroll
          for (int e4 = 0; e4 < 2; ++e4) {
            const float4 qq = qv[e4];
            x = fmaf(qq.x, kf[4 * e4], x);
            x = fmaf(qq.y, kf[4 * e4 + 1], x);
            x = fmaf(qq.z, kf[4 * e4 + 2], x);
            x = fmaf(qq.w, kf[4 * e4 + 3], x);
          }
          sc[r] = x;
        }
      }
    }

    // online softmax, once a chunk; a position past the length (its
    // staged bytes stale) gets probability 0
    const float kmul = a.scale * kss[lane * heads + warp];
    const float vmul = vss[lane * heads + warp];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float s = valid ? sc[r] * kmul : -INFINITY;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_r[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = isinf(m_new) ? 0.f : m_new;
      const float e = valid ? expf(s - m_safe) : 0.f;
      const float corr = isinf(m_old) ? 0.f : expf(m_old - m_safe);
      l_r[r] = l_r[r] * corr + e;
      m_r[r] = m_new;
      p_s[r * kChunk + lane] = valid ? e * vmul : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] *= corr;
    }
    __syncwarp();

    // P.V: this lane's 4 dims of its subgroup's positions, 4 at a time (a
    // position past the length adds 0 x a finite code)
    const unsigned char* vcol = vs + warp * kD + 4 * dl;
#pragma unroll 2
    for (int j = 0; j < kPer; j += 4) {
      const int p = sub * kPer + j;
      float vf[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        codes4(*reinterpret_cast<const uint32_t*>(vcol + (p + u) * row),
               vf[u]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pp =
            *reinterpret_cast<const float4*>(p_s + r * kChunk + p);
        const float pw[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(pw[u], vf[u][c], acc[r][c]);
        }
      }
    }
  }

  // the lanes' shares of l, and the subgroups' sums of acc, in xor
  // butterflies (every lane ends with the same sums)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], off);
#pragma unroll
    for (int off = kL; off < 32; off <<= 1) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
    }
  }
  if (sub != 0) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= R) break;
    if (a.n_split == 1) {
      const float den = fmaxf(l_r[r], 1e-30f);
      *reinterpret_cast<float4*>(a.out + (row0 + r) * kD + 4 * dl) =
          make_float4(acc[r][0] / den, acc[r][1] / den, acc[r][2] / den,
                      acc[r][3] / den);
    } else {
      *reinterpret_cast<float4*>(a.part_acc + (part0 + r) * kD + 4 * dl) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      if (lane == 0) a.part_ml[part0 + r] = make_float2(m_r[r], l_r[r]);
    }
  }
}

// Merges the n_split partials of one (slot, KV head, row) a block, in
// split order. Splits with m = -inf (nothing visible) are skipped; a row
// with none left writes zeros. Every split's acc is loaded, an empty
// split's (never written) too, and dropped by a select.
__global__ void __launch_bounds__(kCombineThreads)
kv_decode_combine_kernel(const float* __restrict__ part_acc,
                         const float2* __restrict__ part_ml,
                         float* __restrict__ out, int R, int D,
                         int n_split) {
  extern __shared__ float comb_smem[];
  float* m_s = comb_smem;                // [n_split]
  float* w_s = comb_smem + n_split;      // [n_split]
  const int row = blockIdx.x;            // (b * KH + kh) * R + r
  const int bkh = row / R;
  // split i of this row: part_ml[p0 + i * R], part_acc[(p0 + i * R) * D]
  const size_t p0 = static_cast<size_t>(bkh) * n_split * R + (row - bkh * R);
  for (int i = threadIdx.x; i < n_split; i += blockDim.x) {
    const float2 ml = part_ml[p0 + static_cast<size_t>(i) * R];
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
    float x = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_split; ++i) {
      const float y = part_acc[(p0 + static_cast<size_t>(i) * R) * D + d];
      x = isinf(m_s[i]) ? x : fmaf(y, expf(m_s[i] - m), x);
    }
    o[d] = isinf(m) ? 0.f : x / fmaxf(l, 1e-30f);
  }
}

template <int kRows, int kD>
int launch(const Args& a, size_t smem, cudaStream_t s) {
  auto kern = kv_decode_split_kernel<kRows, kD>;
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.n_split, a.KH / a.heads, a.B);
  kern<<<grid, a.heads * 32, smem, s>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return static_cast<int>(e);
  kv_decode_combine_kernel<<<a.B * a.KH * a.R, kCombineThreads,
                             2 * a.n_split * sizeof(float), s>>>(
      a.part_acc, a.part_ml, a.out, a.R, kD, a.n_split);
  return static_cast<int>(cudaGetLastError());
}

template <int kRows>
int launch_d(const Args& a, int D, size_t smem, cudaStream_t s) {
  switch (D) {
    case 16: return launch<kRows, 16>(a, smem, s);
    case 64: return launch<kRows, 64>(a, smem, s);
    default: return launch<kRows, 128>(a, smem, s);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched; 1,
// cudaErrorInvalidValue: arguments the kernel does not take). D in {16,
// 64, 128} (the port's head dims); 1 <= R <= 16; heads in {1, 2, 4, 8}
// dividing KH; 2 <= n_stages <= 8; `smem` the block's shared memory as smem_bytes counts it
// (kernels/kv_decode_attention.py:smem_bytes); len_bytes 4 (int32) or 8
// (int64), len_stride 0 (one length) or 1 ([B]); `workspace` of
// B*KH*n_split*R*(D + 2) floats when n_split > 1.
extern "C" int kv_decode_attention_launch(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* length, int len_stride, int len_bytes,
    void* out, int B, int S, int KH, int R, int D, int heads, int n_stages,
    int n_split, long long smem, void* workspace, void* stream) {
  int rows = 1;
  while (rows < R) rows *= 2;
  if (B < 1 || S < 1 || KH < 1 || R < 1 || R > kMaxRows
      || (D != 16 && D != 64 && D != 128)
      || (heads != 1 && heads != 2 && heads != 4 && heads != kMaxHeads)
      || KH % heads != 0 || n_stages < 2 || n_stages > kMaxStages
      || n_split < 1 || (n_split > 1 && workspace == nullptr)
      || (len_bytes != 4 && len_bytes != 8)
      || (len_stride != 0 && len_stride != 1)
      || smem != static_cast<long long>(
                     smem_bytes(heads, R, rows, D, n_stages))
      || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.length = length;
  a.out = static_cast<float*>(out);
  a.part_acc = static_cast<float*>(workspace);
  a.part_ml = n_split > 1
      ? reinterpret_cast<float2*>(a.part_acc
                                  + static_cast<size_t>(B) * KH * n_split
                                        * R * D)
      : nullptr;
  a.len_stride = len_stride;
  a.len64 = len_bytes == 8;
  a.B = B;
  a.S = S;
  a.KH = KH;
  a.R = R;
  a.heads = heads;
  a.n_stages = n_stages;
  a.n_split = n_split;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  const size_t sm = static_cast<size_t>(smem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return launch_d<1>(a, D, sm, s);
    case 2: return launch_d<2>(a, D, sm, s);
    case 4: return launch_d<4>(a, D, sm, s);
    case 8: return launch_d<8>(a, D, sm, s);
    default: return launch_d<16>(a, D, sm, s);
  }
}
