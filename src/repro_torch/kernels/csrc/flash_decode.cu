// Flash-decoding attention of folded tree queries over a KV cache with
// per-row lengths, for Hopper (sm_90a).
//
// Replaces repro/kernels/tree_attention.py::flash_decode, all of its
// variants: the dense fp/bf16 body `_kernel`, its int8 branch
// (`quantized=True`: int8 rows times their [BS, 1] f32 scale column,
// dequantized in the tile) and the paged body `_kernel_paged` (the block
// table read by the index map).  It emits the same partial-softmax
// statistics in f32:
//   acc[b,h,r,:] = sum_{s < len_b} p(r,s) * v[b,s,h,:]
//   m[b,h,r]     = max_{s < len_b} q[b,h,r,:] . k[b,s,h,:]
//   l[b,h,r]     = sum_{s < len_b} exp(score - m)
// with m = -1e30, l = 0, acc = 0 for a row of length 0.  The tree block and
// the exact merge stay in repro_torch/kernels/ops.py.
//
// Numerics follow the TPU kernel.  fp cache: p is rounded to v's dtype
// before the PV product.  int8 cache: k = f32(int8) * scale and
// v = f32(int8) * scale are single f32 products; the score is the f32 dot of
// the (promoted) query with that f32 k, and p is NOT rounded, because the
// dequantized v is f32 and `p.astype(v.dtype)` is then a no-op.
//
// Paged cache: k/v are pools [n_blocks, page_size, Hkv, D] and logical row s
// of slot b lives at physical row table[b, s / ps] * ps + s % ps.  The tiles
// stay BS = 64 logical columns whatever the page size, so the online
// softmax sums in exactly the dense order and paged is bitwise equal to
// dense on the same logical rows.  Only entries of rows s < lengths[b] are
// read from the table (an idle slot has a zero table and length 0).  The
// int8 scale pools use the same physical row as the values.
//
// Bound: at the main-path shape (B 4, Hkv 8, R 256, D 128) the work is
// the bytes of K and V swept (each cache row is needed by all R folded
// query rows of its kv head), far below the card's operations-per-byte
// line; int8 sweeps (D + 4) / (2 D) of the bf16 bytes.  Design: one block
// per (b, kv head, tile of BR query rows), so the R = 256 spec step gives
// B*Hkv*8 = 256 blocks and every block streams its row's cache once
// through shared memory in tiles of BS keys, stopping at lengths[b] (blocks
// past the length are never read, as on the TPU).  Each tile first
// resolves its BS physical rows (and, under int8, their scales) into
// shared memory, then loads the values through them.  The online softmax
// runs in f32 registers and shared memory.  The cache keeps the port's
// [B, S, Hkv, D] (or pool) layout; the kernel reads it through strides, so
// no transposed copy is made.  Split-KV across blocks, wgmma and TMA are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BR = 32;   // query rows per block
constexpr int BS = 64;   // keys per shared-memory tile
constexpr int NT = 128;  // threads per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// p.astype(v.dtype) of the TPU kernel: round p to the value dtype (f32 for
// a dequantized int8 cache, so no rounding there)
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const int8_t*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
struct Geometry {
  static constexpr int DP = D + 1;                 // padded row: no bank conflicts
  static constexpr int DC = D < NT ? D : NT;       // threads across head_dim
  static constexpr int RG = NT / DC;               // row groups
  static constexpr int CPT = D / DC;               // acc columns per thread
  static constexpr int RPT = BR / RG;              // acc rows per thread
  // qs, ks, vs, ps, m/l/alpha, then per-tile rows (int) and scales
  static constexpr int SMEM_FLOATS =
      BR * DP + BS * DP + BS * D + BR * BS + 3 * BR + 3 * BS;
};

// Where the cache lives: element strides (b, s, h) of the values and of the
// scales; for a paged pool `table` is [B, mb] int32, s is the flat pool row
// (block * ps + offset) and the b strides are unused.
struct CacheArgs {
  const int* table;
  int ps, mb;
  int64_t k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh;
};

// T: query (and fp cache) type; C: cache element type (T, or int8_t with
// f32 scales); PAGED: the cache is a block pool read through the table.
template <typename T, typename C, bool PAGED, int D>
__global__ void __launch_bounds__(NT) flash_decode_kernel(
    const T* __restrict__ q, const C* __restrict__ k, const C* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ lengths, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int Hkv, int R, int S,
    CacheArgs ca) {
  using G = Geometry<D>;
  constexpr int DP = G::DP;
  constexpr bool QUANT = sizeof(C) == 1;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [BR][DP] pre-scaled queries
  float* ks = qs + BR * DP;       // [BS][DP] key tile
  float* vs = ks + BS * DP;       // [BS][D]  value tile
  float* ps = vs + BS * D;        // [BR][BS] scores, then probabilities
  float* m_s = ps + BR * BS;      // [BR] running max
  float* l_s = m_s + BR;          // [BR] running sum
  float* a_s = l_s + BR;          // [BR] rescale factor of this tile
  int* row_s = reinterpret_cast<int*>(a_s + BR);  // [BS] cache row of each column
  float* ksc_s = a_s + BR + BS;   // [BS] k scales of the tile (int8)
  float* vsc_s = ksc_s + BS;      // [BS] v scales of the tile (int8)

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  int n_cols = lengths[b];
  n_cols = n_cols < 0 ? 0 : (n_cols > S ? S : n_cols);

  const int64_t row_base = ((int64_t)b * Hkv + h) * R;
  const T* qb = q + row_base * D;
  for (int e = tid; e < BR * D; e += NT) {
    const int r = e / D, d = e % D;
    qs[r * DP + d] = (r0 + r < R) ? to_f(qb[(int64_t)(r0 + r) * D + d]) : 0.f;
  }
  if (tid < BR) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // accumulator ownership: rows rgrp + RG*i, columns dcol + DC*j
  const int dcol = tid % G::DC, rgrp = tid / G::DC;
  float acc[G::RPT][G::CPT];
#pragma unroll
  for (int i = 0; i < G::RPT; ++i)
#pragma unroll
    for (int j = 0; j < G::CPT; ++j) acc[i][j] = 0.f;

  // score ownership: rows srow + 8*i, columns scol + 16*j (4 x 4 per thread)
  const int srow = tid / 16, scol = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t bk = PAGED ? 0 : (int64_t)b * ca.k_sb;
  const int64_t bv = PAGED ? 0 : (int64_t)b * ca.v_sb;
  const C* kb = k + bk + (int64_t)h * ca.k_sh;
  const C* vb = v + bv + (int64_t)h * ca.v_sh;
  const int* tb = PAGED ? ca.table + (int64_t)b * ca.mb : nullptr;

  for (int s0 = 0; s0 < n_cols; s0 += BS) {
    __syncthreads();  // the previous tile's readers are done
    if (tid < BS) {
      // the tile's cache rows (and scales); columns past the length read
      // nothing, not even their table entry
      const int s = s0 + tid;
      int row = 0;
      float ksc = 0.f, vsc = 0.f;
      if (s < n_cols) {
        row = PAGED ? tb[s / ca.ps] * ca.ps + s % ca.ps : s;
        if constexpr (QUANT) {
          const int64_t bks = PAGED ? 0 : (int64_t)b * ca.ks_sb;
          const int64_t bvs = PAGED ? 0 : (int64_t)b * ca.vs_sb;
          ksc = k_scale[bks + (int64_t)row * ca.ks_ss + (int64_t)h * ca.ks_sh];
          vsc = v_scale[bvs + (int64_t)row * ca.vs_ss + (int64_t)h * ca.vs_sh];
        }
      }
      row_s[tid] = row;
      ksc_s[tid] = ksc;
      vsc_s[tid] = vsc;
    }
    __syncthreads();
    for (int e = tid; e < BS * D; e += NT) {
      const int c = e / D, d = e % D;
      float kv = 0.f, vv = 0.f;
      if (s0 + c < n_cols) {
        const int64_t row = row_s[c];
        if constexpr (QUANT) {
          kv = __fmul_rn((float)kb[row * ca.k_ss + d], ksc_s[c]);
          vv = __fmul_rn((float)vb[row * ca.v_ss + d], vsc_s[c]);
        } else {
          kv = to_f(kb[row * ca.k_ss + d]);
          vv = to_f(vb[row * ca.v_ss + d]);
        }
      }
      ks[c * DP + d] = kv;
      vs[c * D + d] = vv;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(srow + 8 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(scol + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = scol + 16 * j;
        ps[(srow + 8 * i) * BS + c] = (s0 + c < n_cols) ? sc[i][j] : kNegInf;
      }
    __syncthreads();

    // online softmax: warp w owns rows w, w + 4, ...
    for (int r = warp; r < BR; r += NT / 32) {
      const float x0 = ps[r * BS + lane], x1 = ps[r * BS + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = (s0 + lane < n_cols) ? expf(x0 - m_new) : 0.f;
      const float p1 = (s0 + lane + 32 < n_cols) ? expf(x1 - m_new) : 0.f;
      const float sum = warp_sum(p0 + p1);
      ps[r * BS + lane] = round_as(p0, v);
      ps[r * BS + lane + 32] = round_as(p1, v);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, four keys per step
#pragma unroll
    for (int i = 0; i < G::RPT; ++i) {
      const float alpha = a_s[rgrp + G::RG * i];
#pragma unroll
      for (int j = 0; j < G::CPT; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < BS; c += 4) {
      float vv[G::CPT][4];
#pragma unroll
      for (int j = 0; j < G::CPT; ++j)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) vv[j][cc] = vs[(c + cc) * D + dcol + G::DC * j];
#pragma unroll
      for (int i = 0; i < G::RPT; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(&ps[(rgrp + G::RG * i) * BS + c]);
#pragma unroll
        for (int j = 0; j < G::CPT; ++j) {
          float a = acc[i][j];
          a = fmaf(p4.x, vv[j][0], a);
          a = fmaf(p4.y, vv[j][1], a);
          a = fmaf(p4.z, vv[j][2], a);
          a = fmaf(p4.w, vv[j][3], a);
          acc[i][j] = a;
        }
      }
    }
  }
  __syncthreads();

  float* ob = acc_out + row_base * D;
#pragma unroll
  for (int i = 0; i < G::RPT; ++i) {
    const int r = rgrp + G::RG * i;
    if (r0 + r < R) {
#pragma unroll
      for (int j = 0; j < G::CPT; ++j)
        ob[(int64_t)(r0 + r) * D + dcol + G::DC * j] = acc[i][j];
    }
  }
  if (tid < BR && r0 + tid < R) {
    m_out[row_base + r0 + tid] = m_s[tid];
    l_out[row_base + r0 + tid] = l_s[tid];
  }
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *lengths;
  void *acc, *m, *l;
  int B, Hkv, R, S;
  CacheArgs ca;
  void* stream;
};

template <typename T, typename C, bool PAGED, int D>
int launch(const Args& a) {
  const size_t smem = sizeof(float) * Geometry<D>::SMEM_FLOATS;
  auto kernel = flash_decode_kernel<T, C, PAGED, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.R + BR - 1) / BR, a.Hkv, a.B);
  kernel<<<grid, NT, smem, (cudaStream_t)a.stream>>>(
      (const T*)a.q, (const C*)a.k, (const C*)a.v, (const float*)a.k_scale,
      (const float*)a.v_scale, (const int*)a.lengths, (float*)a.acc, (float*)a.m,
      (float*)a.l, a.Hkv, a.R, a.S, a.ca);
  return (int)cudaGetLastError();
}

template <typename T, typename C, bool PAGED>
int by_head_dim(const Args& a, int D) {
  switch (D) {
    case 64:
      return launch<T, C, PAGED, 64>(a);
    case 128:
      return launch<T, C, PAGED, 128>(a);
    case 256:
      return launch<T, C, PAGED, 256>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* k_scale,
             const void* v_scale, const void* lengths, const void* table, void* acc,
             void* m, void* l, int B, int Hkv, int R, int D, int S, int quantized,
             int ps, int mb, const int64_t* st, void* stream) {
  Args a{q, k, v, k_scale, v_scale, lengths, acc, m, l, B, Hkv, R, S,
         CacheArgs{(const int*)table, ps, mb, st[0], st[1], st[2], st[3], st[4], st[5],
                   st[6], st[7], st[8], st[9], st[10], st[11]},
         stream};
  const bool paged = table != nullptr;
  if (quantized)
    return paged ? by_head_dim<T, int8_t, true>(a, D) : by_head_dim<T, int8_t, false>(a, D);
  return paged ? by_head_dim<T, T, true>(a, D) : by_head_dim<T, T, false>(a, D);
}

}  // namespace

// q [B, Hkv, R, D] contiguous, pre-scaled; lengths [B] int32; acc
// [B, Hkv, R, D], m and l [B, Hkv, R, 1] float32, contiguous.
// Dense (table null): k/v [B, S, Hkv, D].  Paged: k/v pools
// [n_blocks, ps, Hkv, D] whose block stride is ps times the row stride,
// table [B, mb] int32 contiguous, S = mb * ps.  quantized: k/v int8 with
// k_scale/v_scale f32 [.., Hkv, 1] in the same layout; otherwise k/v have
// q's type and the scales are null.  strides: 12 element strides, (b, s, h)
// of k, v, k_scale and v_scale in that order (s is the pool-row stride when
// paged; b is then unused); unit stride over D.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* lengths, const void* table, void* acc,
                                void* m, void* l, int B, int Hkv, int R, int D, int S,
                                int quantized, int ps, int mb, const int64_t* strides,
                                void* stream) {
  return dispatch<float>(q, k, v, k_scale, v_scale, lengths, table, acc, m, l, B, Hkv, R,
                         D, S, quantized, ps, mb, strides, stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* lengths, const void* table, void* acc,
                                 void* m, void* l, int B, int Hkv, int R, int D, int S,
                                 int quantized, int ps, int mb, const int64_t* strides,
                                 void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, k_scale, v_scale, lengths, table, acc, m, l, B,
                                 Hkv, R, D, S, quantized, ps, mb, strides, stream);
}
