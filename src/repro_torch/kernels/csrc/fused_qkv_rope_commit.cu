// Fused q/k/v projection + RoPE + tree-row cache write of one decode layer,
// for Hopper (sm_90a).  Dense cache or paged pool.
//
// Replaces repro/kernels/cache_update.py::fused_qkv_rope_commit (Pallas
// bodies `_fused_qkv_body`, `_fused_qkv_dense` and `_fused_qkv_paged`,
// helper `_rope_half`).
// For x [M = B*T, d] and weights wq [d, Hq*hd], wk / wv [d, Hkv*hd]:
//   z = x @ w            f32 accumulation, rounded to x's dtype
//   z = z + bias         in x's dtype (when biases are given)
//   q, k: RoPE in `layers.apply_rope`'s op order: the halves x1, x2 taken to
//         f32, [x1*c - x2*s, x2*c + x1*s], cast back to x's dtype
//   q [B,T,Hq,hd], k / v [B,T,Hkv,hd] written out, and k / v also written
//   into the cache [B, S, Hkv, hd] (any strides, unit stride over hd) at
//   rows lengths[b] + t; rows at or past S are dropped, as the port's and
//   the unfused reference's `_update_rows` drop them.  Paged (a table is
//   given): the cache is a pool [n_blocks, ps, Hkv, hd] and logical row pos
//   lands at row pos % ps of block table[b, pos / ps]; rows past the table
//   (pos / ps >= mb) go to trash block 0, as `_fused_qkv_body` sends them.
// The RoPE products and sums use __fmul_rn / __fsub_rn / __fadd_rn so nvcc
// cannot contract them into FMAs: each op rounds on its own, as the eager
// PyTorch and XLA element-wise ops do.  cos / sin come in from
// `layers.rope_cos_sin`; nothing here calls sincosf.
//
// Bound: at the spec step (M 256, d 4096, 48 heads of 128, bf16) the
// weights are 50.3 MB of the 56.8 MB moved, against 1.29e10 flops: ~0.017
// ms by bytes; at the AR step (M 4) the weights are nearly all of it.
// Design: the TPU grid is (B,) and each step reads all weights.  Here a
// block owns (64 rows, one head): a column tile of exactly head_dim
// columns, so RoPE's pair (i, i + hd/2) lies in one block's tile, and the
// tree-row write needs nothing from another block.  Grid (ceil(M/64),
// Hq + 2 Hkv): 192 blocks at the spec step, 48 at the AR step.  The
// product runs through tile_gemm.cuh (mma.sync bf16 on the tensor cores, CUDA
// cores for f32).  The row tile is blockIdx.x, so the blocks that share a
// head's weights run together and read them from L2.
#include "tile_gemm.cuh"

namespace {

using namespace tile_gemm;

constexpr int BM = 64;

template <typename T, int HD>
__global__ void __launch_bounds__(NT) fused_qkv_kernel(
    const T* __restrict__ x, const T* __restrict__ wq, const T* __restrict__ wk,
    const T* __restrict__ wv, const T* __restrict__ bq, const T* __restrict__ bk,
    const T* __restrict__ bv, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const int* __restrict__ lengths, T* __restrict__ q_out,
    T* __restrict__ k_out, T* __restrict__ v_out, T* kc, T* vc, int M, int T_nodes, int d,
    int Hq, int Hkv, int S, int64_t kc_sb, int64_t kc_ss, int64_t kc_sh, int64_t vc_sb,
    int64_t vc_ss, int64_t vc_sh, const int* __restrict__ table, int ps, int mb, int a_vec,
    int b_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* C = reinterpret_cast<float*>(smem);
  constexpr int LDC = Tile<BM, HD>::LDC;
  constexpr int HALF = HD / 2;
  const int row0 = blockIdx.x * BM;
  int head = blockIdx.y;
  // which projection this block computes: 0 = q, 1 = k, 2 = v
  const int part = head < Hq ? 0 : (head < Hq + Hkv ? 1 : 2);
  head -= part == 0 ? 0 : (part == 1 ? Hq : Hq + Hkv);
  const int H = part == 0 ? Hq : Hkv;
  const T* w = part == 0 ? wq : (part == 1 ? wk : wv);
  const T* bias = part == 0 ? bq : (part == 1 ? bk : bv);
  T* out = part == 0 ? q_out : (part == 1 ? k_out : v_out);
  T* cache = part == 1 ? kc : vc;
  const int64_t sb = part == 1 ? kc_sb : vc_sb;
  const int64_t ss = part == 1 ? kc_ss : vc_ss;
  const int64_t sh = part == 1 ? kc_sh : vc_sh;
  gemm_tile<BM, HD>(x, d, M, row0, w, (int64_t)H * HD, H * HD, head * HD, d, a_vec, b_vec,
                    smem, C);

  const bool rope = cos_t != nullptr && part != 2;
  for (int e = threadIdx.x; e < BM * HALF; e += NT) {
    const int r = e / HALF, i = e % HALF;
    const int row = row0 + r;
    if (row >= M) break;
    float z1 = round_as(C[r * LDC + i], x);
    float z2 = round_as(C[r * LDC + i + HALF], x);
    if (bias != nullptr) {
      z1 = round_as(z1 + to_f(bias[head * HD + i]), x);
      z2 = round_as(z2 + to_f(bias[head * HD + i + HALF]), x);
    }
    if (rope) {
      const float c = cos_t[(int64_t)row * HALF + i], s = sin_t[(int64_t)row * HALF + i];
      const float o1 = __fsub_rn(__fmul_rn(z1, c), __fmul_rn(z2, s));
      const float o2 = __fadd_rn(__fmul_rn(z2, c), __fmul_rn(z1, s));
      z1 = o1;
      z2 = o2;
    }
    T* o = out + ((int64_t)row * H + head) * HD;
    store_as(o + i, z1);
    store_as(o + i + HALF, z2);
    if (part != 0) {
      const int b = row / T_nodes, t = row % T_nodes;
      const int pos = lengths[b] + t;
      T* dst = nullptr;
      if (table != nullptr) {
        const int lb = pos / ps;
        const int blk = lb < mb ? table[(int64_t)b * mb + lb] : 0;
        dst = cache + ((int64_t)blk * ps + pos % ps) * ss + (int64_t)head * sh;
      } else if (pos >= 0 && pos < S) {
        dst = cache + (int64_t)b * sb + (int64_t)pos * ss + (int64_t)head * sh;
      }
      if (dst != nullptr) {
        store_as(dst + i, z1);
        store_as(dst + i + HALF, z2);
      }
    }
  }
}

template <typename T, int HD>
int launch(const void* x, const void* wq, const void* wk, const void* wv, const void* bq,
           const void* bk, const void* bv, const void* cos_t, const void* sin_t,
           const void* lengths, void* q, void* k, void* v, void* kc, void* vc, int M,
           int T_nodes, int d, int Hq, int Hkv, int S, int64_t kc_sb, int64_t kc_ss,
           int64_t kc_sh, int64_t vc_sb, int64_t vc_ss, int64_t vc_sh, const void* table,
           int ps, int mb, void* stream) {
  const int smem = Tile<BM, HD>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      fused_qkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int a_vec = vec16(x, d, d);
  const int b_vec = vec16(wq, (int64_t)Hq * HD, Hq * HD) &&
                    vec16(wk, (int64_t)Hkv * HD, Hkv * HD) &&
                    vec16(wv, (int64_t)Hkv * HD, Hkv * HD);
  const dim3 grid((M + BM - 1) / BM, Hq + 2 * Hkv);
  fused_qkv_kernel<T, HD><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)wq, (const T*)wk, (const T*)wv, (const T*)bq, (const T*)bk,
      (const T*)bv, (const float*)cos_t, (const float*)sin_t, (const int*)lengths, (T*)q,
      (T*)k, (T*)v, (T*)kc, (T*)vc, M, T_nodes, d, Hq, Hkv, S, kc_sb, kc_ss, kc_sh, vc_sb,
      vc_ss, vc_sh, (const int*)table, ps, mb, a_vec, b_vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* wq, const void* wk, const void* wv, const void* bq,
             const void* bk, const void* bv, const void* cos_t, const void* sin_t,
             const void* lengths, void* q, void* k, void* v, void* kc, void* vc, int M,
             int T_nodes, int d, int Hq, int Hkv, int hd, int S, int64_t kc_sb,
             int64_t kc_ss, int64_t kc_sh, int64_t vc_sb, int64_t vc_ss, int64_t vc_sh,
             const void* table, int ps, int mb, void* stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(x, wq, wk, wv, bq, bk, bv, cos_t, sin_t, lengths, q, k, v, kc, vc,
                           M, T_nodes, d, Hq, Hkv, S, kc_sb, kc_ss, kc_sh, vc_sb, vc_ss,
                           vc_sh, table, ps, mb, stream);
    case 128:
      return launch<T, 128>(x, wq, wk, wv, bq, bk, bv, cos_t, sin_t, lengths, q, k, v, kc,
                            vc, M, T_nodes, d, Hq, Hkv, S, kc_sb, kc_ss, kc_sh, vc_sb,
                            vc_ss, vc_sh, table, ps, mb, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x [M, d] contiguous (M = B * T rows, row b*T + t); wq [d, Hq*hd], wk / wv
// [d, Hkv*hd] contiguous, all in x's dtype; bq [Hq, hd], bk / bv [Hkv, hd]
// or all null; cos / sin [M, hd/2] f32 or both null (no RoPE); lengths [B]
// int32; q [M, Hq, hd], k / v [M, Hkv, hd] outputs; kc / vc the caches
// [B, S, Hkv, hd] with element strides (b, s, h) and unit stride over hd,
// or (table [B, mb] int32 given) pools [n_blocks, ps, Hkv, hd] whose block
// stride is ps times the row stride s (b is then unused).
// One launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fused_qkv_rope_commit_f32(
    const void* x, const void* wq, const void* wk, const void* wv, const void* bq,
    const void* bk, const void* bv, const void* cos_t, const void* sin_t,
    const void* lengths, void* q, void* k, void* v, void* kc, void* vc, int M, int T_nodes,
    int d, int Hq, int Hkv, int hd, int S, int64_t kc_sb, int64_t kc_ss, int64_t kc_sh,
    int64_t vc_sb, int64_t vc_ss, int64_t vc_sh, const void* table, int ps, int mb,
    void* stream) {
  return dispatch<float>(x, wq, wk, wv, bq, bk, bv, cos_t, sin_t, lengths, q, k, v, kc, vc,
                         M, T_nodes, d, Hq, Hkv, hd, S, kc_sb, kc_ss, kc_sh, vc_sb, vc_ss,
                         vc_sh, table, ps, mb, stream);
}

extern "C" int fused_qkv_rope_commit_bf16(
    const void* x, const void* wq, const void* wk, const void* wv, const void* bq,
    const void* bk, const void* bv, const void* cos_t, const void* sin_t,
    const void* lengths, void* q, void* k, void* v, void* kc, void* vc, int M, int T_nodes,
    int d, int Hq, int Hkv, int hd, int S, int64_t kc_sb, int64_t kc_ss, int64_t kc_sh,
    int64_t vc_sb, int64_t vc_ss, int64_t vc_sh, const void* table, int ps, int mb,
    void* stream) {
  return dispatch<__nv_bfloat16>(x, wq, wk, wv, bq, bk, bv, cos_t, sin_t, lengths, q, k, v,
                                 kc, vc, M, T_nodes, d, Hq, Hkv, hd, S, kc_sb, kc_ss, kc_sh,
                                 vc_sb, vc_ss, vc_sh, table, ps, mb, stream);
}
