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
// ms by bytes; at the AR step (M 4) the weights are nearly all of it, so
// the kernel is a weight stream.
//
// Two routes, chosen by the wrapper from the dtype and the alignment:
//
// wgmma route (bf16, every row stride and pointer 16-byte aligned):
// `qkv_wgmma_kernel` over hopper_gemm.cuh.  A block owns one head (a column
// tile of exactly head_dim columns, so RoPE's pair (i, i + hd/2) and the
// head's cache rows stay in it) and BM rows: at the spec step (M > 64) BM =
// 256, two consumer warpgroups of 128 rows, so each weight byte leaves HBM
// once per row tile; at the AR step (M <= 64) BM = 64, one consumer
// warpgroup whose m64 wgmma tile is mostly padding.  48 heads are too few
// for 132 SMs, so the depth d is split over a cluster of `splits` blocks
// (2 at the spec step: 96 blocks; 4 at the AR step: 192 blocks, two per SM,
// each keeping 4 stages of weight boxes in flight).  Each block writes its
// f32 partial tile into its own shared memory (reusing the ring); after a
// cluster barrier, block r sums rows [r BM / splits, (r+1) BM / splits) of
// all the cluster's tiles through distributed shared memory in rank order
// (no atomics: the sum never depends on timing, so the dense and paged
// variants and every run give bitwise equal q, k and v), applies bias and
// RoPE in registers, and writes q / k / v and the cache rows with 16-byte
// stores (one head row of a cache row is hd * 2 contiguous bytes).  The
// spec step's 96 blocks leave 36 SMs idle; that, not L2, bounds it: having
// two or four heads of a cluster share each x tile by multicast, which
// halves or quarters what L2 serves, did not change its time on an H100.
//
// tile route (f32, or any stride TMA cannot take): a block owns (64 rows,
// one head), grid (ceil(M/64), Hq + 2 Hkv), the product through
// tile_gemm.cuh (mma.sync for bf16, CUDA-core FMAs for f32: TF32 is never
// used), the epilogue with element stores.
#include "hopper_gemm.cuh"
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


// --------------------------------------------------------------------------
// wgmma route
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int HD, int NC>
struct QkvCfg {
  static constexpr int MB = NC == 2 ? 2 : 1;  // m64 blocks per consumer warpgroup
  static constexpr int WG_M = 64 * MB;
  static constexpr int BM = NC * WG_M;        // 256 (spec step) or 64 (AR step)
  static constexpr int ST = 4;
  using RG = hopper::Ring<BM, HD, ST>;
  static constexpr int LDC = HD + 8;  // f32 tile row stride: float2 writes spread over banks
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int BODY = RG::BYTES > C_BYTES ? RG::BYTES : C_BYTES;
  static constexpr int SMEM = BODY + 1024 + 2 * ST * 8;
  static constexpr int THREADS = (NC + 1) * 128;
};

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}
__device__ __forceinline__ float round_bf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 8 consecutive f32 of the partial tiles at tile[off], summed over the
// cluster's blocks in rank order
__device__ __forceinline__ void sum_ranks(float (&z)[8], const float* tile, int off, int KS) {
  if (KS == 1) {
    const float4 a = *reinterpret_cast<const float4*>(tile + off);
    const float4 b = *reinterpret_cast<const float4*>(tile + off + 4);
    z[0] = a.x, z[1] = a.y, z[2] = a.z, z[3] = a.w;
    z[4] = b.x, z[5] = b.y, z[6] = b.z, z[7] = b.w;
    return;
  }
  const uint32_t local = hopper::smem_u32(tile + off);
  for (int r = 0; r < KS; ++r) {
    const uint32_t a = hopper::map_rank(local, (uint32_t)r);
    const float4 u = hopper::ld_cluster_f4(a), v = hopper::ld_cluster_f4(a + 16);
    if (r == 0) {
      z[0] = u.x, z[1] = u.y, z[2] = u.z, z[3] = u.w;
      z[4] = v.x, z[5] = v.y, z[6] = v.z, z[7] = v.w;
    } else {
      z[0] += u.x, z[1] += u.y, z[2] += u.z, z[3] += u.w;
      z[4] += v.x, z[5] += v.y, z[6] += v.z, z[7] += v.w;
    }
  }
}

template <int HD, int NC>
__global__ void __launch_bounds__(QkvCfg<HD, NC>::THREADS, NC == 1 ? 2 : 1) qkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap wq_map,
    const __grid_constant__ CUtensorMap wk_map, const __grid_constant__ CUtensorMap wv_map,
    const bf16* __restrict__ bq, const bf16* __restrict__ bk, const bf16* __restrict__ bv,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const int* __restrict__ lengths, bf16* __restrict__ q_out, bf16* __restrict__ k_out,
    bf16* __restrict__ v_out, bf16* kc, bf16* vc, int M, int T_nodes, int d, int Hq, int Hkv,
    int S, int64_t kc_sb, int64_t kc_ss, int64_t kc_sh, int64_t vc_sb, int64_t vc_ss,
    int64_t vc_sh, const int* __restrict__ table, int ps, int mb) {
  using C = QkvCfg<HD, NC>;
  using RG = typename C::RG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BODY);
  uint64_t* empty = full + C::ST;

  const int KS = gridDim.x;  // the cluster is (KS, 1, 1): rank == blockIdx.x
  const int split = blockIdx.x;
  int head = blockIdx.y;
  const int m0 = blockIdx.z * C::BM;
  // which projection this block computes: 0 = q, 1 = k, 2 = v
  const int part = head < Hq ? 0 : (head < Hq + Hkv ? 1 : 2);
  head -= part == 0 ? 0 : (part == 1 ? Hq : Hq + Hkv);
  const int nk = (d + hopper::BK - 1) / hopper::BK;
  const int kt0 = split * nk / KS, kt1 = (split + 1) * nk / KS;
  const int wg = threadIdx.x / hopper::WG_THREADS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], hopper::empty_count(NC, 1));
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == NC) {  // producer warpgroup: one thread issues every TMA copy
    if constexpr (NC == 2) hopper::setmaxnreg_dec<40>();
    if (threadIdx.x % hopper::WG_THREADS == 0) {
      const CUtensorMap* w = part == 0 ? &wq_map : (part == 1 ? &wk_map : &wv_map);
      uint32_t it = 0;
      hopper::produce<RG>(smem, full, empty, it, &x_map, m0, w, head * HD, kt0, kt1);
    }
    __syncwarp();
    hopper::cluster_sync();  // the partial tiles are written
    hopper::cluster_sync();  // every block has read them
  } else {
    if constexpr (NC == 2) hopper::setmaxnreg_inc<232>();
    float acc[C::MB][HD / 2];
#pragma unroll
    for (int i = 0; i < C::MB; ++i)
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[i][j] = 0.f;
    uint32_t it = 0;
    hopper::consume<RG, C::MB>(acc, smem, full, empty, it, wg * C::WG_M, kt1 - kt0);
    // every consumer's products have read the ring before it becomes the tile
    hopper::bar_sync(1, NC * hopper::WG_THREADS);
    float* tile = reinterpret_cast<float*>(smem);
    const int t = threadIdx.x % hopper::WG_THREADS;
#pragma unroll
    for (int i = 0; i < C::MB; ++i) {
      const int r = wg * C::WG_M + i * 64 + hopper::frag_row(t);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int c = 8 * j + hopper::frag_col(t);
        *reinterpret_cast<float2*>(tile + r * C::LDC + c) =
            make_float2(acc[i][4 * j], acc[i][4 * j + 1]);
        *reinterpret_cast<float2*>(tile + (r + 8) * C::LDC + c) =
            make_float2(acc[i][4 * j + 2], acc[i][4 * j + 3]);
      }
    }
    hopper::cluster_sync();  // every block's partial tile is visible

    const int H = part == 0 ? Hq : Hkv;
    const bf16* bias = part == 0 ? bq : (part == 1 ? bk : bv);
    bf16* out = part == 0 ? q_out : (part == 1 ? k_out : v_out);
    bf16* cache = part == 1 ? kc : vc;
    const int64_t sb = part == 1 ? kc_sb : vc_sb;
    const int64_t ss = part == 1 ? kc_ss : vc_ss;
    const int64_t sh = part == 1 ? kc_sh : vc_sh;
    const bool rope = cos_t != nullptr && part != 2;
    constexpr int HALF = HD / 2, CH = HALF / 8;
    const int r_lo = split * C::BM / KS, r_hi = (split + 1) * C::BM / KS;
    for (int e = threadIdx.x; e < (r_hi - r_lo) * CH; e += NC * hopper::WG_THREADS) {
      const int r = r_lo + e / CH, c = (e % CH) * 8;
      const int row = m0 + r;
      if (row >= M) continue;
      float z1[8], z2[8];
      sum_ranks(z1, tile, r * C::LDC + c, KS);
      sum_ranks(z2, tile, r * C::LDC + c + HALF, KS);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        z1[i] = round_bf(z1[i]);
        z2[i] = round_bf(z2[i]);
      }
      if (bias != nullptr) {
        float b1[8], b2[8];
        unpack8(*reinterpret_cast<const uint4*>(bias + head * HD + c), b1);
        unpack8(*reinterpret_cast<const uint4*>(bias + head * HD + c + HALF), b2);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          z1[i] = round_bf(z1[i] + b1[i]);
          z2[i] = round_bf(z2[i] + b2[i]);
        }
      }
      if (rope) {
        const float4* cp = reinterpret_cast<const float4*>(cos_t + (int64_t)row * HALF + c);
        const float4* sp = reinterpret_cast<const float4*>(sin_t + (int64_t)row * HALF + c);
        const float4 c0 = cp[0], c1 = cp[1], s0 = sp[0], s1 = sp[1];
        const float cs[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float o1 = __fsub_rn(__fmul_rn(z1[i], cs[i]), __fmul_rn(z2[i], sn[i]));
          const float o2 = __fadd_rn(__fmul_rn(z2[i], cs[i]), __fmul_rn(z1[i], sn[i]));
          z1[i] = o1;
          z2[i] = o2;
        }
      }
      const uint4 u1 = pack8(z1), u2 = pack8(z2);
      bf16* o = out + ((int64_t)row * H + head) * HD;
      *reinterpret_cast<uint4*>(o + c) = u1;
      *reinterpret_cast<uint4*>(o + c + HALF) = u2;
      if (part != 0) {
        const int b = row / T_nodes, tt = row % T_nodes;
        const int pos = lengths[b] + tt;
        bf16* dst = nullptr;
        if (table != nullptr) {
          const int lb = pos / ps;
          const int blk = lb < mb ? table[(int64_t)b * mb + lb] : 0;
          dst = cache + ((int64_t)blk * ps + pos % ps) * ss + (int64_t)head * sh;
        } else if (pos >= 0 && pos < S) {
          dst = cache + (int64_t)b * sb + (int64_t)pos * ss + (int64_t)head * sh;
        }
        if (dst != nullptr) {
          *reinterpret_cast<uint4*>(dst + c) = u1;
          *reinterpret_cast<uint4*>(dst + c + HALF) = u2;
        }
      }
    }
    __syncwarp();
    hopper::cluster_sync();  // no block leaves while another reads its tile
  }
}

template <int HD, int NC>
int launch_wgmma(const CUtensorMap& xm, const CUtensorMap& wqm, const CUtensorMap& wkm,
                 const CUtensorMap& wvm, const void* bq, const void* bk, const void* bv,
                 const void* cos_t, const void* sin_t, const void* lengths, void* q, void* k,
                 void* v, void* kc, void* vc, int M, int T_nodes, int d, int Hq, int Hkv,
                 int S, int64_t kc_sb, int64_t kc_ss, int64_t kc_sh, int64_t vc_sb,
                 int64_t vc_ss, int64_t vc_sh, const void* table, int ps, int mb, int splits,
                 cudaStream_t stream) {
  using C = QkvCfg<HD, NC>;
  auto kernel = qkv_wgmma_kernel<HD, NC>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, Hq + 2 * Hkv, (M + C::BM - 1) / C::BM);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, xm, wqm, wkm, wvm, (const bf16*)bq, (const bf16*)bk, (const bf16*)bv,
      (const float*)cos_t, (const float*)sin_t, (const int*)lengths, (bf16*)q, (bf16*)k,
      (bf16*)v, (bf16*)kc, (bf16*)vc, M, T_nodes, d, Hq, Hkv, S, kc_sb, kc_ss, kc_sh, vc_sb,
      vc_ss, vc_sh, (const int*)table, ps, mb);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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

// The wgmma route, bf16 only; arguments as above, plus `consumers` (2: 256
// rows a block, the spec step; 1: 64 rows, the AR step, M <= 64) and
// `splits` (the cluster size along d, 1 to 8).  Every pointer and row
// stride must be 16-byte aligned (the wrapper checks; it routes other
// shapes to the functions above).  Weight maps are cached across calls.
extern "C" int fused_qkv_rope_commit_bf16_wgmma(
    const void* x, const void* wq, const void* wk, const void* wv, const void* bq,
    const void* bk, const void* bv, const void* cos_t, const void* sin_t,
    const void* lengths, void* q, void* k, void* v, void* kc, void* vc, int M, int T_nodes,
    int d, int Hq, int Hkv, int hd, int S, int64_t kc_sb, int64_t kc_ss, int64_t kc_sh,
    int64_t vc_sb, int64_t vc_ss, int64_t vc_sh, const void* table, int ps, int mb,
    int consumers, int splits, void* stream) {
  if ((consumers != 1 && consumers != 2) || splits < 1 || splits > 8 || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm, wqm, wkm, wvm;
  const uint32_t bm = consumers == 2 ? 256 : 64;
  int err = hopper_host::encode_map(&xm, x, d, M, (uint64_t)d * 2, 64, bm);
  if (!err) err = hopper_host::weight_map(&wqm, wq, (uint64_t)Hq * hd, d,
                                          (uint64_t)Hq * hd * 2, 64, 64);
  if (!err) err = hopper_host::weight_map(&wkm, wk, (uint64_t)Hkv * hd, d,
                                          (uint64_t)Hkv * hd * 2, 64, 64);
  if (!err) err = hopper_host::weight_map(&wvm, wv, (uint64_t)Hkv * hd, d,
                                          (uint64_t)Hkv * hd * 2, 64, 64);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
#define QKV_ARGS                                                                            \
  xm, wqm, wkm, wvm, bq, bk, bv, cos_t, sin_t, lengths, q, k, v, kc, vc, M, T_nodes, d, Hq, \
      Hkv, S, kc_sb, kc_ss, kc_sh, vc_sb, vc_ss, vc_sh, table, ps, mb, splits, s
  if (hd == 128)
    return consumers == 2 ? launch_wgmma<128, 2>(QKV_ARGS) : launch_wgmma<128, 1>(QKV_ARGS);
  return consumers == 2 ? launch_wgmma<64, 2>(QKV_ARGS) : launch_wgmma<64, 1>(QKV_ARGS);
#undef QKV_ARGS
}

// Tensor maps encoded for weights since the library was loaded.
extern "C" long long fused_qkv_rope_commit_map_encodings() { return hopper_host::encodings(); }
