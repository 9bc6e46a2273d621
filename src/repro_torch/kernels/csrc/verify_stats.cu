// Fused unembed + greedy/sampled verification statistics, for Hopper
// (sm_90a).
//
// Replaces repro/kernels/tree_attention.py::unembed_verify_stats (Pallas
// body `_verify_stats_kernel`).  For hidden [N = B*T, d] and the lm head
// w [d, V] it emits, per row (b, t), with z = (h . w[:, v]) rounded through
// the activation dtype and wv = z / tmax[b]:
//   argm[b,t]      first index of max_v wv            (int32)
//   m[b,t]         max_v wv                            (f32)
//   l[b,t]         sum_v exp(wv - m)                   (f32)
//   cand_w[b,t,j]  wv at v = candidates[b, j]          (f32; 0 if out of range)
// and never writes a [N, V] logits tensor.
//
// Bound: at the spec step (N 256, d 4096, V 153376, bf16) the lm head is
// 1.26 GB against 3.2e11 flops, so the work sits just below the card's
// operations-per-byte line: ~0.38 ms by bytes, ~0.33 ms by tensor-core
// flops.  The TPU kernel walks the vocabulary in order per row, carrying
// (max, argmax, sum-exp) in VMEM.  Here a first pass leaves per-row
// partials in vocabulary order and a second launch, `verify_stats_merge`
// (one block per row), merges them in that order (ties keep the lowest
// index: first wins, as torch.argmax) and rescales the partial sums to the
// global max.  Two routes make the partials, chosen by the wrapper:
//
// wgmma route (bf16, 16-byte aligned rows): `verify_stats_wgmma`, a
// persistent grid of n_parts blocks (one per SM), over hopper_gemm.cuh.
// Each block walks its 128-column vocabulary tiles in ascending order; the
// loop inside the block takes the place of the TPU kernel's sequential
// vocabulary grid.  A block's row tile covers BM = 256 rows (two consumer
// warpgroups of 128), so at N <= 256 the head leaves HBM exactly once;
// larger N loops over row tiles.  A producer warp keeps a 4-stage TMA ring
// of (hidden, head) k-slices full.  `hidden` (2 MB) is needed again for
// every vocabulary tile and lives in L2; the blocks come in clusters of 2
// that walk neighbouring tiles in lockstep and multicast each hidden tile
// to both, halving what L2 serves (unshared, the 2.4 GB of re-reads held
// the kernel near L2's rate; clusters of 4 were slower than 2 on an H100).
// Each row's running (max, first argmax, sum-exp) stays in registers
// across the block's tiles, reduced over the 4 threads that share a row by
// shuffles, so the partials shrink to N x n_parts.  Each tile's epilogue
// writes the cand_w
// entries whose candidate falls in it, from the same rounded value the
// sweep saw: the block lists the tile's candidates in shared memory, and
// the one thread holding each value writes it (one writer per entry, no
// atomics on the outputs).
//
// tile route (f32, or rows TMA cannot take): `verify_stats_tile`, block
// (row tile of 128 rows, vocab tile of 128 columns) computes its logits
// tile through tile_gemm.cuh (mma.sync for bf16, CUDA-core FMAs for f32),
// rounds and warps it in shared memory, and writes per-row partials for
// its tile; N x ceil(V / 128) partials.
//
// Either way candidates outside [0, V) have no tile: the merge writes 0.
#include "hopper_gemm.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace tile_gemm;

constexpr int BM = 128;  // rows per block
constexpr int BN = 128;  // vocabulary columns per block
constexpr int LDC = Tile<BM, BN>::LDC;

// (value, index) max with ties to the lower index
__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) verify_stats_tile(
    const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ cand,
    const float* __restrict__ tmax, float* __restrict__ cand_w, float* __restrict__ pm,
    int* __restrict__ pi, float* __restrict__ pl, int N, int T_nodes, int d, int V,
    int n_vt, int a_vec, int b_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* C = reinterpret_cast<float*>(smem);
  const int row0 = blockIdx.x * BM;
  const int vt = blockIdx.y;
  const int col0 = vt * BN;
  gemm_tile<BM, BN>(h, d, N, row0, w, V, V, col0, d, a_vec, b_vec, smem, C);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM && row0 + r < N; r += NT / 32) {
    const int row = row0 + r;
    const float tm = tmax[row / T_nodes];
    float best = -INFINITY;
    int bi = 0x7fffffff;
    float wv[BN / 32];
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const int c = lane + 32 * i;
      // round through the activation dtype, then warp by true division
      wv[i] = __fdiv_rn(round_as(C[r * LDC + c], h), tm);
      C[r * LDC + c] = wv[i];
      if (col0 + c < V && wv[i] > best) {  // ascending columns: first wins
        best = wv[i];
        bi = col0 + c;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      better(best, bi, __shfl_xor_sync(0xffffffffu, best, o),
             __shfl_xor_sync(0xffffffffu, bi, o));
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 32; ++i)
      if (col0 + lane + 32 * i < V) s += expf(wv[i] - best);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const int64_t at = (int64_t)row * n_vt + vt;
      pm[at] = best;
      pi[at] = bi;
      pl[at] = s;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BM * T_nodes; e += NT) {
    const int r = e / T_nodes, j = e % T_nodes;
    const int row = row0 + r;
    if (row >= N) break;
    const int c = cand[(row / T_nodes) * T_nodes + j] - col0;
    if (c >= 0 && c < BN && col0 + c < V) cand_w[(int64_t)row * T_nodes + j] = C[r * LDC + c];
  }
}

constexpr int MT = 256;  // merge threads per row

__global__ void __launch_bounds__(MT) verify_stats_merge(
    const float* __restrict__ pm, const int* __restrict__ pi, const float* __restrict__ pl,
    const int* __restrict__ cand, int* __restrict__ argm, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ cand_w, int T_nodes, int V, int n_vt) {
  __shared__ float sv[MT];
  __shared__ int si[MT];
  const int row = blockIdx.x, tid = threadIdx.x;
  const float* rm = pm + (int64_t)row * n_vt;
  const int* ri = pi + (int64_t)row * n_vt;
  const float* rl = pl + (int64_t)row * n_vt;
  float best = -INFINITY;
  int bi = 0x7fffffff;
  for (int t = tid; t < n_vt; t += MT) better(best, bi, rm[t], ri[t]);
  sv[tid] = best;
  si[tid] = bi;
  __syncthreads();
  for (int o = MT / 2; o > 0; o >>= 1) {
    if (tid < o) {
      float v = sv[tid];
      int i = si[tid];
      better(v, i, sv[tid + o], si[tid + o]);
      sv[tid] = v;
      si[tid] = i;
    }
    __syncthreads();
  }
  const float m = sv[0];
  const int am = si[0];
  __syncthreads();
  float s = 0.f;
  for (int t = tid; t < n_vt; t += MT) s += rl[t] * expf(rm[t] - m);
  sv[tid] = s;
  __syncthreads();
  for (int o = MT / 2; o > 0; o >>= 1) {
    if (tid < o) sv[tid] += sv[tid + o];
    __syncthreads();
  }
  if (tid == 0) {
    argm[row] = am;
    m_out[row] = m;
    l_out[row] = sv[0];
  }
  // candidates outside [0, V) have no tile to write them
  const int b0 = (row / T_nodes) * T_nodes;
  for (int j = tid; j < T_nodes; j += MT) {
    const int c = cand[b0 + j];
    if (c < 0 || c >= V) cand_w[(int64_t)row * T_nodes + j] = 0.f;
  }
}

template <typename T>
int launch(const void* h, const void* w, const void* cand, const void* tmax, void* argm,
           void* m, void* l, void* cand_w, void* pm, void* pi, void* pl, int N,
           int T_nodes, int d, int V, void* stream) {
  const int n_vt = (V + BN - 1) / BN;
  const int smem = Tile<BM, BN>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      verify_stats_tile<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int a_vec = vec16(h, d, d), b_vec = vec16(w, V, V);
  const dim3 grid((N + BM - 1) / BM, n_vt);
  cudaStream_t s = (cudaStream_t)stream;
  verify_stats_tile<T><<<grid, NT, smem, s>>>(
      (const T*)h, (const T*)w, (const int*)cand, (const float*)tmax, (float*)cand_w,
      (float*)pm, (int*)pi, (float*)pl, N, T_nodes, d, V, n_vt, a_vec, b_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  verify_stats_merge<<<N, MT, 0, s>>>((const float*)pm, (const int*)pi, (const float*)pl,
                                      (const int*)cand, (int*)argm, (float*)m, (float*)l,
                                      (float*)cand_w, T_nodes, V, n_vt);
  return (int)cudaGetLastError();
}


// --------------------------------------------------------------------------
// wgmma route
// --------------------------------------------------------------------------

struct StatsCfg {
  static constexpr int CL = 2;          // blocks of a cluster sharing each hidden tile
  static constexpr int NC = 2, MB = 2;  // consumer warpgroups, m64 blocks each
  static constexpr int WG_M = 64 * MB, BM = NC * WG_M;
  static constexpr int BN = 128;        // vocabulary columns per tile
  static constexpr int ST = 4;
  using RG = hopper::Ring<BM, BN, ST>;
  static constexpr int HITS = 1024;     // candidates listed per pass
  static constexpr int SMEM = RG::BYTES + 1024 + 2 * ST * 8 + HITS * 4 + 16;
  static constexpr int THREADS = (NC + 1) * 128;
  static constexpr int CT = NC * 128;   // consumer threads
};

__device__ __forceinline__ float round_bf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__global__ void __launch_bounds__(StatsCfg::THREADS, 1) verify_stats_wgmma(
    const __grid_constant__ CUtensorMap h_map, const __grid_constant__ CUtensorMap w_map,
    const int* __restrict__ cand, const float* __restrict__ tmax, float* __restrict__ cand_w,
    float* __restrict__ pm, int* __restrict__ pi, float* __restrict__ pl, int N, int T_nodes,
    int d, int V, int n_parts) {
  using C = StatsCfg;
  using RG = C::RG;
  constexpr int CL = C::CL;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RG::BYTES);
  uint64_t* empty = full + C::ST;
  int* hits = reinterpret_cast<int*>(empty + C::ST);
  int* n_hits = hits + C::HITS;

  // block `part` is rank r of cluster cl = part / CL.  Cluster cl owns the
  // vocabulary tiles [t0, t1), a contiguous run, and walks them CL at a
  // time in lockstep, rank r taking tile t0 + CL j + r at step j: each
  // block's tiles ascend.  A tile at or past t1 (in the last step, when
  // the run's length is not a multiple of CL) is padding: the block still
  // loads and multiplies it, since its peers need the shared hidden tile,
  // and masks every column of it.
  const int part = blockIdx.x;
  const int r = part % CL, n_cl = n_parts / CL, cl = part / CL;
  const uint16_t mask = (uint16_t)((1u << CL) - 1);
  const int n_vt = (V + C::BN - 1) / C::BN;
  const int t0 = (int)((int64_t)cl * n_vt / n_cl);
  const int t1 = (int)((int64_t)(cl + 1) * n_vt / n_cl);
  const int n_steps = (t1 - t0 + CL - 1) / CL;
  const int n_mt = (N + C::BM - 1) / C::BM;
  const int nk = (d + hopper::BK - 1) / hopper::BK;
  const int wg = threadIdx.x / hopper::WG_THREADS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], hopper::empty_count(C::NC, CL));
    }
    hopper::fence_barrier_init();
  }
  // every block's barriers exist before any block multicasts or arrives
  hopper::cluster_sync();

  if (wg == C::NC) {  // producer warpgroup: one thread issues every TMA copy
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x % hopper::WG_THREADS == 0) {
      uint32_t it = 0;
      for (int mt = 0; mt < n_mt; ++mt)
        for (int j = 0; j < n_steps; ++j)
          hopper::produce<RG, CL>(smem, full, empty, it, &h_map, mt * C::BM, &w_map,
                                  (t0 + CL * j + r) * C::BN, 0, nk, r, mask);
    }
    __syncwarp();
    hopper::cluster_sync();  // no block leaves while others write into it
  } else {
    hopper::setmaxnreg_inc<232>();
    const int ct = threadIdx.x;  // 0 .. CT-1
    const int t = ct % hopper::WG_THREADS;
    const int q = t % 4;
    uint32_t it = 0;
    for (int mt = 0; mt < n_mt; ++mt) {
      // this thread's rows [mb][h] and their running statistics
      int row[C::MB][2];
      float tm[C::MB][2], rm[C::MB][2], rl[C::MB][2];
      int ri[C::MB][2];
#pragma unroll
      for (int i = 0; i < C::MB; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          row[i][h] = mt * C::BM + wg * C::WG_M + i * 64 + hopper::frag_row(t) + 8 * h;
          tm[i][h] = tmax[min(row[i][h], N - 1) / T_nodes];
          rm[i][h] = -INFINITY;
          rl[i][h] = 0.f;
          ri[i][h] = 0x7fffffff;
        }
      for (int j = 0; j < n_steps; ++j) {
        float acc[C::MB][C::BN / 2];
#pragma unroll
        for (int i = 0; i < C::MB; ++i)
#pragma unroll
          for (int j = 0; j < C::BN / 2; ++j) acc[i][j] = 0.f;
        hopper::consume<RG, C::MB, CL>(acc, smem, full, empty, it, wg * C::WG_M, nk, mask);
        const int tile = t0 + CL * j + r;
        const int col0 = tile * C::BN;
        const int col_end = tile < t1 ? V : 0;  // columns past it are masked
#pragma unroll
        for (int i = 0; i < C::MB; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // round through the activation dtype, then warp by true
            // division (x / 1 is x: greedy rows skip it)
            float best = -INFINITY;
            int bi = 0x7fffffff;
#pragma unroll
            for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = col0 + 8 * j + 2 * q + e;
                float v = round_bf(acc[i][4 * j + 2 * h + e]);
                if (tm[i][h] != 1.f) v = __fdiv_rn(v, tm[i][h]);
                if (c >= col_end) v = -INFINITY;
                acc[i][4 * j + 2 * h + e] = v;
                if (v > best) {  // ascending columns: first wins
                  best = v;
                  bi = c;
                }
              }
#pragma unroll
            for (int o = 1; o <= 2; o <<= 1)
              better(best, bi, __shfl_xor_sync(0xffffffffu, best, o),
                     __shfl_xor_sync(0xffffffffu, bi, o));
            const float m_new = fmaxf(rm[i][h], best);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) sum += expf(acc[i][4 * j + 2 * h + e] - m_new);
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            if (best > -INFINITY) {  // a padding tile leaves the row alone
              if (best > rm[i][h]) ri[i][h] = bi;  // an earlier tile wins ties
              rl[i][h] = rl[i][h] * expf(rm[i][h] - m_new) + sum;
              rm[i][h] = m_new;
            }
          }
        // the candidates in this tile: listed, then written by the thread
        // that holds each value
        for (int c0 = 0; c0 < N; c0 += C::HITS) {
          if (ct == 0) *n_hits = 0;
          hopper::bar_sync(1, C::CT);
          const int c1 = min(N, c0 + C::HITS);
          for (int i = c0 + ct; i < c1; i += C::CT) {
            const int c = cand[i];
            if (c >= col0 && c < col0 + C::BN && c < col_end) hits[atomicAdd(n_hits, 1)] = i;
          }
          hopper::bar_sync(1, C::CT);
          const int nh = *n_hits;
          for (int k = 0; k < nh; ++k) {
            const int i = hits[k];
            const int rel = cand[i] - col0;
            if (((rel & 7) >> 1) != q) continue;
            const int b = i / T_nodes, j = i % T_nodes;
            const int jj = rel >> 3, e = rel & 1;
#pragma unroll
            for (int a = 0; a < C::MB; ++a)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (row[a][h] >= N || row[a][h] / T_nodes != b) continue;
                float v = 0.f;
#pragma unroll
                for (int x = 0; x < C::BN / 8; ++x)
                  if (x == jj) v = e ? acc[a][4 * x + 2 * h + 1] : acc[a][4 * x + 2 * h];
                cand_w[(int64_t)row[a][h] * T_nodes + j] = v;
              }
          }
          hopper::bar_sync(1, C::CT);
        }
      }
      if (q == 0) {
#pragma unroll
        for (int i = 0; i < C::MB; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (row[i][h] < N) {
              const int64_t at = (int64_t)row[i][h] * n_parts + part;
              pm[at] = rm[i][h];
              pi[at] = ri[i][h];
              pl[at] = rl[i][h];
            }
      }
    }
    __syncwarp();
    hopper::cluster_sync();
  }
}

int launch_wgmma(const void* h, const void* w, const void* cand, const void* tmax, void* argm,
                 void* m, void* l, void* cand_w, void* pm, void* pi, void* pl, int N,
                 int T_nodes, int d, int V, int n_parts, void* stream) {
  CUtensorMap hm, wm;
  int e = hopper_host::encode_map(&hm, h, d, N, (uint64_t)d * 2, 64,
                                 StatsCfg::BM / StatsCfg::CL);
  if (!e) e = hopper_host::weight_map(&wm, w, V, d, (uint64_t)V * 2, 64, 64);
  if (e) return e;
  auto kernel = verify_stats_wgmma;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, StatsCfg::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_parts);
  cfg.blockDim = dim3(StatsCfg::THREADS);
  cfg.dynamicSmemBytes = StatsCfg::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = StatsCfg::CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, hm, wm, (const int*)cand,
                                       (const float*)tmax, (float*)cand_w, (float*)pm, (int*)pi,
                                       (float*)pl, N, T_nodes, d, V, n_parts);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  verify_stats_merge<<<N, MT, 0, s>>>((const float*)pm, (const int*)pi, (const float*)pl,
                                      (const int*)cand, (int*)argm, (float*)m, (float*)l,
                                      (float*)cand_w, T_nodes, V, n_parts);
  return (int)cudaGetLastError();
}

}  // namespace

// The tile route.  hidden [N, d] and w [d, V] row-major in the same dtype;
// candidates [N / T, T] int32; tmax [N / T] f32; argm [N] int32; m, l [N]
// f32; cand_w [N, T] f32; partials pm, pl [N, n_vt] f32 and pi [N, n_vt]
// int32 (scratch), n_vt = ceil(V / 128).  Two launches on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int verify_stats_f32(const void* h, const void* w, const void* cand,
                                const void* tmax, void* argm, void* m, void* l,
                                void* cand_w, void* pm, void* pi, void* pl, int N,
                                int T_nodes, int d, int V, void* stream) {
  return launch<float>(h, w, cand, tmax, argm, m, l, cand_w, pm, pi, pl, N, T_nodes, d, V,
                       stream);
}

extern "C" int verify_stats_bf16(const void* h, const void* w, const void* cand,
                                 const void* tmax, void* argm, void* m, void* l,
                                 void* cand_w, void* pm, void* pi, void* pl, int N,
                                 int T_nodes, int d, int V, void* stream) {
  return launch<__nv_bfloat16>(h, w, cand, tmax, argm, m, l, cand_w, pm, pi, pl, N,
                               T_nodes, d, V, stream);
}

// The wgmma route, bf16 only: arguments as above with partials
// [N, n_parts]: n_parts blocks in clusters of 2 that share each hidden
// tile, n_parts even and at most 2 ceil(V / 128); h, w and their row
// strides 16-byte aligned.  The head's map is cached across calls.  Two
// launches on `stream`.
extern "C" int verify_stats_bf16_wgmma(const void* h, const void* w, const void* cand,
                                       const void* tmax, void* argm, void* m, void* l,
                                       void* cand_w, void* pm, void* pi, void* pl, int N,
                                       int T_nodes, int d, int V, int n_parts, void* stream) {
  const int n_vt = (V + StatsCfg::BN - 1) / StatsCfg::BN;
  if (n_parts < StatsCfg::CL || n_parts % StatsCfg::CL || n_parts / StatsCfg::CL > n_vt)
    return (int)cudaErrorInvalidValue;
  return launch_wgmma(h, w, cand, tmax, argm, m, l, cand_w, pm, pi, pl, N, T_nodes, d, V,
                      n_parts, stream);
}

// Tensor maps encoded for weights since the library was loaded.
extern "C" long long verify_stats_map_encodings() { return hopper_host::encodings(); }
