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
// 1.26 GB against 3.2e11 flops, so the work sits just above the card's
// operations-per-byte line: ~0.38 ms by bytes, ~0.33 ms by tensor-core
// flops.  Design: the TPU kernel walks the vocabulary in order per row,
// carrying (max, argmax, sum-exp) in VMEM.  CUDA blocks run in no order, so
// here the vocabulary is tiled across blocks instead:
//   1. `verify_stats_tile`: block (row tile of BM = 128 rows, vocab tile of
//      BN = 128 columns) computes its logits tile (tile_gemm.cuh: mma.sync on
//      the tensor cores for bf16, CUDA cores for f32), rounds and warps it
//      in shared memory, and writes per-row partials for its tile: max,
//      first argmax, and sum-exp relative to that max.  It also writes the
//      cand_w entries whose candidate falls in its tile, from the same
//      rounded value the sweep saw; each (b, t, j) has exactly one writer,
//      so no atomics are needed.
//   2. `verify_stats_merge`: one block per row merges the row's partials
//      in vocabulary order (ties keep the lowest index: first wins, as
//      torch.argmax) and rescales the partial sums to the global max.
// Two blocks fit on an SM (registers capped at 128 a thread, 108 KB of
// shared memory each).  With BM = 128 the head is read ceil(N / 128) = 2
// times at the spec step (2.5 GB through L2); the row tile is blockIdx.x,
// so the blocks that share one vocab tile run together and the second
// read mostly hits L2.
// The partials take N * ceil(V / 128) * 12 bytes (3.7 MB at the spec step).
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

}  // namespace

// Number of vocabulary tiles, for sizing the partials: [N, n_vt] each.
extern "C" int verify_stats_n_tiles(int V) { return (V + BN - 1) / BN; }

// hidden [N, d] and w [d, V] row-major in the same dtype; candidates
// [N / T, T] int32; tmax [N / T] f32; argm [N] int32; m, l [N] f32;
// cand_w [N, T] f32; partials pm, pl [N, n_vt] f32 and pi [N, n_vt] int32
// (scratch).  Two launches on `stream`; returns cudaGetLastError() (0 on
// success).
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
