// One output tile of C = A @ B for the port's fused kernels (sm_90a).
//
// A [M, K] and B [K, N] are row-major with leading dimensions lda/ldb; a
// block of NT = 256 threads computes the f32 tile C[row0 : row0+BM,
// col0 : col0+BN] into shared memory (row stride LDC = BN + 4), where the
// calling kernel's epilogue reads it.  Rows past M, columns past N and
// depth past K are zero-filled, so they contribute exact zeros.
//
//   bf16: mma.sync m16n8k16 bf16 -> f32 on the tensor cores, fed by
//         ldmatrix (B transposed on the load, so it stays [K, N] in shared
//         memory as it is in device memory); A and B tiles of depth 64 in a
//         ring of 3 shared-memory stages filled with cp.async (16-byte
//         copies) when the rows are 16-byte aligned, element loads
//         otherwise.  8 warps as 4 x 2, each owning a (BM/4) x (BN/2)
//         piece of the tile.  (nvcuda::wmma fragments in place of ldmatrix
//         + mma.sync took about 1.3x as long on the same tiles.)
//   f32:  CUDA-core FMAs (no TF32: float32 products stay float32, as the
//         port pins them), 16 x 16 threads, each owning (BM/16) x (BN/16)
//         outputs strided by 16 so shared-memory reads do not conflict.
//
// The sum over K runs in a fixed order per output element, independent of
// where the element sits in the tile, so equal columns of B give bitwise
// equal outputs.  wgmma, TMA and deeper pipelines are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tile_gemm {

constexpr int NT = 256;  // threads per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// x.astype(dtype).astype(float32): round an f32 value through T
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}
// d += a (16x16, row) * b (16x8, col): one m16n8k16 bf16 product, f32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int BN>
struct Bf16Tile {
  // depth 64 and 3 stages: of the depths 32 and 64 with 2 to 4 stages,
  // the fastest over both callers at openPangu-7B's shapes on an H100
  static constexpr int BK = 64;
  static constexpr int STAGES = 3;
  static constexpr int LDA = BK + 8;  // bf16 elements; rows stay 16-byte aligned
  static constexpr int LDB = BN + 8;
  static constexpr int WM = BM / 4, WN = BN / 2;
  static constexpr int FM = WM / 16, FN = WN / 8;  // m16 x n8 products per warp
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  static constexpr int LOOP_BYTES = STAGES * (A_ELEMS + B_ELEMS) * 2;
  static_assert(FM >= 1 && WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "tile shape");
};

template <int BM, int BN>
struct F32Tile {
  static constexpr int BK = 16;
  static constexpr int LDA = BM + 1;  // A stored transposed: [BK][BM + 1]
  static constexpr int RM = BM / 16, RN = BN / 16;
  static constexpr int LOOP_BYTES = (BK * LDA + BK * BN) * 4;
};

template <int BM, int BN>
struct Tile {
  static constexpr int LDC = BN + 4;
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int MAX_LOOP = Bf16Tile<BM, BN>::LOOP_BYTES > F32Tile<BM, BN>::LOOP_BYTES
                                      ? Bf16Tile<BM, BN>::LOOP_BYTES
                                      : F32Tile<BM, BN>::LOOP_BYTES;
  // the C tile reuses the main loop's buffers once the loop is done
  static constexpr int SMEM_BYTES = C_BYTES > MAX_LOOP ? C_BYTES : MAX_LOOP;
};

// Load one depth-BK stage of A and B into shared memory.
template <int BM, int BN>
__device__ __forceinline__ void load_stage_bf16(
    __nv_bfloat16* As, __nv_bfloat16* Bs, const __nv_bfloat16* A, int64_t lda, int M,
    int row0, const __nv_bfloat16* B, int64_t ldb, int N, int col0, int K, int k0,
    bool a_vec, bool b_vec) {
  using G = Bf16Tile<BM, BN>;
  constexpr int BK = G::BK;
  const int tid = threadIdx.x;
  if (a_vec) {
    for (int e = tid; e < BM * BK / 8; e += NT) {
      const int r = e / (BK / 8), k = (e % (BK / 8)) * 8;
      const bool ok = row0 + r < M && k0 + k < K;
      const __nv_bfloat16* src = ok ? A + (int64_t)(row0 + r) * lda + k0 + k : A;
      cp_async16(As + r * G::LDA + k, src, ok);
    }
  } else {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, k = e % BK;
      const bool ok = row0 + r < M && k0 + k < K;
      As[r * G::LDA + k] = ok ? A[(int64_t)(row0 + r) * lda + k0 + k] : __float2bfloat16(0.f);
    }
  }
  if (b_vec) {
    for (int e = tid; e < BK * BN / 8; e += NT) {
      const int k = e / (BN / 8), c = (e % (BN / 8)) * 8;
      const bool ok = k0 + k < K && col0 + c < N;
      const __nv_bfloat16* src = ok ? B + (int64_t)(k0 + k) * ldb + col0 + c : B;
      cp_async16(Bs + k * G::LDB + c, src, ok);
    }
  } else {
    for (int e = tid; e < BK * BN; e += NT) {
      const int k = e / BN, c = e % BN;
      const bool ok = k0 + k < K && col0 + c < N;
      Bs[k * G::LDB + c] = ok ? B[(int64_t)(k0 + k) * ldb + col0 + c] : __float2bfloat16(0.f);
    }
  }
}

// a_vec / b_vec: the rows of A / B may be copied 16 bytes at a time (base
// pointer 16-byte aligned, leading dimension and K / N multiples of 8).
template <int BM, int BN>
__device__ void gemm_tile(const __nv_bfloat16* A, int64_t lda, int M, int row0,
                          const __nv_bfloat16* B, int64_t ldb, int N, int col0, int K,
                          bool a_vec, bool b_vec, unsigned char* smem, float* C) {
  using G = Bf16Tile<BM, BN>;
  constexpr int BK = G::BK;
  constexpr int ST = G::STAGES;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [ST][BM][LDA]
  __nv_bfloat16* Bs = As + ST * G::A_ELEMS;                    // [ST][BK][LDB]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;

  float acc[G::FM][G::FN][4];
#pragma unroll
  for (int i = 0; i < G::FM; ++i)
#pragma unroll
    for (int j = 0; j < G::FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + BK - 1) / BK;
  // one commit group per k tile (empty past the end), so "all but the
  // newest ST - 2 groups complete" means tile kt has landed
  for (int t = 0; t < ST - 1; ++t) {
    if (t < nk)
      load_stage_bf16<BM, BN>(As + t * G::A_ELEMS, Bs + t * G::B_ELEMS, A, lda, M, row0, B,
                              ldb, N, col0, K, t * BK, a_vec, b_vec);
    cp_async_commit();
  }
  // ldmatrix row addresses of this lane: A rows lane % 16 at k offset
  // (lane / 16) * 8; B (transposed load) k rows lane % 8 + 8 * ((lane / 8) % 2)
  // at n offset (lane / 16) * 8
  const int a_row = wm * G::WM + lane % 16, a_col = (lane / 16) * 8;
  const int b_row = lane % 8 + 8 * ((lane / 8) % 2), b_col = wn * G::WN + (lane / 16) * 8;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % ST;
    cp_async_wait<(ST >= 2 ? ST - 2 : 0)>();
    __syncthreads();  // tile kt visible to all; everyone is done with tile kt - 1
    const int pf = kt + ST - 1;  // refill the stage tile kt - 1 used
    if (pf < nk)
      load_stage_bf16<BM, BN>(As + (pf % ST) * G::A_ELEMS, Bs + (pf % ST) * G::B_ELEMS, A,
                              lda, M, row0, B, ldb, N, col0, K, pf * BK, a_vec, b_vec);
    cp_async_commit();
    const __nv_bfloat16* as = As + s * G::A_ELEMS;
    const __nv_bfloat16* bs = Bs + s * G::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[G::FM][4];
#pragma unroll
      for (int i = 0; i < G::FM; ++i)
        ldmatrix_x4(a[i], as + (a_row + i * 16) * G::LDA + kk + a_col);
#pragma unroll
      for (int j = 0; j < G::FN; j += 2) {
        unsigned b[4];  // n8 blocks j and j + 1, k 0-7 and 8-15 each
        ldmatrix_x4_trans(b, bs + (kk + b_row) * G::LDB + b_col + j * 8);
#pragma unroll
        for (int i = 0; i < G::FM; ++i) {
          mma_bf16(acc[i][j], a[i], b[0], b[1]);
          mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the C tile below reuses the stages
  constexpr int LDC = Tile<BM, BN>::LDC;
#pragma unroll
  for (int i = 0; i < G::FM; ++i)
#pragma unroll
    for (int j = 0; j < G::FN; ++j) {
      const int r = wm * G::WM + i * 16 + lane / 4;
      const int c = wn * G::WN + j * 8 + (lane % 4) * 2;
      *reinterpret_cast<float2*>(C + r * LDC + c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(C + (r + 8) * LDC + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
}

template <int BM, int BN>
__device__ void gemm_tile(const float* A, int64_t lda, int M, int row0, const float* B,
                          int64_t ldb, int N, int col0, int K, bool, bool,
                          unsigned char* smem, float* C) {
  using G = F32Tile<BM, BN>;
  constexpr int BK = G::BK;
  float* As = reinterpret_cast<float*>(smem);  // [BK][BM + 1], transposed
  float* Bs = As + BK * G::LDA;                // [BK][BN]
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[G::RM][G::RN];
#pragma unroll
  for (int i = 0; i < G::RM; ++i)
#pragma unroll
    for (int j = 0; j < G::RN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, k = e % BK;
      const bool ok = row0 + r < M && k0 + k < K;
      As[k * G::LDA + r] = ok ? A[(int64_t)(row0 + r) * lda + k0 + k] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int k = e / BN, c = e % BN;
      const bool ok = k0 + k < K && col0 + c < N;
      Bs[k * BN + c] = ok ? B[(int64_t)(k0 + k) * ldb + col0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[G::RM], b[G::RN];
#pragma unroll
      for (int i = 0; i < G::RM; ++i) a[i] = As[k * G::LDA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < G::RN; ++j) b[j] = Bs[k * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < G::RM; ++i)
#pragma unroll
        for (int j = 0; j < G::RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  constexpr int LDC = Tile<BM, BN>::LDC;
#pragma unroll
  for (int i = 0; i < G::RM; ++i)
#pragma unroll
    for (int j = 0; j < G::RN; ++j) C[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  __syncthreads();
}

inline bool vec16(const void* p, int64_t ld, int inner) {
  return ((uintptr_t)p % 16 == 0) && ld % 8 == 0 && inner % 8 == 0;
}

}  // namespace tile_gemm
