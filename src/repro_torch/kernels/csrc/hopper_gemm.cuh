// The Hopper (sm_90a) bf16 mainloop shared by the port's fused product
// kernels, `fused_qkv_rope_commit.cu` (K3) and `verify_stats.cu` (K2).
//
// C [BM, N] += A [BM, K] @ B [K, N] with A row-major (K contiguous: the
// activations) and B either row-major (N contiguous: the weights as the
// model stores them, [d, cols]) or, with KMB, K-major (B^T [N, K]
// row-major: a tied model's embedding table [V, d] read in place as its
// own transpose), bf16 in, f32 sums in registers:
//   - wgmma.mma_async m64nNk16 (N 64, 128 or 256), A and B both read from
//     shared memory through descriptors; B is N-major (the transposed
//     operand) or, with KMB, K-major like A;
//   - operands in 128-byte-swizzled shared memory, one stage of depth
//     BK = 64 (one 128-byte row of A, 64 rows of B, or with KMB one
//     128-byte row per B column) per ring slot;
//   - a ring of ST stages filled by TMA (cp.async.bulk.tensor.2d with
//     mbarrier completion) from one thread of a producer warpgroup; A is
//     one box {64, BM}, B one box {64, 64} per 64 columns (with KMB the
//     box is 64 columns of B^T's rows by 64 deep, the same 8 KB);
//   - one or two consumer warpgroups, each owning MB x 64 rows of the tile;
//     a stage is released (its `empty` barrier) once the wgmma group that
//     read it has retired, so one group stays in flight behind the next;
//   - optionally, SH blocks of a thread-block cluster that need the same A
//     tile (and different B tiles) share it: each loads 1 / SH of its rows
//     and multicasts them to all SH, so A leaves L2 once per SH blocks;
//     each block's stage is then released to all SH producers;
//   - setmaxnreg moves registers from the producer to the consumers in the
//     384-thread (two-consumer) kernels.
// Rows past M, columns past N and depth past K come in as zeros from the
// TMA unit's out-of-bounds fill, so they add exact zeros.
// The sum over K runs in the same order for every element of the tile,
// whatever its row or column, so equal columns of B give bitwise equal
// columns of C; nothing in it depends on timing.
//
// The host side encodes tensor maps with cuTensorMapEncodeTiled (the
// library links libcuda).  A weight's map is encoded once and cached,
// keyed by pointer, shape, row stride and box; `encodings()` counts the
// encodings, so a run can show they happen once per weight tensor.
// Activations change pointer every call; their maps are encoded per launch
// (a host-only call) and are not cached.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <mutex>
#include <unordered_map>

namespace hopper {

constexpr int BK = 64;                 // depth of one stage: one 128-byte swizzle row
constexpr int WG_THREADS = 128;        // threads per warpgroup
constexpr int A_ROW_BYTES = BK * 2;    // 128
constexpr int B_CHUNK_BYTES = BK * 64 * 2;  // 64 rows of 64 columns: 8 KB

// --------------------------------------------------------------------------
// device helpers
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_u32(bar))
      : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one 2-d TMA box into shared memory; completion counted on `bar` in bytes
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the same box into the same offset of every block of the cluster in
// `mask`; each destination block's barrier at `bar`'s offset counts the bytes
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

// arrive on the barrier at `bar`'s offset in cluster block `rank`
__device__ __forceinline__ void mbar_arrive_rank(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 a;\n"
      "mapa.shared::cluster.u32 a, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [a];\n}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; lbo / sbo in bytes.
// K-major (A): sbo = 1024 (8 rows of 128 bytes), lbo unused.  N-major (B):
// lbo = the stride between 64-column chunks, sbo = 1024 (8 rows of K).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[0:32] += A (64 x 16, K-major) * B (16 x 64), bf16 in, f32 sum; TB 1:
// B N-major (transposed), TB 0: B K-major
template <int TB = 1>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// d[0:64] += A (64 x 16, K-major) * B (16 x 128), bf16 in, f32 sum; TB as above
template <int TB = 1>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// d[0:128] += A (64 x 16, K-major) * B (16 x 256), bf16 in, f32 sum; TB as
// above
template <int TB = 1>
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}


template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// named barrier `id` (1..15) over `n` threads
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster: arrive (release), then wait
// (acquire); a launch without a cluster is a cluster of one block
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// the address of `addr` (this block's shared memory) in block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// --------------------------------------------------------------------------
// the ring: ST stages of A_BYTES (A: rows x 128 bytes) + B_BYTES (B: N / 64
// chunks of 64 rows x 128 bytes), 1024-byte aligned, then 2 ST barriers
// --------------------------------------------------------------------------

template <int BM_, int N_, int ST_>
struct Ring {
  static constexpr int BM = BM_, N = N_, ST = ST_;
  static constexpr int A_BYTES = BM * A_ROW_BYTES;
  static constexpr int B_BYTES = (N / 64) * B_CHUNK_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BYTES = ST * STAGE_BYTES;
  static_assert(N % 64 == 0 && BM % 64 == 0, "ring tile shape");
  static_assert(A_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0, "1024-byte alignment");
};

// 1024-byte aligned start of the dynamic shared memory (allocate 1024 more)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// Producer: fill ring stages for k tiles [kt0, kt1) of A rows a_row0 and B
// columns b_col0 (N / 64 boxes).  `it` counts stages across calls.  One
// thread calls this.  SH > 1: the SH blocks of the cluster in `mask` share
// the A tile (their B tiles differ); this block loads A slice `slice`
// (rows [slice BM / SH, (slice + 1) BM / SH)) and multicasts it to all of
// them, so each A byte leaves L2 once per SH blocks.  A's map then has
// boxes of BM / SH rows.
//
// KMB: B is K-major (its map is over B^T [N, K]); the box for columns
// [b_col0 + 64 c, + 64) is then 64 rows of B^T by 64 deep.
template <class RG, int SH = 1, bool KMB = false>
__device__ __forceinline__ void produce(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                        uint32_t& it, const CUtensorMap* a_map, int a_row0,
                                        const CUtensorMap* b_map, int b_col0, int kt0, int kt1,
                                        int slice = 0, uint16_t mask = 1) {
  static_assert(RG::BM % (64 * SH) == 0, "A slices of whole swizzle atoms");
  for (int kt = kt0; kt < kt1; ++kt, ++it) {
    const int s = it % RG::ST;
    mbar_wait(&empty[s], ((it / RG::ST) & 1) ^ 1);
    unsigned char* st = ring + s * RG::STAGE_BYTES;
    mbar_expect_tx(&full[s], RG::STAGE_BYTES);
    if constexpr (SH == 1) {
      tma_load_2d(st, a_map, &full[s], kt * BK, a_row0);
    } else {
      tma_load_2d_multicast(st + slice * (RG::A_BYTES / SH), a_map, &full[s], kt * BK,
                            a_row0 + slice * (RG::BM / SH), mask);
    }
#pragma unroll
    for (int c = 0; c < RG::N / 64; ++c) {
      if constexpr (KMB)
        tma_load_2d(st + RG::A_BYTES + c * B_CHUNK_BYTES, b_map, &full[s], kt * BK,
                    b_col0 + 64 * c);
      else
        tma_load_2d(st + RG::A_BYTES + c * B_CHUNK_BYTES, b_map, &full[s], b_col0 + 64 * c,
                    kt * BK);
    }
  }
}

// Release a stage once the wgmma group that read it has retired.  SH == 1:
// every consumer thread arrives on this block's `empty` barrier (count: the
// consumer threads).  SH > 1: lane 0 of each consumer warp arrives on the
// barrier of every block in `mask`, whose producers all write into this
// block's stage (count: SH x the consumer warps).
template <int SH>
__device__ __forceinline__ void release(uint64_t* bar, uint16_t mask) {
  if constexpr (SH == 1) {
    mbar_arrive(bar);
  } else {
    __syncwarp();
    if (threadIdx.x % 32 == 0)
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if ((mask >> r) & 1) mbar_arrive_rank(bar, (uint32_t)r);
  }
}

// Consumer: one warpgroup's acc[MB][N / 2] += (rows wg_row0 + 64 mb .. of
// the A tile) x B over nk stages; a stage is released (see `release`) once
// the group that read it has retired.  acc must be initialised by the
// caller.  KMB: B is K-major (see `produce`).
template <class RG, int MB, int SH = 1, bool KMB = false>
__device__ __forceinline__ void consume(float (&acc)[MB][RG::N / 2], unsigned char* ring,
                                        uint64_t* full, uint64_t* empty, uint32_t& it,
                                        int wg_row0, int nk, uint16_t mask = 1) {
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int s = it % RG::ST;
    mbar_wait(&full[s], (it / RG::ST) & 1);
    const uint32_t a = smem_u32(ring + s * RG::STAGE_BYTES) + wg_row0 * A_ROW_BYTES;
    const uint32_t b = smem_u32(ring + s * RG::STAGE_BYTES + RG::A_BYTES);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) fence_acc(acc[mb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // B N-major: 16 rows of K further on is 2 swizzle atoms (2 x 1024
      // bytes); B K-major: 16 bf16 further along each 128-byte row, as A
      const uint64_t db = KMB ? desc_sw128(b + kk * 32, 16, 1024)
                              : desc_sw128(b + kk * 2048, B_CHUNK_BYTES, 1024);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        // A: 16 bf16 further along the 128-byte row is 32 bytes
        const uint64_t da = desc_sw128(a + mb * 64 * A_ROW_BYTES + kk * 32, 16, 1024);
        wgmma_bf16<KMB ? 0 : 1>(acc[mb], da, db);
      }
    }
    wgmma_commit();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) fence_acc(acc[mb]);
    if (kt > 0) {
      wgmma_wait<1>();  // the previous stage's group has retired
      release<SH>(&empty[(it - 1) % RG::ST], mask);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) fence_acc(acc[mb]);
  if (nk > 0) release<SH>(&empty[(it - 1) % RG::ST], mask);
}

// `empty` barrier count for NC consumer warpgroups sharing A over SH blocks
__host__ __device__ constexpr int empty_count(int NC, int SH) { return SH == 1 ? NC * 128 : SH * NC * 4; }

// The accumulator fragment of m64nNk16: thread t of the warpgroup holds,
// for n8 block j, rows r = 16 (t / 32) + (t % 32) / 4 and r + 8, columns
// 8 j + 2 (t % 4) and + 1: d[4j + 0..1] on row r, d[4j + 2..3] on row r + 8.
__device__ __forceinline__ int frag_row(int t) { return 16 * (t / 32) + (t % 32) / 4; }
__device__ __forceinline__ int frag_col(int t) { return 2 * (t % 4); }

}  // namespace hopper

// --------------------------------------------------------------------------
// host side: tensor maps, and the shared-memory limit per device
// --------------------------------------------------------------------------

// Each library that includes this header gets its own map cache and count
// (an unnamed namespace: inline functions' statics would otherwise be one
// object across every library loaded into the process).
namespace hopper_host {
namespace {

// Map of a row-major bf16 matrix [outer, inner] (row stride `row_bytes`),
// boxes of {box_inner, box_outer} elements, 128-byte swizzle, zero fill
// out of bounds.  Returns 0 or 1000 + the CUresult.
inline int encode_map(CUtensorMap* m, const void* ptr, uint64_t inner, uint64_t outer,
                      uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

struct MapKey {
  const void* ptr;
  uint64_t inner, outer, row_bytes;
  uint32_t box_inner, box_outer;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && inner == o.inner && outer == o.outer && row_bytes == o.row_bytes &&
           box_inner == o.box_inner && box_outer == o.box_outer;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = (uint64_t)(uintptr_t)k.ptr;
    for (uint64_t v : {k.inner, k.outer, k.row_bytes, (uint64_t)k.box_inner,
                       ((uint64_t)k.box_outer << 32)})
      h = (h ^ v) * 0x100000001b3ull;
    return (size_t)h;
  }
};

inline std::mutex& cache_mutex() {
  static std::mutex m;
  return m;
}
inline std::unordered_map<MapKey, CUtensorMap, MapKeyHash>& map_cache() {
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> c;
  return c;
}
inline long long& encodings() {
  static long long n = 0;
  return n;
}

// A weight's map, encoded on first use and cached: the same pointer, shape,
// stride and box always give the same map, so a hit is exact.
inline int weight_map(CUtensorMap* m, const void* ptr, uint64_t inner, uint64_t outer,
                      uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer) {
  const MapKey key{ptr, inner, outer, row_bytes, box_inner, box_outer};
  std::lock_guard<std::mutex> lock(cache_mutex());
  auto& cache = map_cache();
  auto hit = cache.find(key);
  if (hit != cache.end()) {
    std::memcpy(m, &hit->second, sizeof(CUtensorMap));
    return 0;
  }
  const int err = encode_map(m, ptr, inner, outer, row_bytes, box_inner, box_outer);
  if (err) return err;
  ++encodings();
  cache.emplace(key, *m);
  return 0;
}

constexpr int kMaxDevices = 64;

// Raise one kernel instance's dynamic shared-memory limit to `bytes`, once
// per device: `done` is that instance's flags (a static of its launcher), so
// a process that drives several cards sets it on each.  Returns 0 or the
// CUDA error.
template <typename K>
inline int allow_smem(K kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  return 0;
}

}  // namespace
}  // namespace hopper_host
