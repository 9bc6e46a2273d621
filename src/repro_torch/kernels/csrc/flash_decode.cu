// Flash-decoding attention of folded tree queries over a KV cache with
// per-row lengths, for Hopper (sm_90a).
//
// Replaces repro/kernels/tree_attention.py::flash_decode, all of its
// variants: the dense fp/bf16 body `_kernel`, its int8 branch
// (`quantized=True`: int8 rows times their [BS, 1] f32 scale column) and
// the paged body `_kernel_paged` (the block table read by the index map).
// It emits the same partial-softmax statistics in f32:
//   acc[b,h,r,:] = sum_{s < len_b} p(r,s) * v[b,s,h,:]
//   m[b,h,r]     = max_{s < len_b} q[b,h,r,:] . k[b,s,h,:]
//   l[b,h,r]     = sum_{s < len_b} exp(score - m)
// with m = -1e30, l = 0, acc = 0 for a row of length 0.  The tree block and
// the exact merge stay in repro_torch/kernels/ops.py.
//
// Bound.  At the spec step (B 4, Hkv 8, R 256 folded rows, D 128, ~260
// cache rows a slot) the work is ~1.1 GFLOP over ~10.5 MB (q, the swept
// K/V rows, the f32 statistics): ~100 operations a byte, a third of the
// H100's bf16 operations-per-byte line, so the bytes bound it and
// mma.sync's share of the tensor cores is enough; wgmma would not move
// the bound.  At the AR step (R 8) it is 4 MB of K/V and no arithmetic to
// speak of: the bound is latency and how many SMs stream at once.
//
// Design.
// * Grid.  A block owns (b, kv head, a tile of BR query rows, a split of
//   the cache columns); a split is a whole number of BS = 64-column tiles,
//   so dense and paged sum tile for tile in the same order and paged stays
//   bitwise equal to dense.  The split length comes from the host's plan
//   (repro_torch/kernels/tree_attention.py::decode_plan), which sees only
//   the shapes and never reads `lengths`: R 256 keeps one split (64-row
//   tiles: 128 blocks, each streaming its rows once), R 8 takes 64-column
//   splits (one block per live tile instead of 32 blocks).  A block whose
//   split starts at or past lengths[b] exits at once; when the grid has
//   one split it first writes the empty statistics (a slot of length 0).
// * Merge.  With more than one split, blocks leave f32 partials and a
//   second small kernel combines the splits that start below lengths[b] in
//   split order (m = max m_i; acc, l = sums of acc_i, l_i times
//   exp(m_i - m)), so the result never depends on which block finished
//   first.  A single live split passes through bit for bit (exp(0) = 1).
// * Loads.  Q once per block and every K/V tile with 16-byte cp.async
//   copies, into a ring of 2 or 3 stages, so the next tile streams while
//   this one computes; rows past the length are zero-filled and never
//   read.  A paged block first copies its columns' block-table entries into
//   shared memory, then each row is a 16-byte copy from its pool row.
// * bf16 q on a bf16 cache (the main path): tensor cores.  Each warp owns
//   16 query rows and a column group of every tile (see MmaCfg); QK^T is
//   mma.sync m16n8k16 bf16 with f32 sums from ldmatrix'ed, XOR-swizzled
//   tiles, the online softmax runs in registers (exp as 2^(x log2 e) on
//   the special-function unit), and p is rounded to bf16 into the A
//   fragments of PV (the TPU kernel's `p.astype(v.dtype)`), V through
//   ldmatrix.trans.  The column groups' states are merged in group order
//   at the end, through shared memory.
// * bf16 q on an int8 cache: an int8 value is exact in bf16, so the tile
//   is widened to bf16 in shared memory and QK^T is (q . k_int8) * k_scale
//   on the tensor cores.  The reference does not round p here (its
//   dequantized v is f32), so PV is a two-term bf16 split: p' = p *
//   v_scale[s] as hi = bf16(p') plus lo = bf16(p' - hi), each times v_int8
//   with f32 sums, which carries p' to ~2^-16 relative.
// * f32 q (f32 cache, or int8 dequantized to f32 by one product with the
//   scale): CUDA-core FMAs, no TF32, in the reference's f32 numerics; the
//   same grid, merge and asynchronous loads.
// The cache keeps the port's [B, S, Hkv, D] (or pool) layout and is read
// through its strides, so no transposed copy is made.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tile_gemm.cuh"

namespace {

using tile_gemm::cp_async16;
using tile_gemm::cp_async_commit;
using tile_gemm::cp_async_wait;
using tile_gemm::ldmatrix_x4;
using tile_gemm::ldmatrix_x4_trans;
using tile_gemm::mma_bf16;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int BS = 64;              // cache columns per tile
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may ask for
constexpr int kRingBudget = 160 * 1024;  // 3 stages if they fit in this, else 2
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;  // 0 bytes read: zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// four int8 (one word, byte 0 first) as four bf16 (two words), exactly:
// byte x, flipped to u = x + 128, is placed in the low byte of the f32
// 2^23 (0x4B000000), which gives 2^23 + u; subtracting 2^23 + 128 leaves
// x, and |x| <= 128 packs into bf16 without rounding
__device__ __forceinline__ uint2 widen4(unsigned w) {
  const unsigned u = w ^ 0x80808080u;
  const float x0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float x1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float x2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float x3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  return make_uint2(pack_bf16(x0, x1), pack_bf16(x2, x3));
}

// 2^x on the special-function unit (ex2.approx.ftz, ~2 ulp); the
// tensor-core route's softmax takes exp(y) as 2^(y log2 e)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// byte offset of 16-byte chunk c of row r in a bf16 tile of cpr chunks a
// row, XOR-swizzled over 8 rows so that ldmatrix's 8 row reads of one
// chunk column fall in 8 different bank groups (cpr is a multiple of 8)
__device__ __forceinline__ int swz(int r, int c, int cpr) {
  return (r * cpr + (c ^ (r & 7))) * 16;
}

// Where the cache lives: element strides (b, s, h) of the values and of the
// scales; for a paged pool `table` is [B, mb] int32, s is the flat pool row
// (block * ps + offset) and the b strides are unused.
struct Cache {
  const int* table;
  int ps, mb, ps_shift;  // ps_shift: log2(ps) for a power of two, else -1
  int64_t k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t ks_sb, ks_ss, ks_sh, vs_sb, vs_ss, vs_sh;
};

// The launch's geometry, from the host's plan.
struct Grid {
  int B, Hkv, R, S;
  int row_tiles;   // ceil(R / BR)
  int split_cols;  // cache columns per split, a multiple of BS
  int n_splits;
};

// The block's share: kv head h of slot b, query rows from r0, cache
// columns [c0, c1) (c1 clipped to the slot's length); `out` is the first
// statistics row of (split, b, h) in the outputs.
struct Span {
  int b, h, r0, c0, c1, first_page;
  int64_t out;
};

__device__ __forceinline__ Span block_span(const Grid& g, const Cache& ca, const int* lengths,
                                           int br, bool paged) {
  Span sp;
  const int split = blockIdx.x / g.row_tiles;
  sp.r0 = (blockIdx.x % g.row_tiles) * br;
  sp.h = blockIdx.y;
  sp.b = blockIdx.z;
  int n = lengths[sp.b];
  n = n < 0 ? 0 : (n > g.S ? g.S : n);
  sp.c0 = split * g.split_cols;
  sp.c1 = n < sp.c0 + g.split_cols ? n : sp.c0 + g.split_cols;
  sp.first_page = paged ? sp.c0 / ca.ps : 0;
  sp.out = (((int64_t)split * g.B + sp.b) * g.Hkv + sp.h) * g.R;
  return sp;
}

// m = -1e30, l = 0, acc = 0 for the block's rows
__device__ __forceinline__ void write_empty(float* acc, float* m, float* l, const Span& sp, int br, int R,
                            int D, int tid, int nt) {
  const int nr = R - sp.r0 < br ? R - sp.r0 : br;
  float* a = acc + (sp.out + sp.r0) * D;
  for (int i = tid; i < nr * D; i += nt) a[i] = 0.f;
  for (int i = tid; i < nr; i += nt) {
    m[sp.out + sp.r0 + i] = kNegInf;
    l[sp.out + sp.r0 + i] = 0.f;
  }
}

// A paged block's block-table entries for its columns, into shared memory
// (entries of rows at or past the length are not read)
__device__ __forceinline__ void load_pages(int* pg, const Cache& ca, const Span& sp, int tid,
                                           int nt) {
  const int last = (sp.c1 - 1) / ca.ps;
  const int* tb = ca.table + (int64_t)sp.b * ca.mb;
  for (int i = tid; i <= last - sp.first_page; i += nt) pg[i] = tb[sp.first_page + i];
}

// cache row of logical column s: the slot's row, or its pool row
template <bool PAGED>
__device__ __forceinline__ int64_t cache_row(const int* pg, const Cache& ca, int first_page,
                                             int s) {
  if constexpr (PAGED) {
    if (ca.ps_shift >= 0)
      return ((int64_t)pg[(s >> ca.ps_shift) - first_page] << ca.ps_shift) + (s & (ca.ps - 1));
    return (int64_t)pg[s / ca.ps - first_page] * ca.ps + s % ca.ps;
  } else {
    return s;
  }
}

// Issue the cp.async copies of tile `tile` (columns tile*BS ...) of K and
// V into kt / vt, rows of RB bytes (SWZ: bf16 rows swizzled by swz), and
// under QUANT its k and v scales into sc[0:BS] and sc[BS:2BS].  Rows at
// or past c1 are zero-filled.
template <typename C, bool PAGED, bool QUANT, bool SWZ, int D, int RB, int NT>
__device__ __forceinline__ void issue_tile(unsigned char* kt, unsigned char* vt, float* sc,
                                           int tile, const C* kb, const C* vb,
                                           const float* ksb, const float* vsb, const int* pg,
                                           const Cache& ca, const Span& sp, int tid) {
  constexpr int EPC = 16 / (int)sizeof(C);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;              // chunks per row
  static_assert(NT % CPR == 0 && BS % (NT / CPR) == 0, "chunk mapping");
  const int tc0 = tile * BS;
  const int c = tid % CPR;
#pragma unroll
  for (int i = 0; i < BS / (NT / CPR); ++i) {
    const int r = tid / CPR + i * (NT / CPR);
    const int s = tc0 + r;
    const bool ok = s < sp.c1;
    const int64_t row = ok ? cache_row<PAGED>(pg, ca, sp.first_page, s) : 0;
    const int off = SWZ ? swz(r, c, CPR) : r * RB + c * 16;
    cp_async16(kt + off, kb + row * ca.k_ss + c * EPC, ok);
    cp_async16(vt + off, vb + row * ca.v_ss + c * EPC, ok);
  }
  if constexpr (QUANT) {
    static_assert(NT >= BS, "one scale row a thread");
    if (tid < BS) {
      const int r = tid;
      const int s = tc0 + r;
      const bool ok = s < sp.c1;
      const int64_t row = ok ? cache_row<PAGED>(pg, ca, sp.first_page, s) : 0;
      cp_async4(sc + r, ksb + row * ca.ks_ss, ok);
      cp_async4(sc + BS + r, vsb + row * ca.vs_ss, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 q: tensor cores (fp bf16 cache, or int8 widened to bf16)
// ---------------------------------------------------------------------------

// A block of WR x WC warps: warp (wr, wc) owns query rows 16 wr .. and
// the wc-th of WC column groups of every tile (64 / WC columns), with its
// own online softmax; the column groups' states are merged in group order
// at the end.  R > 16 (the spec step): 4 x 2 warps, 64 rows; R <= 16 (the
// AR step): 1 x 4 warps, 16 rows.  Splitting the columns of a tile over
// warps halves (quarters) each warp's serial chain of products and puts
// 2 (4) warps on every row tile, which the latency of mma.sync needs.
template <bool QUANT, int D, int WR>
struct MmaCfg {
  static constexpr int WC = WR == 1 ? 4 : 2;
  static constexpr int NT = 32 * WR * WC, BR = 16 * WR;
  static constexpr int CW = BS / WC;   // tile columns a warp
  static constexpr int NB = CW / 8;    // n-blocks of 8 columns a warp
  static constexpr int CPR = D / 8;    // 16-byte chunks in a bf16 row
  static constexpr int Q_BYTES = BR * D * 2;
  static constexpr int TILE_BYTES = BS * D * (QUANT ? 1 : 2);  // a K or V tile as stored
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + (QUANT ? 2 * BS * 4 : 0);
  static constexpr int WIDE_BYTES = QUANT ? 2 * BS * D * 2 : 0;  // int8 K, V widened
  static constexpr int FIXED = Q_BYTES + WIDE_BYTES;
  static constexpr int STAGES = FIXED + 3 * STAGE_BYTES <= kRingBudget ? 3 : 2;
  static constexpr int SMEM = FIXED + STAGES * STAGE_BYTES;  // + the page list
  // the states of column groups 1 .. WC-1 (acc, m, l), in the ring at the end
  static constexpr int MERGE_BYTES = (WC - 1) * BR * (D + 2) * 4;
  static_assert(SMEM <= 200 * 1024, "shared memory");
  static_assert(MERGE_BYTES <= STAGES * STAGE_BYTES, "merge buffer");
};

template <bool QUANT, bool PAGED, int D, int WR>
__global__ void __launch_bounds__(MmaCfg<QUANT, D, WR>::NT, 1) decode_mma(
    const bf16* __restrict__ q, const void* __restrict__ kp, const void* __restrict__ vp,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ lengths, float* __restrict__ acc_out, float* __restrict__ m_out,
    float* __restrict__ l_out, Grid g, Cache ca) {
  using Cfg = MmaCfg<QUANT, D, WR>;
  using C = std::conditional_t<QUANT, int8_t, bf16>;
  constexpr int NT = Cfg::NT, BR = Cfg::BR, CPR = Cfg::CPR, ST = Cfg::STAGES;
  constexpr int WC = Cfg::WC, CW = Cfg::CW, NB = Cfg::NB;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;                      // [BR][D] bf16, swizzled
  unsigned char* wide = qs + Cfg::Q_BYTES;       // QUANT: K, V widened to bf16
  unsigned char* ring = wide + Cfg::WIDE_BYTES;  // ST stages of K, V (+ scales)
  int* pg = reinterpret_cast<int*>(ring + ST * Cfg::STAGE_BYTES);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp % WR, wc = warp / WR;
  const Span sp = block_span(g, ca, lengths, BR, PAGED);
  if (sp.c0 >= sp.c1) {
    if (g.n_splits == 1) write_empty(acc_out, m_out, l_out, sp, BR, g.R, D, tid, NT);
    return;
  }
  const bf16* qb = q + ((int64_t)sp.b * g.Hkv + sp.h) * g.R * D;
  static_assert(BR * CPR % NT == 0, "q chunks");
#pragma unroll
  for (int j = 0; j < BR * CPR / NT; ++j) {
    const int i = tid + j * NT;
    const int r = i / CPR, c = i % CPR;
    const bool ok = sp.r0 + r < g.R;
    cp_async16(qs + swz(r, c, CPR), qb + (int64_t)(ok ? sp.r0 + r : 0) * D + c * 8, ok);
  }
  if constexpr (PAGED) load_pages(pg, ca, sp, tid, NT);
  __syncthreads();  // the page list

  const C* kb = (const C*)kp + (PAGED ? 0 : (int64_t)sp.b * ca.k_sb) + (int64_t)sp.h * ca.k_sh;
  const C* vb = (const C*)vp + (PAGED ? 0 : (int64_t)sp.b * ca.v_sb) + (int64_t)sp.h * ca.v_sh;
  const float* ksb = nullptr;
  const float* vsb = nullptr;
  if constexpr (QUANT) {
    ksb = k_scale + (PAGED ? 0 : (int64_t)sp.b * ca.ks_sb) + (int64_t)sp.h * ca.ks_sh;
    vsb = v_scale + (PAGED ? 0 : (int64_t)sp.b * ca.vs_sb) + (int64_t)sp.h * ca.vs_sh;
  }
  auto issue = [&](int tile, int stage) {
    unsigned char* kt = ring + stage * Cfg::STAGE_BYTES;
    issue_tile<C, PAGED, QUANT, !QUANT, D, D * (int)sizeof(C), NT>(
        kt, kt + Cfg::TILE_BYTES, reinterpret_cast<float*>(kt + 2 * Cfg::TILE_BYTES), tile, kb,
        vb, ksb, vsb, pg, ca, sp, tid);
  };
  const int t_begin = sp.c0 / BS, t_end = (sp.c1 + BS - 1) / BS;
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (t_begin + i < t_end) issue(t_begin + i, i);
    cp_async_commit();  // the first group also holds Q
  }

  const int g8 = lane >> 2, t4 = lane & 3, mi = lane >> 3, l7 = lane & 7;
  const bool live = sp.r0 + wr * 16 < g.R;  // the warp has rows below R
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows g8 and g8 + 8
  // the warp's q as A fragments, held in registers from the first tile on
  // (reloaded from shared memory at D 256, where they would take 64
  // registers, and under int8, whose two PV terms leave no room for them)
  constexpr bool QREG = D <= 128 && !QUANT;
  unsigned qa[QREG ? D / 16 : 1][4];

  for (int t = t_begin; t < t_end; ++t) {
    const int it = t - t_begin;
    if (t + ST - 1 < t_end) issue(t + ST - 1, (it + ST - 1) % ST);
    cp_async_commit();
    cp_async_wait<ST - 1>();
    __syncthreads();
    if (QREG && it == 0) {
#pragma unroll
      for (int kk = 0; kk < (QREG ? D / 16 : 0); ++kk)
        ldmatrix_x4(qa[kk], qs + swz(wr * 16 + l7 + (mi & 1) * 8, 2 * kk + (mi >> 1), CPR));
    }
    unsigned char* kt = ring + (it % ST) * Cfg::STAGE_BYTES;
    const float* sc = reinterpret_cast<const float*>(kt + 2 * Cfg::TILE_BYTES);
    const unsigned char* ks = kt;
    const unsigned char* vs = kt + Cfg::TILE_BYTES;
    if constexpr (QUANT) {
      // widen the int8 tile to bf16 (exact), swizzled as a bf16 tile
      constexpr int C16 = D / 16;  // 16-value int8 chunks a row
      static_assert(2 * BS * C16 % NT == 0, "int8 chunks");
#pragma unroll
      for (int k = 0; k < 2 * BS * C16 / NT; ++k) {
        const int i = tid + k * NT;
        const int which = i / (BS * C16), j = i % (BS * C16);
        const int r = j / C16, c = j % C16;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(kt + which * Cfg::TILE_BYTES + r * D + c * 16);
        const uint2 a = widen4(raw.x), b = widen4(raw.y), e = widen4(raw.z),
                    f = widen4(raw.w);
        unsigned char* dst = wide + which * BS * D * 2;
        *reinterpret_cast<uint4*>(dst + swz(r, 2 * c, CPR)) = make_uint4(a.x, a.y, b.x, b.y);
        *reinterpret_cast<uint4*>(dst + swz(r, 2 * c + 1, CPR)) = make_uint4(e.x, e.y, f.x, f.y);
      }
      __syncthreads();
      ks = wide;
      vs = wide + BS * D * 2;
    }
    if (live) {
      // S = Q K^T over the warp's columns: 16 rows x CW, NB n-blocks of 8
      float s[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned a[4];
        if constexpr (QREG) {
          a[0] = qa[kk][0];
          a[1] = qa[kk][1];
          a[2] = qa[kk][2];
          a[3] = qa[kk][3];
        } else {
          ldmatrix_x4(a, qs + swz(wr * 16 + l7 + (mi & 1) * 8, 2 * kk + (mi >> 1), CPR));
        }
#pragma unroll
        for (int np = 0; np < NB / 2; ++np) {
          unsigned b[4];
          ldmatrix_x4(b, ks + swz(wc * CW + np * 16 + l7 + (mi >> 1) * 8, 2 * kk + (mi & 1),
                                  CPR));
          mma_bf16(s[2 * np], a, b[0], b[1]);
          mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
      }
      // online softmax in registers: this thread holds tile columns
      // wc CW + 8n + 2 t4 + {0, 1} of rows g8 (s[n][0..1]) and g8 + 8
      // (s[n][2..3]); a column group may have no valid column in the
      // ragged last tile, and then keeps its state
      const int nvalid = sp.c1 - t * BS;
      float x0 = kNegInf, x1 = kNegInf;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = wc * CW + n * 8 + 2 * t4 + (e & 1);
          float x = s[n][e];
          if constexpr (QUANT) x = __fmul_rn(x, sc[col]);
          x = col < nvalid ? x : kNegInf;
          s[n][e] = x;
          if (e < 2)
            x0 = fmaxf(x0, x);
          else
            x1 = fmaxf(x1, x);
        }
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
      const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
      const float a0 = exp2_approx((m0 - n0) * kLog2e), a1 = exp2_approx((m1 - n1) * kLog2e);
      m0 = n0;
      m1 = n1;
      float r0s = 0.f, r1s = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = wc * CW + n * 8 + 2 * t4 + (e & 1);
          const float p =
              col < nvalid ? exp2_approx((s[n][e] - (e < 2 ? n0 : n1)) * kLog2e) : 0.f;
          s[n][e] = p;
          if (e < 2)
            r0s += p;
          else
            r1s += p;
        }
      l0 = l0 * a0 + r0s;  // this thread's columns; the quad's sum at the end
      l1 = l1 * a1 + r1s;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= a0;
        o[n][1] *= a0;
        o[n][2] *= a1;
        o[n][3] *= a1;
      }
      // acc += P V, 16 of the warp's columns a step
#pragma unroll
      for (int j = 0; j < NB / 2; ++j) {
        unsigned pa[4], pb[4];
        if constexpr (!QUANT) {
          // p.astype(v.dtype): p rounded to bf16 as the A fragment
          pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
          pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
          pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
          pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
        } else {
          // p * v_scale[s] as hi + lo bf16 terms
          float hi[8], lo[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int n = 2 * j + (e >> 2), ee = e & 3;
            const float pv =
                __fmul_rn(s[n][ee], sc[BS + wc * CW + n * 8 + 2 * t4 + (ee & 1)]);
            hi[e] = __bfloat162float(__float2bfloat16(pv));
            lo[e] = pv - hi[e];
          }
          pa[0] = pack_bf16(hi[0], hi[1]);
          pa[1] = pack_bf16(hi[2], hi[3]);
          pa[2] = pack_bf16(hi[4], hi[5]);
          pa[3] = pack_bf16(hi[6], hi[7]);
          pb[0] = pack_bf16(lo[0], lo[1]);
          pb[1] = pack_bf16(lo[2], lo[3]);
          pb[2] = pack_bf16(lo[4], lo[5]);
          pb[3] = pack_bf16(lo[6], lo[7]);
        }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          unsigned b[4];
          ldmatrix_x4_trans(
              b, vs + swz(wc * CW + 16 * j + l7 + (mi & 1) * 8, 2 * dp + (mi >> 1), CPR));
          mma_bf16(o[2 * dp], pa, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
          if constexpr (QUANT) {
            mma_bf16(o[2 * dp], pb, b[0], b[1]);
            mma_bf16(o[2 * dp + 1], pb, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // the stage (and the widened tile) is free again
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int ra = wr * 16 + g8, rb = ra + 8;  // rows of the block
  // column groups 1 .. WC-1 hand their states to group 0 through the ring
  // (only empty copy groups can still be pending)
  cp_async_wait<0>();
  float* xo = reinterpret_cast<float*>(ring);   // [WC-1][BR][D]
  float* xm = xo + (WC - 1) * BR * D;           // [WC-1][BR]
  float* xl = xm + (WC - 1) * BR;               // [WC-1][BR]
  if (wc > 0 && live) {
    float* dst = xo + (wc - 1) * BR * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dst + ra * D + n * 8) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(dst + rb * D + n * 8) = make_float2(o[n][2], o[n][3]);
    }
    if (t4 == 0) {
      xm[(wc - 1) * BR + ra] = m0;
      xm[(wc - 1) * BR + rb] = m1;
      xl[(wc - 1) * BR + ra] = l0;
      xl[(wc - 1) * BR + rb] = l1;
    }
  }
  __syncthreads();
  if (wc > 0 || !live) return;
  // merge in group order: m = max m_i, acc and l rescaled by exp(m_i - m)
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < WC - 1; ++i) {
    mx0 = fmaxf(mx0, xm[i * BR + ra]);
    mx1 = fmaxf(mx1, xm[i * BR + rb]);
  }
  float w0 = exp2_approx((m0 - mx0) * kLog2e), w1 = exp2_approx((m1 - mx1) * kLog2e);
  l0 *= w0;
  l1 *= w1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[n][0] *= w0;
    o[n][1] *= w0;
    o[n][2] *= w1;
    o[n][3] *= w1;
  }
#pragma unroll
  for (int i = 0; i < WC - 1; ++i) {
    w0 = exp2_approx((xm[i * BR + ra] - mx0) * kLog2e);
    w1 = exp2_approx((xm[i * BR + rb] - mx1) * kLog2e);
    l0 = fmaf(xl[i * BR + ra], w0, l0);
    l1 = fmaf(xl[i * BR + rb], w1, l1);
    const float* src = xo + i * BR * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float2 pa = *reinterpret_cast<const float2*>(src + ra * D + n * 8);
      const float2 pb = *reinterpret_cast<const float2*>(src + rb * D + n * 8);
      o[n][0] = fmaf(pa.x, w0, o[n][0]);
      o[n][1] = fmaf(pa.y, w0, o[n][1]);
      o[n][2] = fmaf(pb.x, w1, o[n][2]);
      o[n][3] = fmaf(pb.y, w1, o[n][3]);
    }
  }
  if (sp.r0 + ra < g.R) {
    float* dst = acc_out + (sp.out + sp.r0 + ra) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) = make_float2(o[n][0], o[n][1]);
    if (t4 == 0) {
      m_out[sp.out + sp.r0 + ra] = mx0;
      l_out[sp.out + sp.r0 + ra] = l0;
    }
  }
  if (sp.r0 + rb < g.R) {
    float* dst = acc_out + (sp.out + sp.r0 + rb) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) = make_float2(o[n][2], o[n][3]);
    if (t4 == 0) {
      m_out[sp.out + sp.r0 + rb] = mx1;
      l_out[sp.out + sp.r0 + rb] = l1;
    }
  }
}

// ---------------------------------------------------------------------------
// f32 q: CUDA-core FMAs (f32 cache, or int8 dequantized to f32)
// ---------------------------------------------------------------------------

template <bool QUANT, int D, int BR>
struct FmaCfg {
  static constexpr int NT = 128;
  static constexpr int DP = D + 1;                    // padded f32 q row
  static constexpr int RB = D * (QUANT ? 1 : 4) + 16;  // stored cache row, padded
  static constexpr int TILE_BYTES = BS * RB;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + (QUANT ? 2 * BS * 4 : 0);
  // qs [BR][DP], ps [BR][BS], m, l, alpha [BR]
  static constexpr int FIXED = (BR * DP + BR * BS + 3 * BR) * 4;
  static constexpr int STAGES = FIXED + 2 * STAGE_BYTES <= 200 * 1024 ? 2 : 1;
  static constexpr int SMEM = FIXED + STAGES * STAGE_BYTES;  // + the page list
  static constexpr int RS = BR / 8;          // score rows a thread (x 4 columns)
  static constexpr int DC = D < NT ? D : NT;  // threads across head_dim in PV
  static constexpr int RG = NT / DC;         // row groups
  static constexpr int CPT = D / DC;         // acc columns a thread
  static constexpr int RPT = BR / RG;        // acc rows a thread
  static_assert(FIXED % 16 == 0 && SMEM <= 200 * 1024, "shared memory");
};

template <bool QUANT, bool PAGED, int D, int BR>
__global__ void __launch_bounds__(128, 1) decode_fma(
    const float* __restrict__ q, const void* __restrict__ kp, const void* __restrict__ vp,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ lengths, float* __restrict__ acc_out, float* __restrict__ m_out,
    float* __restrict__ l_out, Grid g, Cache ca) {
  using Cfg = FmaCfg<QUANT, D, BR>;
  using C = std::conditional_t<QUANT, int8_t, float>;
  constexpr int NT = Cfg::NT, DP = Cfg::DP, RB = Cfg::RB, ST = Cfg::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [BR][DP] pre-scaled queries
  float* ps = qs + BR * DP;                    // [BR][BS] scores, then p
  float* m_s = ps + BR * BS;
  float* l_s = m_s + BR;
  float* a_s = l_s + BR;  // this tile's rescale factor per row
  unsigned char* ring = reinterpret_cast<unsigned char*>(a_s + BR);
  int* pg = reinterpret_cast<int*>(ring + ST * Cfg::STAGE_BYTES);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Span sp = block_span(g, ca, lengths, BR, PAGED);
  if (sp.c0 >= sp.c1) {
    if (g.n_splits == 1) write_empty(acc_out, m_out, l_out, sp, BR, g.R, D, tid, NT);
    return;
  }
  if constexpr (PAGED) load_pages(pg, ca, sp, tid, NT);
  // q rows with 16-byte loads
  const float* qb = q + (((int64_t)sp.b * g.Hkv + sp.h) * g.R + sp.r0) * D;
  static_assert(BR * D / 4 % NT == 0, "q vectors");
#pragma unroll
  for (int j = 0; j < BR * D / 4 / NT; ++j) {
    const int i = tid + j * NT;
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const float4 x = sp.r0 + r < g.R ? *reinterpret_cast<const float4*>(qb + (int64_t)r * D + c)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    float* dst = qs + r * DP + c;
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  }
  if (tid < BR) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();  // the page list

  const C* kb = (const C*)kp + (PAGED ? 0 : (int64_t)sp.b * ca.k_sb) + (int64_t)sp.h * ca.k_sh;
  const C* vb = (const C*)vp + (PAGED ? 0 : (int64_t)sp.b * ca.v_sb) + (int64_t)sp.h * ca.v_sh;
  const float* ksb = nullptr;
  const float* vsb = nullptr;
  if constexpr (QUANT) {
    ksb = k_scale + (PAGED ? 0 : (int64_t)sp.b * ca.ks_sb) + (int64_t)sp.h * ca.ks_sh;
    vsb = v_scale + (PAGED ? 0 : (int64_t)sp.b * ca.vs_sb) + (int64_t)sp.h * ca.vs_sh;
  }
  auto issue = [&](int tile, int stage) {
    unsigned char* kt = ring + stage * Cfg::STAGE_BYTES;
    issue_tile<C, PAGED, QUANT, false, D, RB, NT>(
        kt, kt + Cfg::TILE_BYTES, reinterpret_cast<float*>(kt + 2 * Cfg::TILE_BYTES), tile, kb,
        vb, ksb, vsb, pg, ca, sp, tid);
  };
  const int t_begin = sp.c0 / BS, t_end = (sp.c1 + BS - 1) / BS;
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (t_begin + i < t_end) issue(t_begin + i, i);
    cp_async_commit();
  }

  // accumulator ownership: rows rgrp + RG*i, columns dcol + DC*j
  const int dcol = tid % Cfg::DC, rgrp = tid / Cfg::DC;
  float acc[Cfg::RPT][Cfg::CPT];
#pragma unroll
  for (int i = 0; i < Cfg::RPT; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::CPT; ++j) acc[i][j] = 0.f;
  // score ownership: rows srow + 8*i, columns scol + 16*j
  const int srow = tid / 16, scol = tid % 16;

  for (int t = t_begin; t < t_end; ++t) {
    const int it = t - t_begin;
    if (t + ST - 1 < t_end) issue(t + ST - 1, (it + ST - 1) % ST);
    cp_async_commit();
    cp_async_wait<ST - 1>();
    __syncthreads();
    const unsigned char* kt = ring + (it % ST) * Cfg::STAGE_BYTES;
    const unsigned char* vt = kt + Cfg::TILE_BYTES;
    const float* sc = reinterpret_cast<const float*>(kt + 2 * Cfg::TILE_BYTES);
    // k and v in f32: the cache value, or int8 times its scale (one f32
    // product, as the reference dequantizes)
    auto kval = [&](int c, int d) {
      if constexpr (QUANT)
        return __fmul_rn((float)reinterpret_cast<const int8_t*>(kt + c * RB)[d], sc[c]);
      else
        return reinterpret_cast<const float*>(kt + c * RB)[d];
    };
    auto vval = [&](int c, int d) {
      if constexpr (QUANT)
        return __fmul_rn((float)reinterpret_cast<const int8_t*>(vt + c * RB)[d], sc[BS + c]);
      else
        return reinterpret_cast<const float*>(vt + c * RB)[d];
    };
    const int nvalid = sp.c1 - t * BS;

    float s[Cfg::RS][4];
#pragma unroll
    for (int i = 0; i < Cfg::RS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[Cfg::RS], kv[4];
#pragma unroll
      for (int i = 0; i < Cfg::RS; ++i) qv[i] = qs[(srow + 8 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kval(scol + 16 * j, d);
#pragma unroll
      for (int i = 0; i < Cfg::RS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < Cfg::RS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = scol + 16 * j;
        ps[(srow + 8 * i) * BS + c] = c < nvalid ? s[i][j] : kNegInf;
      }
    __syncthreads();

    // online softmax: warp w owns rows w, w + 4, ...
#pragma unroll
    for (int r = warp; r < BR; r += NT / 32) {
      const float x0 = ps[r * BS + lane], x1 = ps[r * BS + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = lane < nvalid ? expf(x0 - m_new) : 0.f;
      const float p1 = lane + 32 < nvalid ? expf(x1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[r * BS + lane] = p0;  // f32 values: p.astype(v.dtype) rounds nothing
      ps[r * BS + lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, four keys a step
#pragma unroll
    for (int i = 0; i < Cfg::RPT; ++i) {
      const float alpha = a_s[rgrp + Cfg::RG * i];
#pragma unroll
      for (int j = 0; j < Cfg::CPT; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < BS; c += 4) {
      float vv[Cfg::CPT][4];
#pragma unroll
      for (int j = 0; j < Cfg::CPT; ++j)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) vv[j][cc] = vval(c + cc, dcol + Cfg::DC * j);
#pragma unroll
      for (int i = 0; i < Cfg::RPT; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(&ps[(rgrp + Cfg::RG * i) * BS + c]);
#pragma unroll
        for (int j = 0; j < Cfg::CPT; ++j) {
          float a = acc[i][j];
          a = fmaf(p4.x, vv[j][0], a);
          a = fmaf(p4.y, vv[j][1], a);
          a = fmaf(p4.z, vv[j][2], a);
          a = fmaf(p4.w, vv[j][3], a);
          acc[i][j] = a;
        }
      }
    }
    __syncthreads();  // the stage and ps are free again
  }

  float* ob = acc_out + (sp.out + sp.r0) * D;
#pragma unroll
  for (int i = 0; i < Cfg::RPT; ++i) {
    const int r = rgrp + Cfg::RG * i;
    if (sp.r0 + r < g.R) {
#pragma unroll
      for (int j = 0; j < Cfg::CPT; ++j) ob[(int64_t)r * D + dcol + Cfg::DC * j] = acc[i][j];
    }
  }
  if (tid < BR && sp.r0 + tid < g.R) {
    m_out[sp.out + sp.r0 + tid] = m_s[tid];
    l_out[sp.out + sp.r0 + tid] = l_s[tid];
  }
}

// ---------------------------------------------------------------------------
// the fixed-order merge of the splits
// ---------------------------------------------------------------------------

// One thread per (row, 4 columns of D): the splits that start below the
// slot's length, in split order.  Partials [n_splits, B, Hkv, R, D] (acc)
// and [n_splits, B, Hkv, R] (m, l).
__global__ void __launch_bounds__(128) merge_splits(
    const float* __restrict__ pacc, const float* __restrict__ pm, const float* __restrict__ pl,
    const int* __restrict__ lengths, float* __restrict__ acc, float* __restrict__ m,
    float* __restrict__ l, int B, int Hkv, int R, int D, int S, int split_cols, int n_splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int D4 = D / 4;
  if (idx >= R * D4) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r = idx / D4, c = (idx % D4) * 4;
  int n = lengths[b];
  n = n < 0 ? 0 : (n > S ? S : n);
  int live = (n + split_cols - 1) / split_cols;
  live = live < n_splits ? live : n_splits;
  const int64_t row = ((int64_t)b * Hkv + h) * R + r;
  const int64_t stride = (int64_t)B * Hkv * R;  // one split of m, l
  float4* out = reinterpret_cast<float4*>(acc + row * D + c);
  if (live == 0) {
    *out = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c == 0) {
      m[row] = kNegInf;
      l[row] = 0.f;
    }
    return;
  }
  const float* pmr = pm + row;
  const float* plr = pl + row;
  const float* par = pacc + row * D + c;
  float mx = pmr[0];
  for (int i = 1; i < live; ++i) mx = fmaxf(mx, pmr[i * stride]);
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float ls = 0.f;
  for (int i = 0; i < live; ++i) {
    const float w = expf(pmr[i * stride] - mx);
    const float4 p = *reinterpret_cast<const float4*>(par + i * stride * D);
    a.x = fmaf(p.x, w, a.x);
    a.y = fmaf(p.y, w, a.y);
    a.z = fmaf(p.z, w, a.z);
    a.w = fmaf(p.w, w, a.w);
    ls = fmaf(plr[i * stride], w, ls);
  }
  *out = a;
  if (c == 0) {
    m[row] = mx;
    l[row] = ls;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale;
  const int* lengths;
  float *acc, *m, *l, *pacc, *pm, *pl;
  Grid g;
  Cache ca;
  int max_pages;
  cudaStream_t stream;
};

// the dynamic shared-memory limit of one kernel instance, raised once per
// device
template <typename K>
int allow_smem(K kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  return 0;
}

template <bool QUANT, bool PAGED, int D, int WR>
int launch_mma(const Args& a) {
  using Cfg = MmaCfg<QUANT, D, WR>;
  static bool done[kMaxDevices] = {};
  auto kernel = decode_mma<QUANT, PAGED, D, WR>;
  const int err = allow_smem(kernel, done);
  if (err) return err;
  const size_t smem = Cfg::SMEM + (PAGED ? 4 * (size_t)a.max_pages : 0);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool split = a.g.n_splits > 1;
  const dim3 grid(a.g.row_tiles * a.g.n_splits, a.g.Hkv, a.g.B);
  kernel<<<grid, Cfg::NT, smem, a.stream>>>(
      (const bf16*)a.q, a.k, a.v, (const float*)a.k_scale, (const float*)a.v_scale, a.lengths,
      split ? a.pacc : a.acc, split ? a.pm : a.m, split ? a.pl : a.l, a.g, a.ca);
  return (int)cudaGetLastError();
}

template <bool QUANT, bool PAGED, int D, int BR>
int launch_fma(const Args& a) {
  using Cfg = FmaCfg<QUANT, D, BR>;
  static bool done[kMaxDevices] = {};
  auto kernel = decode_fma<QUANT, PAGED, D, BR>;
  const int err = allow_smem(kernel, done);
  if (err) return err;
  const size_t smem = Cfg::SMEM + (PAGED ? 4 * (size_t)a.max_pages : 0);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool split = a.g.n_splits > 1;
  const dim3 grid(a.g.row_tiles * a.g.n_splits, a.g.Hkv, a.g.B);
  kernel<<<grid, Cfg::NT, smem, a.stream>>>(
      (const float*)a.q, a.k, a.v, (const float*)a.k_scale, (const float*)a.v_scale, a.lengths,
      split ? a.pacc : a.acc, split ? a.pm : a.m, split ? a.pl : a.l, a.g, a.ca);
  return (int)cudaGetLastError();
}

template <bool QUANT, bool PAGED, int D>
int by_rows(const Args& a, bool bf16_q, int br) {
  if (bf16_q && br == 16) return launch_mma<QUANT, PAGED, D, 1>(a);
  if (bf16_q && br == 64) return launch_mma<QUANT, PAGED, D, 4>(a);
  if (!bf16_q && br == 8) return launch_fma<QUANT, PAGED, D, 8>(a);
  if (!bf16_q && br == 32) return launch_fma<QUANT, PAGED, D, 32>(a);
  return (int)cudaErrorInvalidValue;
}

template <bool QUANT, bool PAGED>
int by_head_dim(const Args& a, bool bf16_q, int D, int br) {
  switch (D) {
    case 64:
      return by_rows<QUANT, PAGED, 64>(a, bf16_q, br);
    case 128:
      return by_rows<QUANT, PAGED, 128>(a, bf16_q, br);
    case 256:
      return by_rows<QUANT, PAGED, 256>(a, bf16_q, br);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// log2(n) for a power of two, else -1
int pow2_shift(int n) {
  if (n <= 0 || (n & (n - 1))) return -1;
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

int run(bool bf16_q, const void* q, const void* k, const void* v, const void* k_scale,
        const void* v_scale, const void* lengths, const void* table, void* acc, void* m,
        void* l, void* pacc, void* pm, void* pl, int B, int Hkv, int R, int D, int S,
        int quantized, int ps, int mb, int rows, int split_cols, int n_splits, int max_pages,
        const int64_t* st, void* stream) {
  if (rows <= 0 || split_cols <= 0 || split_cols % BS || n_splits <= 0 || R <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_splits > 1 && (!pacc || !pm || !pl)) return (int)cudaErrorInvalidValue;
  const bool paged = table != nullptr;
  Args a{q, k, v, k_scale, v_scale, (const int*)lengths, (float*)acc, (float*)m, (float*)l,
         (float*)pacc, (float*)pm, (float*)pl,
         Grid{B, Hkv, R, S, (R + rows - 1) / rows, split_cols, n_splits},
         Cache{(const int*)table, ps, mb, pow2_shift(ps), st[0], st[1], st[2], st[3], st[4], st[5], st[6],
               st[7], st[8], st[9], st[10], st[11]},
         max_pages, (cudaStream_t)stream};
  int err;
  if (quantized)
    err = paged ? by_head_dim<true, true>(a, bf16_q, D, rows)
                : by_head_dim<true, false>(a, bf16_q, D, rows);
  else
    err = paged ? by_head_dim<false, true>(a, bf16_q, D, rows)
                : by_head_dim<false, false>(a, bf16_q, D, rows);
  if (err || n_splits == 1) return err;
  const dim3 grid((R * (D / 4) + 127) / 128, Hkv, B);
  merge_splits<<<grid, 128, 0, a.stream>>>(a.pacc, a.pm, a.pl, a.lengths, a.acc, a.m, a.l, B,
                                           Hkv, R, D, S, split_cols, n_splits);
  return (int)cudaGetLastError();
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
// paged; b is then unused); unit stride over D; q, k, v and the rows of k
// and v 16-byte aligned.  The plan: `rows` query rows a block (bf16: 16 or
// 64; f32: 8 or 32), `split_cols` cache columns a split (a multiple of 64)
// and `n_splits` splits; with more than one, pacc [n_splits, B, Hkv, R, D]
// and pm, pl [n_splits, B, Hkv, R] f32 hold the partials and a second
// kernel merges them.  max_pages: the most block-table entries one block
// reads (paged).  Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* lengths, const void* table, void* acc,
                                void* m, void* l, void* pacc, void* pm, void* pl, int B,
                                int Hkv, int R, int D, int S, int quantized, int ps, int mb,
                                int rows, int split_cols, int n_splits, int max_pages,
                                const int64_t* strides, void* stream) {
  return run(false, q, k, v, k_scale, v_scale, lengths, table, acc, m, l, pacc, pm, pl, B, Hkv,
             R, D, S, quantized, ps, mb, rows, split_cols, n_splits, max_pages, strides, stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale,
                                 const void* lengths, const void* table, void* acc,
                                 void* m, void* l, void* pacc, void* pm, void* pl, int B,
                                 int Hkv, int R, int D, int S, int quantized, int ps, int mb,
                                 int rows, int split_cols, int n_splits, int max_pages,
                                 const int64_t* strides, void* stream) {
  return run(true, q, k, v, k_scale, v_scale, lengths, table, acc, m, l, pacc, pm, pl, B, Hkv,
             R, D, S, quantized, ps, mb, rows, split_cols, n_splits, max_pages, strides, stream);
}
