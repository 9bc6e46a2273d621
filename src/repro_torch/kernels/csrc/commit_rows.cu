// In-place KV-cache commit of K1 rows per slot, for Hopper (sm_90a): the
// dense and the paged layout, for any element type.
//
// Replaces repro/kernels/cache_update.py::commit_rows (Pallas body
// `_kernel`, one async row-block DMA per slot; wrappers `commit_rows_stacked`
// and `commit_rows_quantized`) and ::commit_rows_paged (body `_kernel_paged`,
// one DMA per row through the block table; wrapper
// `commit_rows_paged_quantized`).  For unit u and slot b, row j of
// rows[u, b] lands at logical position pos = lengths[b] + j:
//   dense: cache[u, b, pos] (an [nu, B, S, row] cache); rows at or past S are
//          dropped, the rule of the port's and the unfused reference's
//          `_update_rows` (the Pallas kernel's pl.ds start is clamped in
//          interpret mode instead);
//   paged: pool[u, table[b, pos / ps], pos % ps] (an [nu, n_blocks, ps, row]
//          pool, one table for every unit); rows past the table's reach go to
//          trash block 0, as in the Pallas kernel.  Several dead rows may land
//          on one trash row in one launch; block 0 is never read.
// A row is the contiguous [H, D] slab of `row_bytes` bytes: int8 values (1
// byte an element), bf16 (2), f32 values or the int8 layout's f32 scales (4).
//
// Bound: the bytes of the rows, read once and written once (K1 rows of
// H * D elements per unit and slot: 5 x 2 KB per (unit, slot) at openPangu-7B
// in bf16).  Design: one block per (row j, unit and slot), which copies its
// row with the widest vector (16 bytes a thread when the row, the strides and
// the pointers allow it) over neighbouring addresses; the position, the
// table lookup and the drop rule are computed once per block.  No shared
// memory, nothing else of the cache is touched.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int V>
struct Vec;
template <>
struct Vec<16> { using type = uint4; };
template <>
struct Vec<8> { using type = uint2; };
template <>
struct Vec<4> { using type = uint32_t; };
template <>
struct Vec<2> { using type = uint16_t; };
template <>
struct Vec<1> { using type = uint8_t; };

// strides in bytes: s_unit between units, s_b between slots (dense only),
// s_row between cache (or pool) rows
template <int V>
__global__ void commit_rows_kernel(const char* __restrict__ rows, char* __restrict__ cache,
                                   const int* __restrict__ lengths,
                                   const int* __restrict__ table, int B, int K1,
                                   int row_bytes, int S, int ps, int mb, int64_t s_unit,
                                   int64_t s_b, int64_t s_row) {
  using W = typename Vec<V>::type;
  const int j = blockIdx.x;            // row within the slot's K1
  const int i = blockIdx.y;            // unit * B + slot
  const int u = i / B, b = i % B;
  const int pos = lengths[b] + j;
  if (pos < 0) return;
  int64_t off;
  if (table != nullptr) {
    const int lb = pos / ps;
    const int blk = lb < mb ? table[(int64_t)b * mb + lb] : 0;
    off = u * s_unit + ((int64_t)blk * ps + pos % ps) * s_row;
  } else {
    if (pos >= S) return;
    off = u * s_unit + b * s_b + (int64_t)pos * s_row;
  }
  const W* src = reinterpret_cast<const W*>(rows + ((int64_t)i * K1 + j) * row_bytes);
  W* dst = reinterpret_cast<W*>(cache + off);
  for (int x = threadIdx.x; x < row_bytes / V; x += blockDim.x) dst[x] = src[x];
}

template <int V>
int launch(const void* rows, void* cache, const void* lengths, const void* table, int nu,
           int B, int K1, int row_bytes, int S, int ps, int mb, int64_t s_unit, int64_t s_b,
           int64_t s_row, void* stream) {
  int threads = (row_bytes / V + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const dim3 grid(K1, nu * B);
  commit_rows_kernel<V><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const char*)rows, (char*)cache, (const int*)lengths, (const int*)table, B, K1,
      row_bytes, S, ps, mb, s_unit, s_b, s_row);
  return (int)cudaGetLastError();
}

}  // namespace

// rows [nu, B, K1, row] contiguous; cache: dense [nu, B, S, row] or paged
// pool [nu, n_blocks, ps, row] (table [B, mb] int32 contiguous, else null),
// each row contiguous, with byte strides s_unit (units), s_b (slots, dense)
// and s_row (rows); lengths [B] int32.  One launch on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int commit_rows(const void* rows, void* cache, const void* lengths,
                           const void* table, int nu, int B, int K1, int row_bytes, int S,
                           int ps, int mb, int64_t s_unit, int64_t s_b, int64_t s_row,
                           void* stream) {
  if (nu <= 0 || B <= 0 || K1 <= 0) return 0;
  // the widest vector that every address and stride is a multiple of
  uint64_t a = (uint64_t)(uintptr_t)rows | (uint64_t)(uintptr_t)cache |
               (uint64_t)row_bytes | (uint64_t)s_unit | (uint64_t)s_b | (uint64_t)s_row;
  if (a % 16 == 0)
    return launch<16>(rows, cache, lengths, table, nu, B, K1, row_bytes, S, ps, mb, s_unit,
                      s_b, s_row, stream);
  if (a % 8 == 0)
    return launch<8>(rows, cache, lengths, table, nu, B, K1, row_bytes, S, ps, mb, s_unit,
                     s_b, s_row, stream);
  if (a % 4 == 0)
    return launch<4>(rows, cache, lengths, table, nu, B, K1, row_bytes, S, ps, mb, s_unit,
                     s_b, s_row, stream);
  if (a % 2 == 0)
    return launch<2>(rows, cache, lengths, table, nu, B, K1, row_bytes, S, ps, mb, s_unit,
                     s_b, s_row, stream);
  return launch<1>(rows, cache, lengths, table, nu, B, K1, row_bytes, S, ps, mb, s_unit,
                   s_b, s_row, stream);
}
