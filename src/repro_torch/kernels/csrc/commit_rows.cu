// In-place KV-cache commit of a spec step's accepted rows, for Hopper
// (sm_90a): every unit and every cache leaf in one launch, read straight
// from the in-flight rows where decode left them; dense and paged layouts,
// fp values or int8 values with f32 scales.
//
// Replaces repro/kernels/cache_update.py::commit_rows (Pallas body
// `_kernel`, one async row-block DMA per slot; wrappers `commit_rows_stacked`
// and `commit_rows_quantized`) and ::commit_rows_paged (body `_kernel_paged`,
// one DMA per row through the block table; wrapper
// `commit_rows_paged_quantized`), together with what the reference's
// transformer._commit_attn_entry does around them: the gather of the best
// path's rows and, under int8, quantize_rows.  For unit u, slot b and path
// row j, in-flight row path[b, j] of unit u's source lands at logical
// position pos = lengths[b] + j of every leaf:
//   dense: cache[u, b, pos] (an [nu, B, S, row] cache); rows at or past S are
//          dropped, the rule of the port's and the unfused reference's
//          `_update_rows` (the Pallas kernel's pl.ds start is clamped in
//          interpret mode instead);
//   paged: pool[u, table[b, pos / ps], pos % ps] (an [nu, n_blocks, ps, row]
//          pool, one table for every unit); rows past the table's reach go to
//          trash block 0, as in the Pallas kernel.  Several dead rows may land
//          on one trash row in one launch; block 0 is never read.
// Three modes: a copy of rows of any element type (the cache's own dtype),
// an f32 <-> bf16 cast (round to nearest even, as `.to()` does), and int8
// quantization per head, bitwise quant.quantize_rows: scale =
// max(amax(|x|), 1e-8) / 127 and q = clamp(rint(x / scale), -127, 127),
// true divisions (__fdiv_rn), round half to even (rintf).  The rows-given
// wrappers (`commit_rows_stacked`, `commit_rows_paged_stacked`) are the
// same kernel with a null path (row j is in-flight row j).
//
// Bound: the accepted rows, read once and written once (K1 rows of H * D
// elements per unit, slot and leaf: 5 x 2 KB x 2 leaves per (unit, slot) at
// openPangu-7B in bf16, 5.57 MB for 34 units and 4 slots), plus the index
// reads.  Design: one block per (path row j, unit and slot) moves that row
// of every leaf; its two index reads (lengths[b], path[b, j]) are issued
// together and are its only dependent hop before the row loads (paged adds
// the table entry).  A copy moves one vector a thread over neighbouring
// addresses, the widest (16 bytes when the rows, strides and pointers allow
// it): at openPangu-7B 680 blocks of 256 threads, one 16-byte vector each,
// one wave on 132 SMs.  Cast and quantization take 8 elements a thread;
// quantization reduces each head's amax over its D / 8 lanes with warp
// shuffles (max is exact in any order), each leaf's threads starting on a
// warp.  The sources come in by value, a table of per-unit row pointers in
// the kernel parameters (a captured graph freezes them; the in-flight
// tensors live at fixed addresses of the graph's pool), so the step never
// stacks its in-flight rows.  No shared memory, nothing else of the cache is
// touched.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxUnits = 128;  // units the source table holds
constexpr int kLeaves = 2;      // source leaves a launch: k and v
constexpr int kEpt = 8;         // elements a thread casts or quantizes
constexpr int kMaxThreads = 1024;

enum Mode { kCopy = 0, kCast = 1, kQuant = 2 };

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

// element bits <-> f32
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using bits = uint32_t;
  static __device__ __forceinline__ float get(bits b) { return __uint_as_float(b); }
  static __device__ __forceinline__ bits put(float f) { return __float_as_uint(f); }
};
template <>
struct Elem<__nv_bfloat16> {
  using bits = uint16_t;
  static __device__ __forceinline__ float get(bits b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ bits put(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

// per-unit source rows, leaf-major, by value (``__grid_constant__``: read in
// place from the parameter space, never copied per thread)
struct Units {
  const char* src[kLeaves][kMaxUnits];
};

// strides in bytes
struct Leaf {
  int64_t src_b, src_t;         // source [B, T, H, D]: slot, in-flight row
  char* dst;                    // values (a copy's or a cast's destination)
  int64_t dst_u, dst_b, dst_r;  // units, slots (dense only), rows
  float* scale;                 // int8 scales [..., H, 1] (quantization only)
  int64_t sc_u, sc_b, sc_r;
};

struct Params {
  Leaf leaf[kLeaves];
  const int* lengths;  // [B]
  const void* path;    // [B, K1] int32 or int64; null: path row j is row j
  const int* table;    // paged: [B, mb] int32; null: dense
  int path_i64, n_leaves, B, K1, S, ps, mb, D;
  int chunks;          // vectors (copy) or 8-element chunks a leaf row holds
  int span;            // threads given to each leaf (quantization: whole warps)
};

// N bytes at p (N / W accesses of W bytes) <-> 8 elements in f32
template <typename T, int W>
__device__ __forceinline__ void load8(float (&f)[kEpt], const char* p) {
  constexpr int N = kEpt * sizeof(T);
  constexpr int A = W < N ? W : N;
  using R = typename Vec<A>::type;
  union {
    R r[N / A];
    typename Elem<T>::bits e[kEpt];
  } u;
#pragma unroll
  for (int k = 0; k < N / A; ++k) u.r[k] = reinterpret_cast<const R*>(p)[k];
#pragma unroll
  for (int k = 0; k < kEpt; ++k) f[k] = Elem<T>::get(u.e[k]);
}

template <typename T, int W>
__device__ __forceinline__ void store8(char* p, const float (&f)[kEpt]) {
  constexpr int N = kEpt * sizeof(T);
  constexpr int A = W < N ? W : N;
  using R = typename Vec<A>::type;
  union {
    R r[N / A];
    typename Elem<T>::bits e[kEpt];
  } u;
#pragma unroll
  for (int k = 0; k < kEpt; ++k) u.e[k] = Elem<T>::put(f[k]);
#pragma unroll
  for (int k = 0; k < N / A; ++k) reinterpret_cast<R*>(p)[k] = u.r[k];
}

template <int W>
__device__ __forceinline__ void store_q8(char* p, const int8_t (&q)[kEpt]) {
  constexpr int A = W < kEpt ? W : kEpt;
  using R = typename Vec<A>::type;
  union {
    R r[kEpt / A];
    int8_t q[kEpt];
  } u;
#pragma unroll
  for (int k = 0; k < kEpt; ++k) u.q[k] = q[k];
#pragma unroll
  for (int k = 0; k < kEpt / A; ++k) reinterpret_cast<R*>(p)[k] = u.r[k];
}

// S: source element type (cast, quantization); C: the cast's destination
// type; V: the widest access every address and stride allows
template <int MODE, typename S, typename C, int V>
__global__ void __launch_bounds__(kMaxThreads)
    commit_path_kernel(const __grid_constant__ Units units, const __grid_constant__ Params p) {
  const int j = blockIdx.x;  // path row
  const int i = blockIdx.y;  // unit * B + slot
  const int u = i / p.B, b = i - u * p.B;
  // the two index reads, issued together
  const int len = __ldg(p.lengths + b);
  int slot = j;
  if (p.path != nullptr) {
    const int64_t at = (int64_t)b * p.K1 + j;
    slot = p.path_i64 ? (int)__ldg(static_cast<const long long*>(p.path) + at)
                      : __ldg(static_cast<const int*>(p.path) + at);
  }
  const int pos = len + j;
  if (pos < 0) return;
  int64_t row, sb;  // the destination row, and the slot (dense only)
  if (p.table != nullptr) {
    const int lb = pos / p.ps;
    const int blk = lb < p.mb ? __ldg(p.table + (int64_t)b * p.mb + lb) : 0;
    row = (int64_t)blk * p.ps + pos % p.ps;
    sb = 0;
  } else {
    if (pos >= p.S) return;  // the whole block: no thread reaches a shuffle
    row = pos;
    sb = b;
  }
  const int tph = p.D / kEpt;  // quantization: lanes a head
  for (int base = 0; base < p.n_leaves * p.span; base += blockDim.x) {
    const int x = base + threadIdx.x;
    int l = x / p.span;
    const int e = x - l * p.span;
    const bool active = l < p.n_leaves && e < p.chunks;
    if (l >= p.n_leaves) l = 0;
    const Leaf& L = p.leaf[l];
    const char* src = units.src[l][u] + b * L.src_b + (int64_t)slot * L.src_t;
    char* dst = L.dst + u * L.dst_u + sb * L.dst_b + row * L.dst_r;
    if constexpr (MODE == kCopy) {
      using W = typename Vec<V>::type;
      if (active) reinterpret_cast<W*>(dst)[e] = reinterpret_cast<const W*>(src)[e];
    } else if constexpr (MODE == kCast) {
      if (active) {
        float f[kEpt];
        load8<S, V>(f, src + (int64_t)e * kEpt * sizeof(S));
        store8<C, V>(dst + (int64_t)e * kEpt * sizeof(C), f);
      }
    } else {
      float f[kEpt];
      float a = 0.f;
      if (active) {
        load8<S, V>(f, src + (int64_t)e * kEpt * sizeof(S));
#pragma unroll
        for (int k = 0; k < kEpt; ++k) a = fmaxf(a, fabsf(f[k]));
      }
      // every lane of the warp takes part; a head's lanes are aligned
      for (int off = tph >> 1; off > 0; off >>= 1)
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
      if (active) {
        const float scale = __fdiv_rn(fmaxf(a, 1e-8f), 127.0f);
        int8_t q[kEpt];
#pragma unroll
        for (int k = 0; k < kEpt; ++k)
          q[k] = (int8_t)(int)fminf(fmaxf(rintf(__fdiv_rn(f[k], scale)), -127.0f), 127.0f);
        store_q8<V>(dst + (int64_t)e * kEpt, q);
        if (e % tph == 0)
          *reinterpret_cast<float*>(reinterpret_cast<char*>(L.scale) + u * L.sc_u +
                                    sb * L.sc_b + row * L.sc_r + (e / tph) * 4) = scale;
      }
    }
  }
}

template <int MODE, typename S, typename C, int V>
int launch(const Units& units, const Params& p, int nu, cudaStream_t stream) {
  int threads = (p.n_leaves * p.span + 31) / 32 * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  const dim3 grid(p.K1, nu * p.B);
  commit_path_kernel<MODE, S, C, V><<<grid, threads, 0, stream>>>(units, p);
  return (int)cudaGetLastError();
}

template <int MODE, typename S, typename C>
int launch_v(int v, const Units& units, const Params& p, int nu, cudaStream_t stream) {
  switch (v) {
    case 16: return launch<MODE, S, C, 16>(units, p, nu, stream);
    case 8: return launch<MODE, S, C, 8>(units, p, nu, stream);
    case 4: return launch<MODE, S, C, 4>(units, p, nu, stream);
    case 2: return launch<MODE, S, C, 2>(units, p, nu, stream);
    default: return launch<MODE, S, C, 1>(units, p, nu, stream);
  }
}

}  // namespace

// One launch commits path row j of every slot of every unit, for each of
// `n_leaves` (1 or 2) source leaves.
//   src     [n_leaves * nu]: unit u's in-flight rows [B, T, H, D] of leaf l
//           at src[l * nu + u], each [H, D] row contiguous;
//   dst     [n_leaves * 2]: leaf l's values at dst[2 l] (a dense cache
//           [nu, B, S, H, D] or a pool [nu, n_blocks, ps, H, D], [H, D] rows
//           contiguous) and its f32 scales [..., H, 1] at dst[2 l + 1]
//           (quantization; null otherwise);
//   strides [n_leaves * 8] in bytes: source slot and row; values unit, slot
//           (dense) and row; scales unit, slot (dense) and row;
//   mode    0 copy (`elem_bytes` an element, any type), 1 cast (f32 <-> bf16),
//           2 int8 quantization; `src_bf16` the source type of 1 and 2;
//   path    [B, K1] int32 (`path_bytes` 4) or int64 (8), or null (row j);
//   table   [B, mb] int32 for a pool (page size ps), or null (a dense cache of
//           S rows);
//   lengths [B] int32.
// One launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int commit_path(const void* const* src, void* const* dst, const int64_t* strides,
                           int n_leaves, int nu, int B, int K1, int H, int D, int mode,
                           int src_bf16, int elem_bytes, const void* lengths, const void* path,
                           int path_bytes, const void* table, int S, int ps, int mb,
                           void* stream) {
  if (nu <= 0 || B <= 0 || K1 <= 0) return 0;
  if (nu > kMaxUnits || n_leaves < 1 || n_leaves > kLeaves || H <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  Units units = {};
  Params p = {};
  // every address and stride, OR-ed: the widest access they all allow
  uint64_t a = 0;
  for (int l = 0; l < n_leaves; ++l) {
    for (int u = 0; u < nu; ++u) {
      units.src[l][u] = static_cast<const char*>(src[l * nu + u]);
      a |= (uint64_t)(uintptr_t)src[l * nu + u];
    }
    const int64_t* s = strides + 8 * l;
    Leaf& L = p.leaf[l];
    L.src_b = s[0];
    L.src_t = s[1];
    L.dst = static_cast<char*>(dst[2 * l]);
    L.dst_u = s[2];
    L.dst_b = s[3];
    L.dst_r = s[4];
    L.scale = static_cast<float*>(dst[2 * l + 1]);
    L.sc_u = s[5];
    L.sc_b = s[6];
    L.sc_r = s[7];
    a |= (uint64_t)(uintptr_t)L.dst | (uint64_t)s[0] | (uint64_t)s[1] | (uint64_t)s[2] |
         (uint64_t)s[3] | (uint64_t)s[4];
  }
  p.lengths = static_cast<const int*>(lengths);
  p.path = path;
  p.path_i64 = path_bytes == 8;
  p.table = static_cast<const int*>(table);
  p.n_leaves = n_leaves;
  p.B = B;
  p.K1 = K1;
  p.S = S;
  p.ps = ps;
  p.mb = mb;
  p.D = D;
  const int elems = H * D;
  const int row_bytes = elems * elem_bytes;  // copy: bytes of one [H, D] row
  if (mode == kCopy) {
    a |= (uint64_t)row_bytes;
  } else if (elems % kEpt != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int v = a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : a % 2 == 0 ? 2 : 1;
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (mode == kCopy) {
    p.chunks = row_bytes / v;
    p.span = p.chunks;
    return launch_v<kCopy, uint8_t, uint8_t>(v, units, p, nu, s);
  }
  p.chunks = elems / kEpt;
  if (mode == kCast) {
    p.span = p.chunks;
    return src_bf16 ? launch_v<kCast, bf16, float>(v, units, p, nu, s)
                    : launch_v<kCast, float, bf16>(v, units, p, nu, s);
  }
  // quantization: a head's D / 8 lanes must divide a warp
  if (mode != kQuant || D % kEpt != 0 || 32 % (D / kEpt) != 0)
    return (int)cudaErrorInvalidValue;
  p.span = (p.chunks + 31) / 32 * 32;
  return src_bf16 ? launch_v<kQuant, bf16, int8_t>(v, units, p, nu, s)
                  : launch_v<kQuant, float, int8_t>(v, units, p, nu, s);
}
