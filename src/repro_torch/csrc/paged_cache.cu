// Paged KV-cache scatter and gather for the serving fleet (sm_90a).
//
// Replaces the TPU kernels of the reference's kernels/paged_cache.py:
//   repro_paged_scatter        <- paged_scatter (_scatter_kernel)
//   repro_paged_gather         <- paged_gather  (_gather_kernel)
//   repro_paged_scatter_quant  <- paged_scatter_quant (_scatter_quant_kernel)
//
// Pool layout (NB, BS, KVh, hd), row-major; one "row" is one token position
// across all KV heads (KVh * hd elements). Block 0 is the null block: never
// written, dead table entries point at it.
//
// What bounds them on an H100: bytes. Neither does arithmetic; each moves
// its payload once (scatter: one row per appending slot, ~KVh*hd*2 B = 1 KB
// at the main-path shape; gather: S*MB blocks of BS rows, 544 blocks of
// 16 KB = 8.9 MB written at the main path). Both are bit-exact copies, so
// the element type does not matter: the kernels copy bytes in units of T,
// the widest of 16, 8, 4, 2 or 1 bytes that the sizes and pointers allow
// (16 for bf16/fp32/int8 blocks and rows).
//
// Scatter: one CTA per pool block, copying its row when a slot writes into
// it. The scatter's block->writer map makes every pool block written by at
// most one CTA, so no atomics; its time is the launch's.
//
// Gather: bytes in flight. Each CTA of 256 threads takes a contiguous run
// of table entries of the flattened (S, MB) table, sized so that a thread
// moves at most 8 units (2 entries of 16 KB at the main path: 272 CTAs over
// 132 SMs, 32 KB each). The CTA reads each entry's table slot and n_live
// once into shared memory; then every thread issues all of its (up to 8)
// 16-byte loads, unrolled, before any of its stores, so a CTA keeps its
// whole run in flight instead of one load per thread. Entries at or past
// n_live[s], or naming a block outside the pool, are written as zeros
// with no load, so the poisoned free block is never read. Stores are
// streaming (st.global.cs): the gathered copy is read once, by the
// attention that follows, and should not evict the pool from L2.
//
// The quantizing scatter (int8 / float8_e4m3fn pools, one fp32 scale per
// row in a (NB, BS) array) keeps scatter_kernel's layout: one CTA per pool
// block, returning at once when no slot writes into it. A writer's CTA
// loads its row (KVh * hd values, fp32 or bf16, converted to fp32
// exactly as the reference's new.astype(float32)), block-reduces the
// absmax (a max is exact in any order) and quantizes in the reference's
// arithmetic (_quantize / quantize_rows): scale = absmax / qmax as an IEEE
// division (the build has no fast-math flags), inv = scale > 0 ?
// 1 / max(scale, 1e-30) : 0, y = x * inv (a product by the reciprocal, not
// a division by the scale), then int8: rintf (round half to even) clipped
// to +-127; fp8: __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3),
// round to nearest even. |y| <= 448 up to one rounding of the product, so
// the saturating mode never changes a value that the plain conversion
// would keep finite. It writes the payload row and scales[b, off] and
// nothing else. Bound: bytes again, S rows read and S quantized rows and
// scales written (~49 KB at the main path, a few ns at 3.35 TB/s), so
// launch latency sets its time; the design spends one pass over the row.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

// scatter: CTA b owns pool block b; writes row write_off[b] from slot
// write_slot[b] (-1: untouched). Out-of-range map entries are skipped so a
// bad map cannot write outside the pool.
template <typename T>
__global__ void scatter_kernel(T* __restrict__ pool, const T* __restrict__ rows,
                               const int* __restrict__ write_slot,
                               const int* __restrict__ write_off,
                               int block_size, int row_units, int num_slots) {
  const int b = blockIdx.x;
  const int w = write_slot[b];
  if (w < 0 || w >= num_slots) return;
  const int off = write_off[b];
  if (off < 0 || off >= block_size) return;
  T* dst = pool + ((size_t)b * block_size + off) * row_units;
  const T* src = rows + (size_t)w * row_units;
  for (int i = threadIdx.x; i < row_units; i += blockDim.x) dst[i] = src[i];
}

// gather: CTA i copies the table entries [i * per_cta, (i + 1) * per_cta)
// of the flattened (S, MB) table: pool block table[s, m] into out[s, m],
// or zeros when m >= n_live[s] or the block is out of range.
constexpr int kGatherThreads = 256;
constexpr int kGatherUnroll = 8;         // loads in flight per thread
constexpr int kGatherMaxEntries = 64;    // entries per CTA

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const T* __restrict__ pool, const int* __restrict__ table,
              const int* __restrict__ n_live, T* __restrict__ out,
              int max_blocks, int block_units, int num_blocks, int entries,
              int per_cta) {
  __shared__ int src_block[kGatherMaxEntries];  // -1: write zeros
  const int e0 = blockIdx.x * per_cta;
  const int n_e = min(per_cta, entries - e0);
  if (threadIdx.x < n_e) {
    const int e = e0 + threadIdx.x;
    const int s = e / max_blocks;
    const int blk = table[e];
    src_block[threadIdx.x] =
        e - s * max_blocks < n_live[s] && blk >= 0 && blk < num_blocks ? blk : -1;
  }
  __syncthreads();
  const int total = n_e * block_units;
  T* dst = out + (size_t)e0 * block_units;
  for (int base = 0; base < total; base += kGatherThreads * kGatherUnroll) {
    T val[kGatherUnroll];
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const int i = base + u * kGatherThreads + threadIdx.x;
      val[u] = T{};
      if (i < total) {
        const int e = i / block_units;
        const int blk = src_block[e];
        if (blk >= 0) val[u] = pool[(size_t)blk * block_units + (i - e * block_units)];
      }
    }
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const int i = base + u * kGatherThreads + threadIdx.x;
      if (i < total) __stcs(dst + i, val[u]);
    }
  }}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename Q> __device__ __forceinline__ Q quantize(float y);
template <> __device__ __forceinline__ int8_t quantize<int8_t>(float y) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f));
}
template <> __device__ __forceinline__ __nv_fp8_storage_t quantize<__nv_fp8_storage_t>(float y) {
  return __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
}

// scatter_quant: as scatter_kernel, quantizing the row on the way; rows of
// at most kThreads * kMaxPerThread values
constexpr int kMaxPerThread = 16;

template <typename R, typename Q>
__global__ void __launch_bounds__(kThreads)
scatter_quant_kernel(Q* __restrict__ pool, float* __restrict__ scales,
                     const R* __restrict__ rows,
                     const int* __restrict__ write_slot,
                     const int* __restrict__ write_off, int block_size,
                     int row_elems, int num_slots, float qmax) {
  const int b = blockIdx.x;
  const int w = write_slot[b];
  if (w < 0 || w >= num_slots) return;
  const int off = write_off[b];
  if (off < 0 || off >= block_size) return;
  const R* src = rows + (size_t)w * row_elems;
  float x[kMaxPerThread];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    x[k] = i < row_elems ? to_f(src[i]) : 0.f;
    amax = fmaxf(amax, fabsf(x[k]));
  }
  __shared__ float warp_max[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int k = 1; k < kThreads / 32; ++k) amax = fmaxf(amax, warp_max[k]);
  const float scale = amax / qmax;
  const float inv = scale > 0.f ? 1.0f / fmaxf(scale, 1e-30f) : 0.f;
  Q* dst = pool + ((size_t)b * block_size + off) * row_elems;
#pragma unroll
  for (int k = 0; k < kMaxPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < row_elems) dst[i] = quantize<Q>(x[k] * inv);
  }
  if (threadIdx.x == 0) scales[(size_t)b * block_size + off] = scale;
}

template <typename R, typename Q>
int launch_scatter_quant(void* pool, float* scales, const void* rows,
                         const int* ws, const int* wo, int nb, int bs,
                         int row_elems, int num_slots, float qmax,
                         cudaStream_t st) {
  scatter_quant_kernel<R, Q><<<nb, kThreads, 0, st>>>(
      static_cast<Q*>(pool), scales, static_cast<const R*>(rows), ws, wo, bs,
      row_elems, num_slots, qmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int scatter_quant_rows(int quant_dtype, void* pool, float* scales,
                       const void* rows, const int* ws, const int* wo, int nb,
                       int bs, int row_elems, int num_slots, cudaStream_t st) {
  switch (quant_dtype) {
    case 0: return launch_scatter_quant<R, int8_t>(pool, scales, rows, ws, wo, nb, bs, row_elems, num_slots, 127.f, st);
    case 1: return launch_scatter_quant<R, __nv_fp8_storage_t>(pool, scales, rows, ws, wo, nb, bs, row_elems, num_slots, 448.f, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned(const void* p, size_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

// widest copy unit that divides the byte counts and every pointer's alignment
int unit_bytes(long long bytes, const void* a, const void* b) {
  const int units[] = {16, 8, 4, 2, 1};
  for (int u : units)
    if (bytes % u == 0 && aligned(a, u) && aligned(b, u)) return u;
  return 1;
}

template <typename T>
void launch_scatter(void* pool, const void* rows, const int* ws, const int* wo,
                    int nb, int bs, long long row_bytes, int num_slots,
                    cudaStream_t st) {
  scatter_kernel<T><<<nb, kThreads, 0, st>>>(
      static_cast<T*>(pool), static_cast<const T*>(rows), ws, wo, bs,
      (int)(row_bytes / sizeof(T)), num_slots);
}

template <typename T>
void launch_gather(const void* pool, const int* table, const int* n_live,
                   void* out, int num_slots, int max_blocks,
                   long long block_bytes, int num_blocks, cudaStream_t st) {
  const int block_units = (int)(block_bytes / sizeof(T));
  const int entries = num_slots * max_blocks;
  int per_cta = kGatherThreads * kGatherUnroll / block_units;
  per_cta = per_cta < 1 ? 1 : per_cta > kGatherMaxEntries ? kGatherMaxEntries : per_cta;
  gather_kernel<T><<<(entries + per_cta - 1) / per_cta, kGatherThreads, 0, st>>>(
      static_cast<const T*>(pool), table, n_live, static_cast<T*>(out),
      max_blocks, block_units, num_blocks, entries, per_cta);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// pool (NB, BS, row) in place; rows (S, row); write_slot/write_off (NB,) i32.
int repro_paged_scatter(void* pool, const void* rows, const int* write_slot,
                        const int* write_off, int num_blocks, int block_size,
                        long long row_bytes, int num_slots, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (unit_bytes(row_bytes, pool, rows)) {
    case 16: launch_scatter<uint4>(pool, rows, write_slot, write_off, num_blocks, block_size, row_bytes, num_slots, st); break;
    case 8: launch_scatter<uint2>(pool, rows, write_slot, write_off, num_blocks, block_size, row_bytes, num_slots, st); break;
    case 4: launch_scatter<uint32_t>(pool, rows, write_slot, write_off, num_blocks, block_size, row_bytes, num_slots, st); break;
    case 2: launch_scatter<uint16_t>(pool, rows, write_slot, write_off, num_blocks, block_size, row_bytes, num_slots, st); break;
    default: launch_scatter<uint8_t>(pool, rows, write_slot, write_off, num_blocks, block_size, row_bytes, num_slots, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// pool (NB, block) ; table (S, MB) i32 ; n_live (S,) i32 -> out (S, MB, block).
int repro_paged_gather(const void* pool, const int* table, const int* n_live,
                       void* out, int num_slots, int max_blocks,
                       long long block_bytes, int num_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (unit_bytes(block_bytes, pool, out)) {
    case 16: launch_gather<uint4>(pool, table, n_live, out, num_slots, max_blocks, block_bytes, num_blocks, st); break;
    case 8: launch_gather<uint2>(pool, table, n_live, out, num_slots, max_blocks, block_bytes, num_blocks, st); break;
    case 4: launch_gather<uint32_t>(pool, table, n_live, out, num_slots, max_blocks, block_bytes, num_blocks, st); break;
    case 2: launch_gather<uint16_t>(pool, table, n_live, out, num_slots, max_blocks, block_bytes, num_blocks, st); break;
    default: launch_gather<uint8_t>(pool, table, n_live, out, num_slots, max_blocks, block_bytes, num_blocks, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// pool (NB, BS, row) int8 / e4m3 in place; scales (NB, BS) fp32 in place;
// rows (S, row) with row = KVh * hd <= 2048; row_dtype 0 = float32,
// 1 = bfloat16; quant_dtype 0 = int8, 1 = float8_e4m3fn.
int repro_paged_scatter_quant(void* pool, float* scales, const void* rows,
                              const int* write_slot, const int* write_off,
                              int num_blocks, int block_size, int row_elems,
                              int num_slots, int row_dtype, int quant_dtype,
                              void* stream) {
  if (row_elems > kThreads * kMaxPerThread)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (row_dtype) {
    case 0: return scatter_quant_rows<float>(quant_dtype, pool, scales, rows, write_slot, write_off, num_blocks, block_size, row_elems, num_slots, st);
    case 1: return scatter_quant_rows<__nv_bfloat16>(quant_dtype, pool, scales, rows, write_slot, write_off, num_blocks, block_size, row_elems, num_slots, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
