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
// What bounds the gather on an H100: bytes. It does no arithmetic and moves
// its payload once (S*MB blocks of BS rows, 544 blocks of 16 KB = 8.9 MB
// written at the fleet's shape); it is a bit-exact copy, so the element type
// does not matter: it copies bytes in units of T, the widest of 16, 8, 4, 2
// or 1 bytes that the sizes and pointers allow.
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
// What bounds the scatters: the launch and one dependent chain of loads
// (map -> row -> store), not the bytes. A decode step writes one row per
// live slot into K and into V (15 rows of 1 KB bf16 each at qwen2-7b:
// 0.00002 ms at 3.35 TB/s), while an empty launch takes about 0.005 ms
// between its CUDA events on an H100 80GB HBM3 at 700 W (chip_smoke.py's
// launch floor). So the design spends as little as it can beyond the
// launch:
//
// * K and V in one launch. Both pools of a layer take the same write maps;
//   the single-pool call is the same kernel with the V pointers null.
// * A grid over the map, not over the pool: CTAs of 8 warps, each CTA
//   owning 128 consecutive map entries, ceil(NB / 128) CTAs (9 at the
//   fleet's NB = 1025, 129 at a 2-peer fleet's 16,385 on one card: one
//   wave, so the cost does not grow with the pool until NB is past
//   ~100,000). Every warp of the CTA reads all 128 entries, 4 a lane as
//   one int4 of write_slot and one of write_off (scalars at the ragged
//   tail or on a map off a 16-byte boundary), ballots them, and takes
//   every 8th writer in ballot order. The allocator hands out the lowest
//   free blocks, so writers sit close together in the map: a warp that
//   walked its own writers one after another paid one dependent load per
//   writer (PERF.md, the paged KV scatters).
// * For each of its writers the warp copies that slot's K row and V row,
//   every 16-byte load of both rows in flight before any store (the loads
//   unconditional, an index past the row reading its last unit again;
//   the stores predicated). The per-writer code appears once in the
//   kernel (the warp lists its writers, then loops): the kernel starts
//   with a cold instruction cache, since a layer's weights pass through
//   L2 between two scatters.
// * The allocator's block->writer map makes every pool block written by at
//   most one writer, so no atomics. Slots outside [0, S) and offsets
//   outside [0, BS) are skipped, as a bad map must not write outside the
//   pool.
//
// The quantizing scatter (int8 / float8_e4m3fn pools, one fp32 scale per
// row in a (NB, BS) array) walks the map the same way. One warp holds a
// writer's K row and V row in registers, read in 16-byte units (8 bf16 or
// 4 fp32 values, 2 units a lane for a bf16 row at qwen2-7b; one value a
// unit where the row length or a pointer does not allow 16), both rows'
// loads in flight before either reduction, converted to fp32 exactly as
// the reference's new.astype(float32). It reduces each absmax over the
// warp with one integer max of the bit patterns (exact, see warp_absmax):
// no shared memory, no barrier. Then the reference's arithmetic (_quantize / quantize_rows):
// scale = absmax / qmax as an IEEE division (the build has no fast-math
// flags), inv = scale > 0 ? 1 / max(scale, 1e-30) : 0, y = x * inv (a
// product by the reciprocal, not a division by the scale), then int8:
// rintf (round half to even) clipped to +-127; fp8:
// __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3), round to nearest
// even. |y| <= 448 up to one rounding of the product, so the saturating
// mode never changes a value that the plain conversion would keep finite.
// A unit's quantized bytes go out in one 4- or 8-byte store; lane 0 writes
// the scale. It writes the payload rows and their scales and nothing else.
// Rows longer than the registers hold (over kRegRow = 2,048 values, e.g.
// qwen1.5-4b's 20 x 128 = 2,560) take two passes over the row instead: the
// first reduces the absmax over chunks of the row, the second re-reads each
// chunk (from L1 / L2, just read) and quantizes it with the same
// arithmetic. The absmax is a max, which the order of the values does not
// change, and the quantizing is elementwise, so the two-pass path is
// bit-exact as well.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

// ---- the scatters' walk over the write maps ----
constexpr int kScatterWarps = 8;                          // warps per CTA
constexpr int kScatterThreads = 32 * kScatterWarps;
constexpr int kMapPerLane = 4;                            // one int4
constexpr int kMapPerCta = 32 * kMapPerLane;              // 128 entries

// Calls fn(b, w, off) once for every pool block b of this CTA's 128 map
// entries whose writer w is in [0, num_slots) and whose offset off is in
// [0, block_size), on one warp, with that warp converged. Every warp loads
// all 128 entries (lane l holds entries base + 4 l + j, one int4 of each
// map) and ballots them, one ballot per j; the writers, ranked in ballot
// order, are dealt round-robin to the 8 warps, so writers that sit close
// together in the map (the allocator hands out the lowest free blocks) are
// written in parallel, not one after another. A warp first lists its
// writers (the n-th in lane n) and then calls fn in one loop, so fn's
// code appears once: the kernel runs with a cold instruction cache (the
// layer's weights pass through L2 between two scatters), and its size is
// part of its latency.
template <typename Fn>
__device__ __forceinline__ void for_each_writer(
    const int* __restrict__ write_slot, const int* __restrict__ write_off,
    int num_blocks, int block_size, int num_slots, bool vec_map, Fn fn) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * kMapPerCta + kMapPerLane * lane;
  int w[kMapPerLane], o[kMapPerLane];
  if (vec_map && b0 + kMapPerLane <= num_blocks) {
    const int4 w4 = *reinterpret_cast<const int4*>(write_slot + b0);
    const int4 o4 = *reinterpret_cast<const int4*>(write_off + b0);
    w[0] = w4.x; w[1] = w4.y; w[2] = w4.z; w[3] = w4.w;
    o[0] = o4.x; o[1] = o4.y; o[2] = o4.z; o[3] = o4.w;
  } else {
#pragma unroll
    for (int j = 0; j < kMapPerLane; ++j) {
      const bool in = b0 + j < num_blocks;
      w[j] = in ? write_slot[b0 + j] : -1;
      o[j] = in ? write_off[b0 + j] : 0;
    }
  }
  int rank = 0;                     // writers seen so far, in ballot order
  int mine = 0, my_b = 0, my_w = 0, my_o = 0;   // this warp's list
#pragma unroll
  for (int j = 0; j < kMapPerLane; ++j) {
    const bool live = w[j] >= 0 && w[j] < num_slots && o[j] >= 0 &&
                      o[j] < block_size;
    unsigned todo = __ballot_sync(0xffffffffu, live);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      if (rank++ % kScatterWarps != warp) continue;
      const int sw = __shfl_sync(0xffffffffu, w[j], src);
      const int so = __shfl_sync(0xffffffffu, o[j], src);
      if (lane == mine) {
        my_b = blockIdx.x * kMapPerCta + kMapPerLane * src + j;
        my_w = sw;
        my_o = so;
      }
      ++mine;
    }
  }
  for (int n = 0; n < mine; ++n)
    fn(__shfl_sync(0xffffffffu, my_b, n), __shfl_sync(0xffffffffu, my_w, n),
       __shfl_sync(0xffffffffu, my_o, n));
}

// scatter: for every writer (block b, slot w, offset off) the warp copies
// row w of k_rows (and v_rows) into row off of block b of k_pool (and
// v_pool; both null for a single pool), in units of T, kCopyUnroll units a
// lane a pass (2 KB in 16-byte units). The loads are unconditional (an
// index past the row reads its last unit again) so that every load of the
// pass, of both rows, is in flight before the first store; only the stores
// are predicated.
constexpr int kCopyUnroll = 4;

template <typename T, int NP>
__device__ __forceinline__ void copy_rows(T* const (&pools)[2],
                                          const T* const (&rows)[2],
                                          size_t dst, size_t src,
                                          int row_units, int lane) {
  for (int base = 0; base < row_units; base += 32 * kCopyUnroll) {
    T x[NP][kCopyUnroll];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u)
        x[p][u] = rows[p][src + min(base + u * 32 + lane, row_units - 1)];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int i = base + u * 32 + lane;
        if (i < row_units) pools[p][dst + i] = x[p][u];
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kScatterThreads)
scatter_kernel(T* k_pool, const T* k_rows, T* v_pool, const T* v_rows,
               const int* __restrict__ write_slot,
               const int* __restrict__ write_off, int num_blocks,
               int block_size, int row_units, int num_slots, bool vec_map) {
  const int lane = threadIdx.x & 31;
  T* const pools[2] = {k_pool, v_pool};
  const T* const rows[2] = {k_rows, v_rows};
  for_each_writer(write_slot, write_off, num_blocks, block_size, num_slots,
                  vec_map, [&](int b, int w, int off) {
    const size_t dst = ((size_t)b * block_size + off) * row_units;
    const size_t src = (size_t)w * row_units;
    if (v_pool != nullptr)
      copy_rows<T, 2>(pools, rows, dst, src, row_units, lane);
    else
      copy_rows<T, 1>(pools, rows, dst, src, row_units, lane);
  });
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

// the warp's max of a value >= +0 that is not NaN (a lane's absmax from
// fmaxf, which drops NaN): such floats order as their bit patterns do, so
// one integer max reduction (REDUX) gives the exact max
__device__ __forceinline__ float warp_absmax(float v) {
  return __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(v)));
}

// A row is read in units of VEC elements of R: 16 bytes (4 fp32 or 8
// bf16, one uint4 load, stored as VEC quantized bytes in one 4- or 8-byte
// store) where the sizes and pointers allow, else one element.
template <typename R, int VEC>
__device__ __forceinline__ void load_unit(float* x, const R* p) {
  if constexpr (VEC == 1) {
    x[0] = to_f(*p);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(R) == 4) {
        x[i] = __uint_as_float(w[i]);
      } else {                      // bf16 -> fp32 is exact: the high half
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

template <typename Q, int VEC>
__device__ __forceinline__ void store_unit(Q* p, const float* x, float inv) {
  if constexpr (VEC == 1) {
    *p = quantize<Q>(x[0] * inv);
  } else {
    uint32_t w[VEC / 4];
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      w[i] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[i] |= static_cast<uint32_t>(static_cast<uint8_t>(
                    quantize<Q>(x[4 * i + e] * inv))) << (8 * e);
    }
    if constexpr (VEC == 4)
      *reinterpret_cast<uint32_t*>(p) = w[0];
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// scatter_quant, for one writer: NP rows (K, then V) of slot w, UPL units
// a lane (unit lane + 32 k in x[p][k * VEC ..]; the loads are
// unconditional, an index past the row reading its last unit, and the
// values past it are zeroed after), every load of both rows in flight
// before either absmax is reduced; then each row quantized into row `row`
// of its pool, lane 0 writing its scale.
template <typename R, typename Q, int VEC, int UPL, int NP>
__device__ __forceinline__ void quant_rows(Q* const (&pools)[2],
                                           float* const (&scales)[2],
                                           const R* const (&rows)[2], int w,
                                           size_t row, int row_elems,
                                           float qmax, int lane) {
  const int n_units = row_elems / VEC;
  float x[NP][UPL * VEC];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int k = 0; k < UPL; ++k)
      load_unit<R, VEC>(&x[p][k * VEC],
                        rows[p] + (size_t)w * row_elems +
                            (size_t)min(lane + 32 * k, n_units - 1) * VEC);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < UPL; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (lane + 32 * k >= n_units) x[p][k * VEC + e] = 0.f;
        amax = fmaxf(amax, fabsf(x[p][k * VEC + e]));
      }
    const float scale = warp_absmax(amax) / qmax;
    const float inv = scale > 0.f ? 1.0f / fmaxf(scale, 1e-30f) : 0.f;
    Q* dst = pools[p] + row * row_elems;
#pragma unroll
    for (int k = 0; k < UPL; ++k)
      if (lane + 32 * k < n_units)
        store_unit<Q, VEC>(dst + (size_t)(lane + 32 * k) * VEC,
                           &x[p][k * VEC], inv);
    if (lane == 0) scales[p][row] = scale;
  }
}

// scatter_quant: the map walk of scatter_kernel; for every writer the warp
// quantizes slot w's K row (and V row) into (b, off) of the pools and
// their scales. Rows of at most 32 * UPL * VEC values.
template <typename R, typename Q, int VEC, int UPL>
__global__ void __launch_bounds__(kScatterThreads)
scatter_quant_kernel(Q* k_pool, float* k_scales, const R* k_rows, Q* v_pool,
                     float* v_scales, const R* v_rows,
                     const int* __restrict__ write_slot,
                     const int* __restrict__ write_off, int num_blocks,
                     int block_size, int row_elems, int num_slots, float qmax,
                     bool vec_map) {
  const int lane = threadIdx.x & 31;
  Q* const pools[2] = {k_pool, v_pool};
  float* const scales[2] = {k_scales, v_scales};
  const R* const rows[2] = {k_rows, v_rows};
  for_each_writer(write_slot, write_off, num_blocks, block_size, num_slots,
                  vec_map, [&](int b, int w, int off) {
    const size_t row = (size_t)b * block_size + off;
    if (v_pool != nullptr)
      quant_rows<R, Q, VEC, UPL, 2>(pools, scales, rows, w, row, row_elems,
                                    qmax, lane);
    else
      quant_rows<R, Q, VEC, UPL, 1>(pools, scales, rows, w, row, row_elems,
                                    qmax, lane);
  });
}

// scatter_quant for rows longer than the registers hold: pass 1 reduces
// each row's absmax over chunks of UPL units a lane (every load of the chunk
// of both rows in flight; an index past the row reads its last unit again,
// which a max ignores), pass 2 re-reads each chunk and quantizes it as
// quant_rows does.
template <typename R, typename Q, int VEC, int UPL, int NP>
__device__ __forceinline__ void quant_rows_wide(Q* const (&pools)[2],
                                                float* const (&scales)[2],
                                                const R* const (&rows)[2], int w,
                                                size_t row, int row_elems,
                                                float qmax, int lane) {
  const int n_units = row_elems / VEC;
  auto load_chunk = [&](int base, float (&x)[NP][UPL * VEC]) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int k = 0; k < UPL; ++k)
        load_unit<R, VEC>(&x[p][k * VEC],
                          rows[p] + (size_t)w * row_elems +
                              (size_t)min(base + lane + 32 * k, n_units - 1) * VEC);
  };
  float amax[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) amax[p] = 0.f;
  for (int base = 0; base < n_units; base += 32 * UPL) {
    float x[NP][UPL * VEC];
    load_chunk(base, x);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < UPL * VEC; ++i) amax[p] = fmaxf(amax[p], fabsf(x[p][i]));
  }
  float scale[NP], inv[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    scale[p] = warp_absmax(amax[p]) / qmax;
    inv[p] = scale[p] > 0.f ? 1.0f / fmaxf(scale[p], 1e-30f) : 0.f;
  }
  for (int base = 0; base < n_units; base += 32 * UPL) {
    float x[NP][UPL * VEC];
    load_chunk(base, x);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      Q* dst = pools[p] + row * row_elems;
#pragma unroll
      for (int k = 0; k < UPL; ++k) {
        const int u = base + lane + 32 * k;
        if (u < n_units)
          store_unit<Q, VEC>(dst + (size_t)u * VEC, &x[p][k * VEC], inv[p]);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int p = 0; p < NP; ++p) scales[p][row] = scale[p];
  }
}

template <typename R, typename Q, int VEC, int UPL>
__global__ void __launch_bounds__(kScatterThreads)
scatter_quant_wide_kernel(Q* k_pool, float* k_scales, const R* k_rows, Q* v_pool,
                          float* v_scales, const R* v_rows,
                          const int* __restrict__ write_slot,
                          const int* __restrict__ write_off, int num_blocks,
                          int block_size, int row_elems, int num_slots,
                          float qmax, bool vec_map) {
  const int lane = threadIdx.x & 31;
  Q* const pools[2] = {k_pool, v_pool};
  float* const scales[2] = {k_scales, v_scales};
  const R* const rows[2] = {k_rows, v_rows};
  for_each_writer(write_slot, write_off, num_blocks, block_size, num_slots,
                  vec_map, [&](int b, int w, int off) {
    const size_t row = (size_t)b * block_size + off;
    if (v_pool != nullptr)
      quant_rows_wide<R, Q, VEC, UPL, 2>(pools, scales, rows, w, row,
                                         row_elems, qmax, lane);
    else
      quant_rows_wide<R, Q, VEC, UPL, 1>(pools, scales, rows, w, row,
                                         row_elems, qmax, lane);
  });
}

struct QuantArgs {
  void* k_pool;
  float* k_scales;
  const void* k_rows;
  void* v_pool;
  float* v_scales;
  const void* v_rows;
  const int* ws;
  const int* wo;
  int nb, bs, row_elems, num_slots;
  float qmax;
  bool vec_map;
};

template <typename R, typename Q, int VEC, int UPL>
void launch_scatter_quant(const QuantArgs& a, cudaStream_t st) {
  scatter_quant_kernel<R, Q, VEC, UPL>
      <<<(a.nb + kMapPerCta - 1) / kMapPerCta, kScatterThreads, 0, st>>>(
          static_cast<Q*>(a.k_pool), a.k_scales,
          static_cast<const R*>(a.k_rows), static_cast<Q*>(a.v_pool),
          a.v_scales, static_cast<const R*>(a.v_rows), a.ws, a.wo, a.nb, a.bs,
          a.row_elems, a.num_slots, a.qmax, a.vec_map);
}

template <typename R, typename Q, int VEC, int UPL>
void launch_scatter_quant_wide(const QuantArgs& a, cudaStream_t st) {
  scatter_quant_wide_kernel<R, Q, VEC, UPL>
      <<<(a.nb + kMapPerCta - 1) / kMapPerCta, kScatterThreads, 0, st>>>(
          static_cast<Q*>(a.k_pool), a.k_scales,
          static_cast<const R*>(a.k_rows), static_cast<Q*>(a.v_pool),
          a.v_scales, static_cast<const R*>(a.v_rows), a.ws, a.wo, a.nb, a.bs,
          a.row_elems, a.num_slots, a.qmax, a.vec_map);
}

bool aligned(const void* p, size_t a) {
  return (reinterpret_cast<uintptr_t>(p) % a) == 0;
}

// the longest row one warp holds in registers (32 lanes x 64 values)
constexpr int kRegRow = 2048;

// 16-byte units where the row length and every pointer allow (UPL the
// smallest of 1, 2, 4, 8, 16 units a lane that holds the row), else one
// element a unit (8, 16, 32 or 64 a lane); rows over kRegRow values take
// the two-pass kernel in chunks of 4 units a lane (16 a lane one element a
// unit)
template <typename R, typename Q>
int scatter_quant_units(const QuantArgs& a, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(R);
  const bool vec = a.row_elems % kVec == 0 && aligned(a.k_rows, 16) &&
                   aligned(a.v_rows, 16) && aligned(a.k_pool, kVec) &&
                   aligned(a.v_pool, kVec);
  const int per_lane = vec ? (a.row_elems / kVec + 31) / 32
                           : (a.row_elems + 31) / 32;
  if (a.row_elems > kRegRow) {
    if (vec) launch_scatter_quant_wide<R, Q, kVec, 4>(a, st);
    else launch_scatter_quant_wide<R, Q, 1, 16>(a, st);
  } else if (vec) {
    if (per_lane <= 1) launch_scatter_quant<R, Q, kVec, 1>(a, st);
    else if (per_lane <= 2) launch_scatter_quant<R, Q, kVec, 2>(a, st);
    else if (per_lane <= 4) launch_scatter_quant<R, Q, kVec, 4>(a, st);
    else if (per_lane <= 8) launch_scatter_quant<R, Q, kVec, 8>(a, st);
    else launch_scatter_quant<R, Q, kVec, 16>(a, st);
  } else {
    if (per_lane <= 8) launch_scatter_quant<R, Q, 1, 8>(a, st);
    else if (per_lane <= 16) launch_scatter_quant<R, Q, 1, 16>(a, st);
    else if (per_lane <= 32) launch_scatter_quant<R, Q, 1, 32>(a, st);
    else launch_scatter_quant<R, Q, 1, 64>(a, st);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int scatter_quant_rows(int quant_dtype, QuantArgs& a, cudaStream_t st) {
  switch (quant_dtype) {
    case 0: a.qmax = 127.f; return scatter_quant_units<R, int8_t>(a, st);
    case 1: a.qmax = 448.f; return scatter_quant_units<R, __nv_fp8_storage_t>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// widest copy unit that divides the byte counts and every pointer's
// alignment (null pointers: no constraint)
int unit_bytes(long long bytes, const void* a, const void* b,
               const void* c = nullptr, const void* d = nullptr) {
  const int units[] = {16, 8, 4, 2, 1};
  for (int u : units)
    if (bytes % u == 0 && aligned(a, u) && aligned(b, u) && aligned(c, u) &&
        aligned(d, u))
      return u;
  return 1;
}

// the write maps are read as int4 when both lie on a 16-byte boundary
bool vec_maps(const int* ws, const int* wo) {
  return aligned(ws, 16) && aligned(wo, 16);
}

template <typename T>
void launch_scatter(void* k_pool, const void* k_rows, void* v_pool,
                    const void* v_rows, const int* ws, const int* wo, int nb,
                    int bs, long long row_bytes, int num_slots,
                    cudaStream_t st) {
  scatter_kernel<T><<<(nb + kMapPerCta - 1) / kMapPerCta, kScatterThreads, 0,
                      st>>>(
      static_cast<T*>(k_pool), static_cast<const T*>(k_rows),
      static_cast<T*>(v_pool), static_cast<const T*>(v_rows), ws, wo, nb, bs,
      (int)(row_bytes / sizeof(T)), num_slots, vec_maps(ws, wo));
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

// k_pool (NB, BS, row) in place, k_rows (S, row); v_pool / v_rows the same
// shapes for the V pool of the layer, or both null for a single pool;
// write_slot / write_off (NB,) i32.
int repro_paged_scatter(void* k_pool, const void* k_rows, void* v_pool,
                        const void* v_rows, const int* write_slot,
                        const int* write_off, int num_blocks, int block_size,
                        long long row_bytes, int num_slots, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ws = write_slot;
  const int* wo = write_off;
  switch (unit_bytes(row_bytes, k_pool, k_rows, v_pool, v_rows)) {
    case 16: launch_scatter<uint4>(k_pool, k_rows, v_pool, v_rows, ws, wo, num_blocks, block_size, row_bytes, num_slots, st); break;
    case 8: launch_scatter<uint2>(k_pool, k_rows, v_pool, v_rows, ws, wo, num_blocks, block_size, row_bytes, num_slots, st); break;
    case 4: launch_scatter<uint32_t>(k_pool, k_rows, v_pool, v_rows, ws, wo, num_blocks, block_size, row_bytes, num_slots, st); break;
    case 2: launch_scatter<uint16_t>(k_pool, k_rows, v_pool, v_rows, ws, wo, num_blocks, block_size, row_bytes, num_slots, st); break;
    default: launch_scatter<uint8_t>(k_pool, k_rows, v_pool, v_rows, ws, wo, num_blocks, block_size, row_bytes, num_slots, st); break;
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

// k_pool (NB, BS, row) int8 / e4m3 and k_scales (NB, BS) fp32 in place;
// k_rows (S, row) with row = KVh * hd values; v_pool, v_scales, v_rows the
// same for the layer's V pool, or all null for a single pool; row_dtype 0 =
// float32, 1 = bfloat16; quant_dtype 0 = int8, 1 = float8_e4m3fn.
int repro_paged_scatter_quant(void* k_pool, float* k_scales,
                              const void* k_rows, void* v_pool,
                              float* v_scales, const void* v_rows,
                              const int* write_slot, const int* write_off,
                              int num_blocks, int block_size, int row_elems,
                              int num_slots, int row_dtype, int quant_dtype,
                              void* stream) {
  if (row_elems <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  QuantArgs a{k_pool, k_scales, k_rows, v_pool, v_scales, v_rows,
              write_slot, write_off, num_blocks, block_size, row_elems,
              num_slots, 0.f, vec_maps(write_slot, write_off)};
  switch (row_dtype) {
    case 0: return scatter_quant_rows<float>(quant_dtype, a, st);
    case 1: return scatter_quant_rows<__nv_bfloat16>(quant_dtype, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
