// Paged KV-cache scatter and gather for the serving fleet (sm_90a).
//
// Replaces the TPU kernels of the reference's kernels/paged_cache.py:
//   repro_paged_scatter  <- paged_scatter (_scatter_kernel)
//   repro_paged_gather   <- paged_gather  (_gather_kernel)
//
// Pool layout (NB, BS, KVh, hd), row-major; one "row" is one token position
// across all KV heads (KVh * hd elements). Block 0 is the null block: never
// written, dead table entries point at it.
//
// What bounds them on an H100: bytes. Neither does arithmetic; each moves
// its payload once (scatter: one row per appending slot, ~KVh*hd*2 B = 1 KB
// at the main-path shape; gather: S*MB blocks of BS rows). The design does
// the least the bound allows: one CTA per pool block (scatter) or per
// (slot, table entry) (gather), each copying its payload with 16-byte
// vector loads and stores when the sizes and pointers allow it (they do for
// bf16/fp32 rows whose byte width is a multiple of 16), and nothing else.
// The scatter's block->writer map makes every pool block written by at most
// one CTA, so no atomics. Both are bit-exact copies, so the element type
// does not matter: the kernels copy bytes in units of T.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

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

// gather: CTA (m, s) copies pool block table[s, m] into out[s, m], or
// writes zeros when m >= n_live[s] (the dead block is never read).
template <typename T>
__global__ void gather_kernel(const T* __restrict__ pool,
                              const int* __restrict__ table,
                              const int* __restrict__ n_live,
                              T* __restrict__ out, int max_blocks,
                              int block_units, int num_blocks) {
  const int m = blockIdx.x;
  const int s = blockIdx.y;
  T* dst = out + ((size_t)s * max_blocks + m) * block_units;
  const int blk = table[s * max_blocks + m];
  if (m < n_live[s] && blk >= 0 && blk < num_blocks) {
    const T* src = pool + (size_t)blk * block_units;
    for (int i = threadIdx.x; i < block_units; i += blockDim.x) dst[i] = src[i];
  } else {
    const T zero{};
    for (int i = threadIdx.x; i < block_units; i += blockDim.x) dst[i] = zero;
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
  dim3 grid(max_blocks, num_slots);
  gather_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(pool), table, n_live, static_cast<T*>(out),
      max_blocks, (int)(block_bytes / sizeof(T)), num_blocks);
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

}  // extern "C"
