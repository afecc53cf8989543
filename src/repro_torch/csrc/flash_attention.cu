// Forward GQA flash attention, causal and/or sliding window (sm_90a).
//
// Replaces the TPU kernel of the reference's kernels/flash_attention.py:
//   repro_flash_attention <- flash_attention (_flash_kernel)
//
// Inputs in the reference's layout, read in place (no transpose copy):
// q (B, S, H, hd), k and v (B, T, KVh, hd), contiguous, one dtype (fp32
// or bf16); out (B, S, H, hd) in q's dtype. Query head h reads KV head
// h / (H / KVh). hd is a template parameter (16, 32, 64 or 128).
//
// Semantics, _flash_kernel's: fp32 scores, masks on raw indices: causal
// keeps col <= row even when T != S; window > 0 keeps row - col < window
// whether or not the call is causal. A masked score is NEG = -1e30, so a
// row masked in every column averages v over all T columns, as the Pallas
// kernel does; a column past T does not exist and scores -inf (weight
// exactly 0). The state is the fp32 (m, l, acc) of the online softmax:
// m_new = max(m, rowmax(s)), alpha = exp(m - m_new), p = exp(s - m_new),
// l = l alpha + sum p, acc = acc alpha + p v; out = acc / max(l, 1e-30).
// Every kernel walks the columns [c_lo, c_hi) of its rows: tiles masked
// for every row of the CTA are skipped (causal: past the last row; window:
// before the first row's window), which leaves every row's result as it
// was, unless some row of the CTA is masked in every column (only with a
// window and S > T): then the CTA walks all T columns, so that row's
// average comes out as the Pallas kernel's. Only tiles that cross the
// diagonal, a window edge or T apply masks element by element.
//
// What bounds it on an H100: operations at the long shapes. A bf16 causal
// prefill of qwen2-7b (S = T = 4096, H = 28, hd = 128) needs 1.2e11 FLOP
// for its unmasked half, 0.12 ms at the bf16 tensor-core peak (989
// TFLOP/s), against 67 MB of q, k, v and out (0.020 ms at 3.35 TB/s).
//
// fp32 inputs: flash_kernel, fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak), q * scale in fp32 before the dot, as _flash_kernel. One CTA of
// 256 threads per (64-row q tile, head, batch) loops over 64-column K/V
// tiles staged in shared memory (K transposed); thread (ty, tx) of a
// 16 x 16 grid owns 4 rows' 4 x 4 scores and accumulator columns
// tx + 16 k; row max and sum reduce over 16 lanes by warp shuffles. It is
// the fp32 parity path and makes no claim to speed.
//
// bf16 inputs run on the tensor cores, with this arithmetic:
//  * S = q k^T from the unscaled bf16 q and k with fp32 accumulation (a
//    bf16 x bf16 product is exact in fp32), then s = S * scale in fp32.
//    _flash_kernel scales q in fp32 before the dot; moving the scale after
//    the dot changes only the fp32 rounding order, whereas rounding q *
//    scale to bf16 would change the inputs.
//  * P enters P V as two bf16 operands, p_hi = bf16(p) and p_lo =
//    bf16(p - p_hi), both products accumulated into one fp32 accumulator:
//    p_hi + p_lo carries p to ~2^-17 relative, so the output is the fp32
//    plain version's up to the rounding order. A single bf16 P (8 bits)
//    moves elements by many bf16 ulps of their own (an emulation on the
//    CPU, tests/test_torch_flash_rounding.py, pins both). The split costs
//    1.5x the work bound's FLOP: the P V half runs twice.
//  * out = acc / max(l, 1e-30), rounded once to bf16.
//
// bf16, hd 64 and 128: flash_wgmma_kernel,
// FlashAttention-3's shape. One CTA of 3 warpgroups per (128-row q tile,
// head, batch): warpgroup 0 is the producer (setmaxnreg down to 24
// registers; one thread issues TMA loads), warpgroups 1 and 2 are
// consumers (setmaxnreg up to 240), each owning 64 q rows. TMA brings the
// q tile once and 128-column K and V tiles into a 2-stage shared-memory
// ring with 128-byte swizzle, signalled by mbarriers: full per stage for K
// and for V, and empty per stage for K (released once its scores are
// computed) and for V (once its P V is). The tensor maps are rank 4, (hd,
// heads, rows, B), so a tile past T (or S) reads zeros and never the next
// batch's rows; columns >= T are still set to -inf. A consumer runs
// S = Q K^T as wgmma.m64n128k16 with both operands in shared memory
// (K-major), the softmax in registers (a row's max and sum reduce over the
// 4 lanes that share it in the accumulator layout; interior tiles only
// scale, tiles on the diagonal, a window edge or T mask element by
// element), and P V as wgmma.m64n{hd}k16 with p_hi and p_lo as register A
// operands and V read in its natural (T, hd) layout through the
// B-transpose bit. The consumers take turns (named barriers) to issue one
// tile's P V together with the next tile's scores, so one consumer's
// softmax runs while the other's GEMMs hold the tensor cores; the last
// tile is peeled so that no wgmma sits on a divergent path, which ptxas
// would serialize. Shared memory at hd 128: q 32 KB + 2 x (K 32 KB + V
// 32 KB).
//
// bf16, hd 16 and 32 (a 32- or 64-byte row takes no 128-byte swizzle):
// flash_mma_kernel, FlashAttention-2's shape: one CTA of 8 warps per
// (128-row q tile, head, batch), 16 rows per warp, mma.sync.m16n8k16 bf16
// with fragments from ldmatrix (.trans for V), 64-column K/V tiles
// double-buffered by cp.async in rows padded by 16 bytes against bank
// conflicts.
//
// TMA and cp.async read 16-byte units, so bf16 q, k and v must start on a
// 16-byte boundary (the Python wrapper copies any that does not); the
// entry point refuses them otherwise.
//
// The grid runs (head, q tile, batch) with the heads fastest, so the
// H / KVh heads that share a KV head run together (L2 reuse), and the
// last q tiles, the longest under a causal mask, first.
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled, a
// driver API function fetched at run time through
// cudaGetDriverEntryPoint(ByVersion), so the library links only the CUDA
// runtime. The entry point launches on the caller's stream and returns
// cudaGetLastError() (or cudaErrorInvalidValue when a tensor map cannot be
// encoded) so the Python wrapper can raise on a refused launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;     // q rows per CTA
constexpr int BK = 64;     // K/V columns per tile
constexpr int LD = 68;     // row stride (floats) of the transposed Q, K and of P
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int HD>
__host__ __device__ constexpr size_t smem_floats() {
  return (size_t)HD * LD      // Q^T (scaled)
         + (size_t)HD * LD    // K^T tile
         + (size_t)BK * HD    // V tile
         + (size_t)BQ * LD;   // P tile
}

// max / sum over the 16 threads of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int T_len,
             int H, int KVh, int causal, int window, float scale) {
  constexpr int CPT = HD / 16;  // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;                    // [HD][LD]
  float* kt = qt + (size_t)HD * LD;    // [HD][LD]
  float* vs = kt + (size_t)HD * LD;    // [BK][HD]
  float* ps = vs + (size_t)BK * HD;    // [BQ][LD]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int r0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVh);

  for (int i = tid; i < BQ * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    const int row = r0 + r;
    qt[d * LD + r] = row < S
        ? to_f(q[(((size_t)b * S + row) * H + h) * HD + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // columns to walk: all T unless every row of the CTA keeps a column
  const int r_last = min(r0 + BQ, S) - 1;
  const bool all_rows_live = window <= 0 || r_last - window + 1 <= T_len - 1;
  int c_lo = 0, c_hi = T_len;
  if (all_rows_live) {
    if (causal) c_hi = min(T_len, r_last + 1);
    if (window > 0) c_lo = max(0, r0 - window + 1);
  }
  c_lo = (c_lo / BK) * BK;

  for (int c0 = c_lo; c0 < c_hi; c0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int c = i / HD, d = i - c * HD;
      const int col = c0 + c;
      float kv = 0.f, vv = 0.f;
      if (col < T_len) {
        const size_t src = (((size_t)b * T_len + col) * KVh + kvh) * HD + d;
        kv = to_f(k[src]);
        vv = to_f(v[src]);
      }
      kt[d * LD + c] = kv;
      vs[c * HD + d] = vv;
    }
    __syncthreads();

    // scores of rows 4 ty + i, columns 4 tx + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LD + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * LD + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 4 * ty + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + 4 * tx + j;
        if (col >= T_len) {
          s[i][j] = -INFINITY;
        } else if ((causal && col > row) || (window > 0 && row - col >= window)) {
          s[i][j] = kNeg;
        }
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mt));
      const float alpha = expf(m[i] - m_new);
      float p[4], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(s[i][j] - m_new);
        sum += p[j];
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(ps + (4 * ty + i) * LD + 4 * tx) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    const int n_cols = min(BK, T_len - c0);
    for (int c = 0; c < n_cols; ++c) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * LD + c];
#pragma unroll
      for (int e = 0; e < CPT; ++e) vv[e] = vs[c * HD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < CPT; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + (((size_t)b * S + row) * H + h) * HD;
#pragma unroll
    for (int e = 0; e < CPT; ++e) o[tx + 16 * e] = from_f<T>(acc[i][e] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_len, int H, int KVh, int causal, int window,
           float scale, cudaStream_t st) {
  const size_t bytes = smem_floats<HD>() * sizeof(float);
  auto kern = flash_kernel<T, HD>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_len, H, KVh,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}


int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              int B, int S, int T_len, int H, int KVh, int causal, int window,
              float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<float, 16>(q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
    case 32: return launch<float, 32>(q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
    case 64: return launch<float, 64>(q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
    case 128: return launch<float, 128>(q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

typedef __nv_bfloat16 bf16;

// columns [c_lo, c_hi) that the rows [r0, r0 + rows) walk (see the header);
// c_lo rounds down to a tile of bk columns
__device__ __forceinline__ void column_range(int r0, int rows, int S, int T_len,
                                             int causal, int window, int bk,
                                             int& c_lo, int& c_hi) {
  const int r_last = min(r0 + rows, S) - 1;
  const bool all_rows_live = window <= 0 || r_last - window + 1 <= T_len - 1;
  c_lo = 0;
  c_hi = T_len;
  if (all_rows_live) {
    if (causal) c_hi = min(T_len, r_last + 1);
    if (window > 0) c_lo = max(0, r0 - window + 1);
  }
  c_lo = (c_lo / bk) * bk;
}

// whether the tile [c0, c0 + bk) needs masks for some row of [r0, r_last]
__device__ __forceinline__ bool edge_tile(int c0, int bk, int r0, int r_last,
                                          int T_len, int causal, int window) {
  return c0 + bk > T_len || (causal && c0 + bk - 1 > r0) ||
         (window > 0 && r_last - c0 >= window);
}

// the scaled, masked score of (row, col)
__device__ __forceinline__ float masked_score(float acc, float scale, int row,
                                              int col, int T_len, int causal,
                                              int window) {
  const float x = acc * scale;
  if (col >= T_len) return -INFINITY;
  if ((causal && col > row) || (window > 0 && row - col >= window)) return kNeg;
  return x;
}

// max / sum over the 4 lanes that hold one row of an mma accumulator
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// p_hi = bf16(p), p_lo = bf16(p - p_hi) for two neighbouring columns (the
// first in the low half); p - p_hi is exact in fp32
__device__ __forceinline__ void split_p(float a, float b, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// the scores s[4 j + e] of two rows of an mma accumulator (e < 2: row_a,
// e >= 2: row_a + 8; columns c0 + 8 j + 2 t4 + (e & 1)), 2N columns from
// c0: scaled, masked (only on a tile that needs masks), then one online
// softmax step. Updates m and l (this lane's partial row sum), returns
// alpha, the accumulator's factor; s becomes p
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale, int c0, int row_a,
                                             int t4, int r0, int r_last, int T_len,
                                             int causal, int window) {
  if (edge_tile(c0, 2 * N, r0, r_last, T_len, causal, window)) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      s[i] = masked_score(s[i], scale, row_a + 8 * ((i >> 1) & 1),
                          c0 + 8 * (i >> 2) + 2 * t4 + (i & 1), T_len, causal, window);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] *= scale;
  }
  float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mt[r]));
    alpha[r] = expf(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = expf(s[i] - m[(i >> 1) & 1]);
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// writes rows row_a and row_a + 8 (rows >= S are not stored) of an mma
// accumulator o[4 j + e] (columns 8 j + 2 t4 + (e & 1)) as bf16
template <int N>
__device__ __forceinline__ void store_rows(const float (&o)[N], float (&l)[2],
                                           bf16* out, int row_a, int S,
                                           size_t row_stride, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);
    if (row >= S) continue;
    bf16* o_row = out + (size_t)row * row_stride + 2 * t4;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// bf16 on mma.sync (hd 16 and 32)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int BQ = 16 * kWarps;  // q rows per CTA, 16 per warp
constexpr int BK = 64;           // K/V columns per tile

template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(BQ + 4 * BK) * (HD + 8) * sizeof(bf16);  // q, 2 x (K, V)
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [first, first + ROWS) of a (rows, hd) matrix with row stride
// `stride` into shared memory rows of HD + 8; rows >= limit are zeros
template <int HD, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int first,
                                           int limit, size_t stride) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += kThreads) {
    const int r = i / CPR, c = i - r * CPR;
    const bool ok = first + r < limit;
    bf16* d = dst + r * (HD + 8) + c * 8;
    const bf16* s = src + (size_t)(ok ? first + r : 0) * stride + c * 8;
    cp_async16(smem_u32(d), s, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                 int T_len, int H, int KVh, int causal, int window, float scale) {
  constexpr int LDS = HD + 8;   // shared row stride: rows 16 bytes apart in banks
  constexpr int NT = BK / 8;    // score n-tiles per warp
  constexpr int KS = HD / 16;   // k-steps of q k^T
  extern __shared__ uint4 tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* ks = qs + BQ * LDS;       // [2][BK][LDS]
  bf16* vs = ks + 2 * BK * LDS;   // [2][BK][LDS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVh);
  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KVh * HD;
  const bf16* qb = q + (size_t)b * S * q_stride + (size_t)h * HD;
  const bf16* kb = k + (size_t)b * T_len * kv_stride + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * T_len * kv_stride + (size_t)kvh * HD;

  int c_lo, c_hi;
  column_range(r0, BQ, S, T_len, causal, window, BK, c_lo, c_hi);
  const int r_last = min(r0 + BQ, S) - 1;
  const int n_tiles = (c_hi - c_lo + BK - 1) / BK;

  stage_rows<HD, BQ>(qs, qb, r0, S, q_stride);
  if (n_tiles > 0) {
    stage_rows<HD, BK>(ks, kb, c_lo, T_len, kv_stride);
    stage_rows<HD, BK>(vs, vb, c_lo, T_len, kv_stride);
  }
  cp_async_commit();

  const int row_a = r0 + 16 * warp + g;  // this lane's rows: row_a, row_a + 8
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  uint32_t qf[KS][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int c0 = c_lo + it * BK;
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      stage_rows<HD, BK>(ks + (st ^ 1) * BK * LDS, kb, c0 + BK, T_len, kv_stride);
      stage_rows<HD, BK>(vs + (st ^ 1) * BK * LDS, vb, c0 + BK, T_len, kv_stride);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(smem_u32(qs + (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                         kk * 16 + (lane >> 4) * 8), qf[kk]);
    }

    // s = q k^T: n-tile j holds columns c0 + 8 j + 2 t4 + (e & 1)
    float s[4 * NT];
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) s[i] = 0.f;
    const bf16* kst = ks + st * BK * LDS;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kf[4];
        ldsm_x4(smem_u32(kst + (8 * j + (lane & 7) + (lane >> 4) * 8) * LDS +
                         kk * 16 + ((lane >> 3) & 1) * 8), kf);
        mma(s + 4 * j, qf[kk], kf[0], kf[1]);
        mma(s + 4 * j + 4, qf[kk], kf[2], kf[3]);
      }
    }

    float alpha[2];
    softmax_tile(s, m, l, alpha, scale, c0, row_a, t4, r0, r_last, T_len, causal,
                 window);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // o += p_hi v + p_lo v
    const bf16* vst = vs + st * BK * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_p(s[8 * kk + 0], s[8 * kk + 1], ph[0], pl[0]);
      split_p(s[8 * kk + 2], s[8 * kk + 3], ph[1], pl[1]);
      split_p(s[8 * kk + 4], s[8 * kk + 5], ph[2], pl[2]);
      split_p(s[8 * kk + 6], s[8 * kk + 7], ph[3], pl[3]);
#pragma unroll
      for (int dn = 0; dn < HD / 8; dn += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(smem_u32(vst + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                               dn * 8 + (lane >> 4) * 8), vf);
        mma(o + 4 * dn, ph, vf[0], vf[1]);
        mma(o + 4 * dn, pl, vf[0], vf[1]);
        mma(o + 4 * dn + 4, ph, vf[2], vf[3]);
        mma(o + 4 * dn + 4, pl, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  store_rows(o, l, out + (size_t)b * S * q_stride + (size_t)h * HD, row_a, S,
             q_stride, t4);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int T_len, int H, int KVh, int causal, int window, float scale,
           cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<HD>();
  auto kern = flash_mma_kernel<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, (S + BQ - 1) / BQ, B);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, T_len, H, KVh,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bf16 on wgmma, fed by TMA (hd 64 and 128)
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int BQ = 128;        // q rows per CTA, 64 per consumer
constexpr int BK = 128;        // K/V columns per stage
constexpr int kRowBytes = 128; // one swizzled row: 64 bf16

// shared memory, 1024-byte aligned: q as hd/64 chunks of BQ 128-byte rows,
// then 2 stages of K and 2 of V as hd/64 chunks of BK rows, then 9 barriers
template <int HD>
struct Smem {
  static constexpr int q_bytes = BQ * HD * 2;
  static constexpr int kv_bytes = BK * HD * 2;
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + 2 * kv_bytes;
  static constexpr int bar_off = v_off + 2 * kv_bytes;
  static constexpr int bytes = bar_off + 128 + 1024;  // + slack to align the base
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// TMA: the box at coordinates (d, head, row, batch) of a rank-4 map
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(bar)), "r"(d), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (K-major: lbo unused, sbo = 8 rows; N-major B:
// lbo = the next 64 columns of N, sbo = the next 8 rows of K)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
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
// named barriers 1 and 2 between the two consumer warpgroups (256 threads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the wgmma fence, commit and wait above
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the same for register A operands: keeps them live and unchanged until a
// wait has retired the wgmma that reads them
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D (64 x 128, fp32) {+}= A (64 x 16, smem, K-major) * B (128 x 16, smem, K-major)^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n "
      : "+f"(d[0]),
        "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]),
        "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),
        "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]),
        "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
        "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, fp32) += A (64 x 16, registers) * B (16 x 128, smem, N-major: transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, "
      "1;\n}\n "
      : "+f"(d[0]),
        "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]),
        "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]),
        "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]),
        "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
        "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, smem, N-major: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n "
      : "+f"(d[0]),
        "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]),
        "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}

// s = q k^T for one K stage: hd / 16 k-steps of 32 bytes along a swizzled
// row, the next 64-column chunk after 4; issued and committed, not waited
template <int HD>
__device__ __forceinline__ void issue_scores(float (&s)[BK / 2], uint32_t q_addr,
                                             uint32_t k_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss_n128(s, desc_sw128(q_addr + (kk >> 2) * BQ * kRowBytes + off, 16, 1024),
                  desc_sw128(k_addr + (kk >> 2) * BK * kRowBytes + off, 16, 1024),
                  kk > 0);
  }
  wgmma_commit();
}

// o += p_hi v + p_lo v for one V stage: BK / 16 k-steps of 16 V rows
// (2 KB); issued and committed, not waited
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&ph)[BK / 16][4],
                                         const uint32_t (&pl)[BK / 16][4],
                                         uint32_t v_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = desc_sw128(v_addr + kk * 16 * kRowBytes, BK * kRowBytes, 1024);
    wgmma_pv<HD>(o, ph[kk], dv);
    wgmma_pv<HD>(o, pl[kk], dv);
  }
  wgmma_commit();
}

// p (the accumulator layout of s) as the register A operands of P V: k-step
// kk takes columns 16 kk .. 16 kk + 15, i.e. n-tiles 2 kk and 2 kk + 1
__device__ __forceinline__ void split_tile(const float (&s)[BK / 2],
                                           uint32_t (&ph)[BK / 16][4],
                                           uint32_t (&pl)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a)
      split_p(s[8 * kk + 2 * a], s[8 * kk + 2 * a + 1], ph[kk][a], pl[kk][a]);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ out, int S, int T_len, int H, int KVh,
                   int causal, int window, float scale) {
  using L = Smem<HD>;
  constexpr int kChunks = HD / 64;  // 128-byte swizzled column chunks
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;   // [2] per stage: K landed
  uint64_t* v_full = bars + 3;   // [2] V landed
  uint64_t* k_empty = bars + 5;  // [2] every consumer thread read K
  uint64_t* v_empty = bars + 7;  // [2] every consumer thread read V

  const int h = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVh);
  int c_lo, c_hi;
  column_range(r0, BQ, S, T_len, causal, window, BK, c_lo, c_hi);
  const int r_last = min(r0 + BQ, S) - 1;
  const int n_tiles = (c_hi - c_lo + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(v_full + i, 1);
      mbar_init(k_empty + i, 256);
      mbar_init(v_empty + i, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgroup = threadIdx.x / 128;
  if (wgroup == 0) {
    // producer: q once, then K and V tiles into the 2-stage ring; K of a
    // stage is refilled once its scores are computed, V once its P V is
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::q_bytes);
      for (int ch = 0; ch < kChunks; ++ch)
        tma_load(smem + ch * BQ * kRowBytes, &tq, q_full, 64 * ch, h, r0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1, parity = ((it >> 1) - 1) & 1;
        const int c0 = c_lo + it * BK;
        uint8_t* kd = smem + L::k_off + st * L::kv_bytes;
        uint8_t* vd = smem + L::v_off + st * L::kv_bytes;
        if (it >= 2) mbar_wait(k_empty + st, parity);
        mbar_expect_tx(k_full + st, L::kv_bytes);
        for (int ch = 0; ch < kChunks; ++ch)
          tma_load(kd + ch * BK * kRowBytes, &tk, k_full + st, 64 * ch, kvh, c0, b);
        if (it >= 2) mbar_wait(v_empty + st, parity);
        mbar_expect_tx(v_full + st, L::kv_bytes);
        for (int ch = 0; ch < kChunks; ++ch)
          tma_load(vd + ch * BK * kRowBytes, &tv, v_full + st, 64 * ch, kvh, c0, b);
      }
    }
  } else {
    // consumers, taking turns (named barriers 1 and 2) to issue their
    // GEMMs: one turn issues P V of tile it and the scores of tile it + 1,
    // and while they run on the tensor cores the other consumer's softmax
    // runs on its warps
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wgroup - 1;             // 64-row half of the q tile
    const int tw = threadIdx.x - 128 * wgroup;
    const int lane = tw & 31, t4 = lane & 3;
    const int row_a = r0 + 64 * cw + 16 * (tw >> 5) + (lane >> 2);  // and row_a + 8
    const uint32_t q_addr = smem_u32(smem) + cw * 64 * kRowBytes;
    const uint32_t k_addr = smem_u32(smem + L::k_off);
    const uint32_t v_addr = smem_u32(smem + L::v_off);
    const int my_turn = 1 + cw, other_turn = 2 - cw;

    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, alpha[2];
    float o[HD / 2], s[BK / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    uint32_t ph[BK / 16][4], pl[BK / 16][4];

    // n_tiles + 1 turns each (n_tiles >= 1: the columns [c_lo, c_hi) are
    // never empty), consumer 0 first: the scores of tile 0, one turn per
    // tile; consumer 1 hands back every turn but its last. The last tile
    // is peeled so that no wgmma sits on a divergent path (ptxas would
    // serialize them)
    if (cw == 1) named_arrive(1);
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    named_sync(my_turn);
    pin(s);
    issue_scores<HD>(s, q_addr, k_addr);
    named_arrive(other_turn);
    wgmma_wait<0>();
    pin(s);
    mbar_arrive(k_empty);
    softmax_tile(s, m, l, alpha, scale, c_lo, row_a, t4, r0, r_last, T_len,
                 causal, window);
    split_tile(s, ph, pl);
    int it = 0;
    for (; it + 1 < n_tiles; ++it) {
      const int st = it & 1;
      mbar_wait(v_full + st, (it >> 1) & 1);
      mbar_wait(k_full + (st ^ 1), ((it + 1) >> 1) & 1);
      named_sync(my_turn);
      pin(s);
      issue_scores<HD>(s, q_addr, k_addr + (st ^ 1) * L::kv_bytes);
      pin(o);
      issue_pv<HD>(o, ph, pl, v_addr + st * L::kv_bytes);
      named_arrive(other_turn);
      wgmma_wait<1>();
      pin(s);
      mbar_arrive(k_empty + (st ^ 1));
      softmax_tile(s, m, l, alpha, scale, c_lo + (it + 1) * BK, row_a, t4, r0,
                   r_last, T_len, causal, window);
      wgmma_wait<0>();
      pin(o);
      pin(ph);
      pin(pl);
      mbar_arrive(v_empty + st);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      split_tile(s, ph, pl);
    }
    mbar_wait(v_full + (it & 1), (it >> 1) & 1);
    named_sync(my_turn);
    pin(o);
    issue_pv<HD>(o, ph, pl, v_addr + (it & 1) * L::kv_bytes);
    if (cw == 0) named_arrive(other_turn);
    wgmma_wait<0>();
    pin(o);
    store_rows(o, l, out + (size_t)b * S * H * HD + (size_t)h * HD, row_a, S,
               (size_t)H * HD, t4);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// rank-4 map (hd, heads, rows, batch) of a (batch, rows, heads, hd) bf16
// tensor; boxes of 64 x 1 x box_rows x 1, 128-byte swizzle, zeros outside
bool make_map(CUtensorMap* map, const void* base, int hd, int heads, int rows,
              int batch, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int T_len, int H, int KVh, int causal, int window, float scale,
           cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, HD, H, S, B, BQ) || !make_map(&tk, k, HD, KVh, T_len, B, BK) ||
      !make_map(&tv, v, HD, KVh, T_len, B, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = Smem<HD>::bytes;
  auto kern = flash_wgmma_kernel<HD>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H, (S + BQ - 1) / BQ, B);
  kern<<<grid, kThreads, bytes, st>>>(tq, tk, tv, static_cast<bf16*>(out), S, T_len,
                                      H, KVh, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int launch_bf16(int hd, const void* q, const void* k, const void* v, void* out,
                int B, int S, int T_len, int H, int KVh, int causal, int window,
                float scale, cudaStream_t st) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (hd) {
    case 16: return tc::launch<16>(q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
    case 32: return tc::launch<32>(q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
    case 64: return wg::launch<64>(q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
    case 128: return wg::launch<128>(q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and out share one).
// scale is hd^-0.5, rounded to fp32 by the caller.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int B, int S, int T_len, int H, int KVh,
                          int hd, int causal, int window, float scale,
                          int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (T_len <= 0 || KVh <= 0 || H % KVh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_hd(hd, q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
    case 1: return launch_bf16(hd, q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
