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
// Arithmetic, _flash_kernel's: q * scale in fp32 before the dot (scale =
// hd^-0.5), fp32 scores, masks on raw indices: causal keeps col <= row
// even when T != S; window > 0 keeps row - col < window whether or not the
// call is causal. A masked score is NEG = -1e30, so a row masked in every
// column averages v over all T columns, as the Pallas kernel does; a column
// past T does not exist and scores -inf (weight exactly 0). The state is
// the fp32 (m, l, acc) of the online softmax: m_new = max(m, rowmax(s)),
// alpha = exp(m - m_new), p = exp(s - m_new), l = l alpha + sum p,
// acc = acc alpha + p v; out = acc / max(l, 1e-30).
//
// Design. One CTA of 256 threads per (64-row q tile, head, batch). The TPU
// kernel's sequential KV grid axis becomes a loop inside the CTA over
// 64-column K/V tiles staged in shared memory (K transposed, so each
// thread reads a 4-column float4 of it per step of the dot). Thread
// (ty, tx) of a 16 x 16 grid owns rows 4 ty .. 4 ty + 3 of the tile: their
// 4 x 4 scores at columns 4 tx .. 4 tx + 3 and their accumulator columns
// tx + 16 k. Row max and row sum reduce over the 16 threads of a row group
// with warp shuffles. Tiles that are masked for every row of the CTA are
// skipped (causal: past the last row; window: before the first row's
// window), which leaves every row's result as it was, unless some row of
// the CTA is masked in every column (only with a window and S > T): then
// the CTA walks all T columns, so that row's average comes out as the
// Pallas kernel's.
//
// What bounds it on an H100: operations at the long shapes. A bf16 causal
// prefill of qwen2-7b (S = T = 4096, H = 28, hd = 128) needs 1.2e11 FLOP
// for its unmasked half, 0.12 ms at the bf16 tensor-core peak, against
// 67 MB of q, k, v and out (0.020 ms). This kernel computes in fp32 on
// the CUDA cores (67 TFLOP/s peak), about the rate of its shared-memory
// loads, so it cannot approach the bf16 bound; it keeps the reference's
// fp32 arithmetic. Tensor cores (mma.sync / wgmma on bf16 tiles, with q
// scaled in fp32 first) and a TMA-fed pipeline are the redesign.
//
// The entry point launches on the caller's stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;     // q rows per CTA
constexpr int BK = 64;     // K/V columns per tile
constexpr int LD = 68;     // row stride (floats) of the transposed Q, K and of P
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

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

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              int B, int S, int T_len, int H, int KVh, int causal, int window,
              float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
    case 32: return launch<T, 32>(q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
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
    case 0: return launch_hd<float>(hd, q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
    case 1: return launch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, T_len, H, KVh, causal, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
