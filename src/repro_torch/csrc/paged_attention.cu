// One-token GQA decode attention straight off the paged KV pool (sm_90a).
//
// Replaces the TPU kernel of the reference's kernels/paged_attention.py:
//   repro_paged_attention_decode <- paged_attention_decode (_decode_kernel /
//                                   _decode_body), non-quantized pools.
//
// Inputs: q (S, H, hd) in fp32/bf16/fp16; k_pool, v_pool (NB, BS, KVh, hd)
// in fp32/bf16/fp16; table (S, MB) int32; lengths (S,) int32 = each slot's
// pre-step context length == the new token's position (keys at positions
// <= lengths[s] are valid; the new token's K/V was scattered before this
// launch, on the same stream). Output (S, H, hd) in q's dtype.
//
// Design. Two kernels. The partial kernel runs one CTA per (KV head, slot,
// split), holding the G = H / KVh query heads of that group, so each live
// K/V tile is read from device memory once for all G heads. The TPU
// kernel's sequential MB grid axis becomes a loop inside the CTA over the
// split's blocks [split * bps, min((split + 1) * bps, n_live)), with
// n_live = min((len + BS) / BS, MB); it reads table[s, m] itself (no scalar
// prefetch). Splits past n_live exit at once. Per block it stages the K and
// V tiles (BS x hd, converted to fp32) in shared memory, then one thread
// per (head, key) computes a score, one thread per head updates the
// softmax state, and one thread per (head, lane of hd) updates the
// accumulator. The state is fp32 and follows the reference's _decode_body:
// q * hd^-0.5 in fp32, scores masked to NEG = -1e30 for pos > len, running
// max m, denominator l and accumulator acc with alpha = exp(m_prev - m_new).
// Each split writes (m, l, acc) to fp32 scratch. The combine kernel merges
// the live splits of a slot: M = max m_i, L = sum l_i exp(m_i - M),
// A = sum acc_i exp(m_i - M), out = A / max(L, 1e-30). With one live split
// this is acc / max(l, 1e-30), exactly the reference's finalize.
// An inactive slot (length 0, all-zero table row) reads null block 0 once:
// its only valid key is the zero row, so its output is exactly 0.
//
// What bounds it on an H100: bytes. At the main-path shape (qwen2-7b:
// H = 28, KVh = 4, hd = 128, BS = 16, bf16 pools) a slot at context length
// len needs (len + 1) * KVh * hd * 2 B * 2 (K and V) = 2 KB per position,
// against 4 * H * hd = 14 KFLOP of fp32 work per position: ~7 FLOP/B, far
// below the ~20 FLOP/B at which the H100's fp32 cores (67 TFLOP/s) would
// overtake its 3.35 TB/s. The kernel is latency-bound instead: a CTA walks
// its blocks one after another with four barriers per block. Splitting
// the blocks over CTAs (bps = 4 blocks a split) bounds that walk and puts
// S * KVh * ceil(MB / 4) CTAs (576 at the main path) on the 132 SMs, for
// 2 * S * KVh * ceil(MB / 4) * G * (hd + 2) * 4 B of fp32 scratch traffic
// (~2 MB there). No wgmma and no TMA yet; staging the tiles with cp.async
// and spreading each score over a warp are the next steps.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// shared-memory floats for one CTA; K rows padded by one float so that the
// per-(head, key) score threads read distinct banks
__host__ __device__ inline size_t smem_floats(int g, int hd, int bs) {
  return (size_t)g * hd          // q (scaled)
         + (size_t)bs * (hd + 1) // K tile
         + (size_t)bs * hd       // V tile
         + (size_t)g * bs        // scores, then p
         + (size_t)g * hd        // acc
         + 3 * (size_t)g;        // m, l, alpha
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                      const KT* __restrict__ v_pool,
                      const int* __restrict__ table,
                      const int* __restrict__ lengths,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int H, int KVh, int hd,
                      int NB, int BS, int MB, int bps, float scale) {
  extern __shared__ float smem[];
  const int kh = blockIdx.x;
  const int s = blockIdx.y;
  const int split = blockIdx.z;
  const int G = H / KVh;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int kstride = hd + 1;

  const int len = lengths[s];
  const int n_live = min((len + BS) / BS, MB);
  const int m_begin = split * bps;
  if (m_begin >= n_live) return;              // nothing live in this split
  const int m_end = min(n_live, m_begin + bps);

  float* qs = smem;
  float* ks = qs + (size_t)G * hd;
  float* vs = ks + (size_t)BS * kstride;
  float* sc = vs + (size_t)BS * hd;
  float* acc = sc + (size_t)G * BS;
  float* mrun = acc + (size_t)G * hd;
  float* lrun = mrun + G;
  float* alpha = lrun + G;

  const size_t qbase = ((size_t)s * H + (size_t)kh * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    qs[i] = to_f(q[qbase + i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    mrun[g] = kNeg;
    lrun[g] = 0.f;
  }
  __syncthreads();

  for (int m = m_begin; m < m_end; ++m) {
    int blk = table[s * MB + m];
    if (blk < 0 || blk >= NB) blk = 0;  // a bad table entry reads the null block
    const size_t base = (size_t)blk * BS * KVh * hd + (size_t)kh * hd;
    for (int r = warp; r < BS; r += kThreads / 32) {
      const size_t src = base + (size_t)r * KVh * hd;
      for (int d = lane; d < hd; d += 32) {
        ks[r * kstride + d] = to_f(k_pool[src + d]);
        vs[r * hd + d] = to_f(v_pool[src + d]);
      }
    }
    __syncthreads();

    for (int i = tid; i < G * BS; i += kThreads) {
      const int g = i / BS, j = i - g * BS;
      const float* qg = qs + (size_t)g * hd;
      const float* kj = ks + (size_t)j * kstride;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qg[d], kj[d], dot);
      sc[i] = (m * BS + j <= len) ? dot : kNeg;
    }
    __syncthreads();

    for (int g = tid; g < G; g += kThreads) {
      float* row = sc + (size_t)g * BS;
      const float m_prev = mrun[g];
      float m_new = m_prev;
      for (int j = 0; j < BS; ++j) m_new = fmaxf(m_new, row[j]);
      const float a = expf(m_prev - m_new);
      float sum = 0.f;
      for (int j = 0; j < BS; ++j) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      lrun[g] = lrun[g] * a + sum;
      alpha[g] = a;
      mrun[g] = m_new;
    }
    __syncthreads();

    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd, d = i - g * hd;
      const float* p = sc + (size_t)g * BS;
      float o = 0.f;
      for (int j = 0; j < BS; ++j) o = fmaf(p[j], vs[(size_t)j * hd + d], o);
      acc[i] = acc[i] * alpha[g] + o;
    }
    __syncthreads();
  }

  const size_t pbase = (((size_t)s * KVh + kh) * gridDim.z + split) * G;
  for (int g = tid; g < G; g += kThreads) {
    part_m[pbase + g] = mrun[g];
    part_l[pbase + g] = lrun[g];
  }
  for (int i = tid; i < G * hd; i += kThreads) part_acc[pbase * hd + i] = acc[i];
}

// merge the live splits of (slot, KV head); splits past n_live never ran
template <typename QT>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc,
                      const int* __restrict__ lengths, QT* __restrict__ out,
                      int H, int KVh, int hd, int BS, int MB, int bps,
                      int nsplit) {
  const int kh = blockIdx.x;
  const int s = blockIdx.y;
  const int G = H / KVh;
  const int n_live = min((lengths[s] + BS) / BS, MB);
  const int n_used = (n_live + bps - 1) / bps;
  const size_t pbase = ((size_t)s * KVh + kh) * nsplit;
  const size_t obase = ((size_t)s * H + (size_t)kh * G) * hd;
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    const int g = i / hd;
    float M = kNeg;
    for (int sp = 0; sp < n_used; ++sp) M = fmaxf(M, part_m[(pbase + sp) * G + g]);
    float L = 0.f, A = 0.f;
    for (int sp = 0; sp < n_used; ++sp) {
      const size_t pg = (pbase + sp) * G + g;
      const float w = expf(part_m[pg] - M);
      L = fmaf(part_l[pg], w, L);
      A = fmaf(part_acc[pg * hd + (i - g * hd)], w, A);
    }
    out[obase + i] = from_f<QT>(A / fmaxf(L, 1e-30f));
  }
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* lengths, float* part_m, float* part_l, float* part_acc,
           void* out, int S, int H, int KVh, int hd, int NB, int BS, int MB,
           int bps, float scale, cudaStream_t st) {
  const int G = H / KVh;
  const int nsplit = (MB + bps - 1) / bps;
  const size_t bytes = smem_floats(G, hd, BS) * sizeof(float);
  auto kern = decode_partial_kernel<QT, KT>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(KVh, S, nsplit), kThreads, bytes, st>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), table, lengths, part_m, part_l, part_acc, H,
      KVh, hd, NB, BS, MB, bps, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_combine_kernel<QT><<<dim3(KVh, S), kThreads, 0, st>>>(
      part_m, part_l, part_acc, lengths, static_cast<QT*>(out), H, KVh, hd, BS,
      MB, bps, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_kv(int kv_dtype, const void* q, const void* k, const void* v,
              const int* table, const int* lengths, float* pm, float* pl,
              float* pa, void* out, int S, int H, int KVh, int hd, int NB,
              int BS, int MB, int bps, float scale, cudaStream_t st) {
  switch (kv_dtype) {
    case 0: return launch<QT, float>(q, k, v, table, lengths, pm, pl, pa, out, S, H, KVh, hd, NB, BS, MB, bps, scale, st);
    case 1: return launch<QT, __nv_bfloat16>(q, k, v, table, lengths, pm, pl, pa, out, S, H, KVh, hd, NB, BS, MB, bps, scale, st);
    case 2: return launch<QT, __half>(q, k, v, table, lengths, pm, pl, pa, out, S, H, KVh, hd, NB, BS, MB, bps, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16. out has q's dtype.
// scale is hd^-0.5, rounded to fp32 by the caller as the reference does.
// part_m, part_l: (S, KVh, ceil(MB / bps), G) fp32 scratch; part_acc: the
// same with a trailing hd axis.
int repro_paged_attention_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const int* table,
                                 const int* lengths, float* part_m,
                                 float* part_l, float* part_acc, void* out,
                                 int S, int H, int KVh, int hd, int NB, int BS,
                                 int MB, int bps, float scale, int q_dtype,
                                 int kv_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0: return launch_kv<float>(kv_dtype, q, k_pool, v_pool, table, lengths, part_m, part_l, part_acc, out, S, H, KVh, hd, NB, BS, MB, bps, scale, st);
    case 1: return launch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, table, lengths, part_m, part_l, part_acc, out, S, H, KVh, hd, NB, BS, MB, bps, scale, st);
    case 2: return launch_kv<__half>(kv_dtype, q, k_pool, v_pool, table, lengths, part_m, part_l, part_acc, out, S, H, KVh, hd, NB, BS, MB, bps, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
