// Fused cross-entropy, CE + distillation and distillation losses, forward
// and backward (sm_90a).
//
// Replaces the TPU kernels of the reference's kernels/fused_ce.py,
// kernels/combined_loss.py and kernels/distill_loss.py:
//   repro_fused_loss_fwd mode 0 <- fused_cross_entropy_parts (_ce_parts_kernel)
//                        mode 1 <- fused_ce_distill_parts, mse (_combined_mse_kernel)
//                        mode 2 <- fused_ce_distill_parts, kl  (_combined_kl_kernel)
//                        mode 3 <- fused_distill_loss, mse (_mse_kernel)
//                        mode 4 <- fused_distill_loss, kl (_kl_kernel) and,
//                                  with res, fused_distill_kl_parts (_kl_parts_kernel)
//                        mode 5 <- fused_cross_entropy (_ce_kernel), the
//                                  forward-only NLL
//   repro_fused_loss_bwd mode 0 <- fused_cross_entropy_grad (_ce_grad_kernel)
//                        mode 1 <- fused_ce_distill_grad, mse (_combined_mse_grad_kernel)
//                        mode 2 <- fused_ce_distill_grad, kl  (_combined_kl_grad_kernel)
//                        mode 3 <- fused_distill_mse_grad (_mse_grad_kernel)
//                        mode 4 <- fused_distill_kl_grad (_kl_grad_kernel)
//
// Inputs: student logits x (T, V) and, for modes 1-4, target logits t
// (T, V), both contiguous and of one dtype (fp32 or bf16, a runtime code);
// labels (T,) int32 for modes 0-2 and 5 (modes 3 and 4 have no CE term
// and read no labels). Any T and V: nothing is padded, each kernel masks its own
// ragged edge. In modes 0-2, v_real <= V bounds the columns of the
// smoothing mean and of the mse; every column enters the logsumexps, as in
// the reference (whose block-padding columns hold -1e30 and add nothing).
// In mode 3, v_real is only the mse's denominator (the reference's
// v_total): every column enters the sum, as in _mse_kernel.
//
// Forward. A token row is streamed once by a cluster of `splits` CTAs
// (one CTA in modes 0, 1, 2 and 5, and in modes 3 and 4 whenever the rows
// alone cover the SMs; the Python plan picks the count from the shapes):
// CTA rank r takes a contiguous run of the row's 16-byte vectors, rank 0
// also the unaligned scalar head and the last rank the scalar tail. Each
// thread keeps the online state of the columns it saw: the student's running
// max m and sum s of exp(x - m), the sum of x over columns < v_real, and for
// mse the sum of (x - t)^2 over those columns, for kl the target's (m_t, s_t)
// and U = sum exp(t - m_t) (t - x). A warp shuffle and then a shared-memory
// pass over the warps merge the states, rescaling s, s_t and U by
// exp(m_old - m_new). With more than one CTA a row, each rank stores its
// State in rank 0's shared memory (distributed shared memory, between two
// halves of the cluster barrier) and rank 0 folds ranks 0, 1, ... in that
// order with the same merge, so the result does not change from call to
// call. This replaces the reference's sequential vocab grid axis
// (pl.program_id(1) carrying VMEM scratch from tile to tile), which has no
// order on the GPU, without a workspace, a second launch or float atomics.
// Thread 0 reads the true logit x[label] itself. The outputs are fp32
// (K, T) rows: mode 0 [nll, smooth, logZ]; mode 1 [nll, smooth, dist,
// logZ_s]; mode 2 [nll, smooth, dist, logZ_s, logZ_t, E] with E = U / s_t
// and dist = E - logZ_t + logZ_s, the reference's formulas; mode 5 [nll]
// alone, nll = (m + log s) - x[label] as _ce_kernel's m + log(s) - t: mode 0
// without the real-column sum and the smooth and logZ rows. A label
// outside [0, V) hits no column, so its nll is logZ, as in the reference.
//
// Backward. Elementwise given the (T,) residuals and the (T,) cotangents,
// each handed over by a pointer of its own (logZ_s, logZ_t, E; g_nll,
// g_smooth, g_dist; null where the mode has none), so the forward's (K, T)
// rows and autograd's cotangents go in as they are and a call is one
// launch: grid (T, ceil(V / chunk)), chunk = 256 threads x one 16-byte
// vector. Each thread rebuilds softmax(x) = exp(x - logZ_s) and, for kl,
// p = exp(t - logZ_t), and writes ds (and dt unless its pointer is null)
// in the logits' dtype, rounded once from fp32:
//   ds = (g_nll + g_smooth) q - g_nll onehot - g_smooth [c < v_real] / v_real
//        + mse: g_dist 2 (x - t)[c < v_real] / v_real   | kl: g_dist (q - p)
//   dt = mse: -g_dist 2 (x - t)[c < v_real] / v_real   | kl: g_dist p ((t - x) - E)
// and for modes 3 and 4, with the one cotangent row g:
//   mode 3: ds = g 2 (x - t) / v_total, dt = -ds      (every column)
//   mode 4: ds = g (q - p),             dt = g p ((t - x) - E)
//
// What bounds them on an H100: bytes. The forward reads each logits
// element once and does a handful of fp32 operations and up to two exps
// on it; the backward reads x (and t) once and writes ds (and dt) once. At
// the main-path shape (T = 4096, V = 152064, bf16) that is 1.25 GB per
// (T, V) operand, 0.37 ms at 3.35 TB/s; the kl modes' two exps per element
// (~1.25e9 at that shape) stay under it on the SFUs. The design reads nothing twice and
// keeps every (T, V) intermediate in registers. A few rows (the serving
// canary's one, a subsampled wire's hundreds) would leave most SMs idle at
// one CTA a row, so modes 3 and 4 split each row over a cluster of up to 16
// CTAs there, and a split mse row keeps 4 vector loads in flight a thread.
// At the classifiers' rows (one row an example, V 10 or 1000, fp32) a call
// moves a few kB and costs about one launch; a flat grid over the T x V
// elements, with no CTA of idle threads, measured no faster there. Not yet
// done: cp.async/TMA staging, and more loads in flight on the
// one-CTA-a-row path.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kFwdThreads = 512;
constexpr int kBwdThreads = 256;
// the forward's largest cluster: 8 is portable, 16 needs the non-portable
// cluster attribute (H100: a GPC holds at least 16 SMs)
constexpr int kMaxSplits = 16;
constexpr float kNeg = -1e30f;

enum Mode { kCE = 0, kMSE = 1, kKL = 2, kDistMSE = 3, kDistKL = 4, kNLL = 5 };

// what each mode computes: the task CE (labels, smoothing), the NLL alone
// (labels), the student's logsumexp, an mse or a kl distillation term
__host__ __device__ constexpr bool has_ce(int m) { return m <= kKL; }
__host__ __device__ constexpr bool has_label(int m) { return m <= kKL || m == kNLL; }
__host__ __device__ constexpr bool has_target(int m) { return m != kCE && m != kNLL; }
__host__ __device__ constexpr bool has_lse(int m) { return m != kDistMSE; }
__host__ __device__ constexpr bool is_mse(int m) { return m == kMSE || m == kDistMSE; }
__host__ __device__ constexpr bool is_kl(int m) { return m == kKL || m == kDistKL; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// elements of T in one 16-byte vector
template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[Vec<T>::n]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) out[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[Vec<T>::n]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) e[i] = from_f<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Leading elements of a row before its first 16-byte boundary (the scalar
// head), or the whole row when the vector path is off.
template <typename T>
__device__ __forceinline__ int row_head(const T* row, int V, int vec) {
  if (!vec) return V;
  const int mis = (int)((reinterpret_cast<uintptr_t>(row) % 16) / sizeof(T));
  return min(V, mis ? Vec<T>::n - mis : 0);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct State {
  float m, s;       // student running max, sum exp(x - m)
  float xs;         // sum of x over columns < v_real
  float acc;        // mse: sum (x - t)^2 over columns < v_real
  float mt, st, u;  // kl: target running max, sum exp(t - mt), sum exp(t - mt)(t - x)
};

__device__ __forceinline__ State empty_state() {
  State a;
  a.m = kNeg; a.s = 0.f; a.xs = 0.f; a.acc = 0.f;
  a.mt = kNeg; a.st = 0.f; a.u = 0.f;
  return a;
}

template <int MODE, int N>
__device__ __forceinline__ void visit(State& a, const float (&x)[N],
                                      const float (&t)[N], int c0, int v_real) {
  if (has_lse(MODE)) {
    float vmax = x[0];
#pragma unroll
    for (int i = 1; i < N; ++i) vmax = fmaxf(vmax, x[i]);
    if (vmax > a.m) {
      a.s *= expf(a.m - vmax);
      a.m = vmax;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      a.s += expf(x[i] - a.m);
      if (has_ce(MODE) && c0 + i < v_real) a.xs += x[i];
    }
  }
  if (MODE == kDistMSE) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float d = x[i] - t[i];
      a.acc += d * d;
    }
  }
  if (MODE == kMSE) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (c0 + i < v_real) {
        const float d = x[i] - t[i];
        a.acc += d * d;
      }
    }
  }
  if (is_kl(MODE)) {
    float tmax = t[0];
#pragma unroll
    for (int i = 1; i < N; ++i) tmax = fmaxf(tmax, t[i]);
    if (tmax > a.mt) {
      const float r = expf(a.mt - tmax);
      a.st *= r;
      a.u *= r;
      a.mt = tmax;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float w = expf(t[i] - a.mt);
      a.st += w;
      a.u += w * (t[i] - x[i]);
    }
  }
}

template <int MODE>
__device__ __forceinline__ void merge(State& a, const State& b) {
  if (has_lse(MODE)) {
    const float m = fmaxf(a.m, b.m);
    a.s = a.s * expf(a.m - m) + b.s * expf(b.m - m);
    a.m = m;
  }
  if (has_ce(MODE)) a.xs += b.xs;
  if (is_mse(MODE)) a.acc += b.acc;
  if (is_kl(MODE)) {
    const float mt = fmaxf(a.mt, b.mt);
    const float ra = expf(a.mt - mt), rb = expf(b.mt - mt);
    a.st = a.st * ra + b.st * rb;
    a.u = a.u * ra + b.u * rb;
    a.mt = mt;
  }
}

__device__ __forceinline__ State shfl_xor(const State& a, int mask) {
  State b;
  b.m = __shfl_xor_sync(0xffffffffu, a.m, mask);
  b.s = __shfl_xor_sync(0xffffffffu, a.s, mask);
  b.xs = __shfl_xor_sync(0xffffffffu, a.xs, mask);
  b.acc = __shfl_xor_sync(0xffffffffu, a.acc, mask);
  b.mt = __shfl_xor_sync(0xffffffffu, a.mt, mask);
  b.st = __shfl_xor_sync(0xffffffffu, a.st, mask);
  b.u = __shfl_xor_sync(0xffffffffu, a.u, mask);
  return b;
}

template <int MODE>
__device__ __forceinline__ State warp_merge(State a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) merge<MODE>(a, shfl_xor(a, off));
  return a;
}

// 16-byte vectors of each operand a thread of a split row loads before it
// visits any: 4 for mse, whose state is one sum; 1 for kl, whose five sums
// and two exps an element, with 4 loads in flight, take the registers of a
// second resident CTA on an SM (16 rows of 16 CTAs then run in two waves)
template <int MODE>
__device__ constexpr int split_loads() { return is_mse(MODE) ? 4 : 1; }

// the cluster barrier in two halves: arrive (release: this thread's shared
// stores, local or remote, are visible to whoever waits) and wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int MODE, typename T>
__device__ __forceinline__ void visit_scalars(State& a, const T* xr, const T* tr,
                                              int c0, int c1, int v_real) {
  for (int c = c0 + (int)threadIdx.x; c < c1; c += blockDim.x) {
    const float xa[1] = {to_f(xr[c])};
    const float ta[1] = {has_target(MODE) ? to_f(tr[c]) : 0.f};
    visit<MODE, 1>(a, xa, ta, c, v_real);
  }
}

// Folds vectors [k0, k1) of a row into the thread's state, U vectors of
// each operand loaded before any is visited (loads in flight for the few
// vectors a thread of a split row sees); the visits run in the order of a
// plain stride loop, so U changes no bit of the result.
template <int MODE, int U, typename T>
__device__ __forceinline__ void visit_vectors(State& a, const T* xr, const T* tr,
                                              int head, int k0, int k1,
                                              int v_real) {
  constexpr int N = Vec<T>::n;
  const int stride = blockDim.x;
  for (int k = k0 + (int)threadIdx.x; k < k1; k += U * stride) {
    uint4 xv[U], tv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c0 = head + (k + u * stride) * N;
      if (k + u * stride < k1) {
        xv[u] = __ldg(reinterpret_cast<const uint4*>(xr + c0));
        if (has_target(MODE)) tv[u] = __ldg(reinterpret_cast<const uint4*>(tr + c0));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k + u * stride >= k1) break;
      float xa[N], ta[N];
      const T* xe = reinterpret_cast<const T*>(&xv[u]);
      const T* te = reinterpret_cast<const T*>(&tv[u]);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        xa[i] = to_f(xe[i]);
        ta[i] = has_target(MODE) ? to_f(te[i]) : 0.f;
      }
      visit<MODE, N>(a, xa, ta, head + (k + u * stride) * N, v_real);
    }
  }
}

// grid (splits * T,), in clusters of (splits, 1, 1) when SPLIT: CTA rank r
// of row blockIdx.x / splits streams its run of the row (below), the CTA's
// threads merge into one State, every rank stores its State in rank 0's
// shared memory, and rank 0 folds them in rank order and writes the row.
// Without SPLIT, one CTA a row streams it whole (splits = 1).
template <typename T, int MODE, bool SPLIT>
__global__ void __launch_bounds__(kFwdThreads)
fwd_kernel(const T* __restrict__ x, const T* __restrict__ tg,
           const int* __restrict__ labels, float* __restrict__ out,
           float* __restrict__ res, int n_tok, int V, int v_real, int vec,
           int vps, int splits) {
  constexpr int N = Vec<T>::n;
  __shared__ State warps[kFwdThreads / 32];
  __shared__ State parts[SPLIT ? kMaxSplits : 1];
  // the first half of a barrier whose wait, after the stream, tells this
  // CTA that every CTA of its cluster runs and can take a remote store
  if (SPLIT) cluster_arrive_relaxed();
  if (!SPLIT) splits = 1;
  const int row = SPLIT ? blockIdx.x / splits : blockIdx.x;
  const int rank = SPLIT ? blockIdx.x % splits : 0;
  const bool last = rank == splits - 1;
  const T* xr = x + (size_t)row * V;
  const T* tr = has_target(MODE) ? tg + (size_t)row * V : nullptr;

  // The run of rank r: vectors [r vps, (r + 1) vps) after the scalar head,
  // the last rank to the row's last whole vector; rank 0 also takes the
  // head, the last rank the tail. A row off the vector path is all scalar:
  // runs of vps * N columns, the last rank to V. splits = 1 is one run, the
  // whole row in the order head, vectors, tail.
  State a = empty_state();
  if (vec) {
    const int head = row_head(xr, V, vec);
    const int nvec = (V - head) / N;
    const int k0 = (int)min((long long)rank * vps, (long long)nvec);
    const int k1 = last ? nvec : (int)min((long long)k0 + vps, (long long)nvec);
    if (rank == 0) visit_scalars<MODE>(a, xr, tr, 0, head, v_real);
    visit_vectors<MODE, SPLIT ? split_loads<MODE>() : 1>(a, xr, tr, head, k0, k1, v_real);
    if (last) visit_scalars<MODE>(a, xr, tr, head + nvec * N, V, v_real);
  } else {
    const long long run = (long long)vps * N;
    const int c0 = (int)min(rank * run, (long long)V);
    const int c1 = last ? V : (int)min(c0 + run, (long long)V);
    visit_scalars<MODE>(a, xr, tr, c0, c1, v_real);
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  a = warp_merge<MODE>(a);
  if (lane == 0) warps[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < (int)(blockDim.x / 32) ? warps[lane] : empty_state();
    a = warp_merge<MODE>(a);
  }
  if (SPLIT) {
    cluster_wait();
    if (threadIdx.x == 0) {
      namespace cg = cooperative_groups;
      *cg::this_cluster().map_shared_rank(&parts[rank], 0) = a;
    }
    cluster_arrive();
    cluster_wait();
    if (rank != 0) return;
    if (threadIdx.x == 0) {
      a = parts[0];
      for (int r = 1; r < splits; ++r) merge<MODE>(a, parts[r]);
    }
  }
  if (threadIdx.x != 0) return;

  const size_t n = (size_t)n_tok;
  const float logz = has_lse(MODE) ? a.m + logf(a.s) : 0.f;
  if (has_label(MODE)) {
    const int lb = labels[row];
    const float true_logit = (lb >= 0 && lb < V) ? to_f(xr[lb]) : 0.f;
    out[row] = logz - true_logit;                            // nll
    if (has_ce(MODE)) out[n + row] = logz - a.xs / (float)v_real;  // smooth
  }
  if (MODE == kNLL) {
    return;
  } else if (MODE == kCE) {
    out[2 * n + row] = logz;
  } else if (MODE == kMSE) {
    out[2 * n + row] = a.acc / (float)v_real;                // dist
    out[3 * n + row] = logz;
  } else if (MODE == kDistMSE) {
    out[row] = a.acc / (float)v_real;                        // dist
  } else {
    const float logzt = a.mt + logf(a.st);
    const float e = a.u / a.st;
    const float dist = e - logzt + logz;                     // KL
    if (MODE == kKL) {
      out[2 * n + row] = dist;
      out[3 * n + row] = logz;
      out[4 * n + row] = logzt;
      out[5 * n + row] = e;
    } else {
      out[row] = dist;
      if (res != nullptr) {
        res[row] = logz;
        res[n + row] = logzt;
        res[2 * n + row] = e;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// the per-token fp32 rows of the backward, one pointer each, null where the
// mode has none
struct BwdRows {
  const float *logzs, *logzt, *e, *gn, *gs, *gd;
};

struct Row {
  float logzs, logzt, e, gn, gs, gd, inv_v, two_inv_v;
  int label, v_real;
};

template <int MODE>
__device__ __forceinline__ void grad_elem(const Row& r, float x, float t,
                                          int c, float& ds, float& dt) {
  if (MODE == kDistMSE) {
    const float dd = r.gd * r.two_inv_v * (x - t);
    ds = dd;
    dt = -dd;
    return;
  }
  if (MODE == kDistKL) {
    const float q = expf(x - r.logzs);
    const float p = expf(t - r.logzt);
    ds = r.gd * (q - p);
    dt = r.gd * p * ((t - x) - r.e);
    return;
  }
  const float q = expf(x - r.logzs);
  const float ce = (r.gn + r.gs) * q - (c == r.label ? r.gn : 0.f)
                   - (c < r.v_real ? r.gs * r.inv_v : 0.f);
  if (MODE == kCE) {
    ds = ce;
  } else if (MODE == kMSE) {
    const float d = c < r.v_real ? x - t : 0.f;
    const float dd = r.gd * r.two_inv_v * d;
    ds = ce + dd;
    dt = -dd;
  } else {
    const float p = expf(t - r.logzt);
    ds = ce + r.gd * (q - p);
    dt = r.gd * p * ((t - x) - r.e);
  }
}

template <typename T, int MODE>
__device__ __forceinline__ void grad_scalar(const Row& r, const T* xr,
                                            const T* tr, T* dsr, T* dtr, int c) {
  float ds, dt = 0.f;
  grad_elem<MODE>(r, to_f(xr[c]), MODE == kCE ? 0.f : to_f(tr[c]), c, ds, dt);
  dsr[c] = from_f<T>(ds);
  if (MODE != kCE && dtr != nullptr) dtr[c] = from_f<T>(dt);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kBwdThreads)
bwd_kernel(const T* __restrict__ x, const T* __restrict__ tg,
           const int* __restrict__ labels, BwdRows rows, T* __restrict__ ds,
           T* __restrict__ dt, int V, int v_real, float inv_v, float two_inv_v,
           int vec) {
  constexpr int N = Vec<T>::n;
  const int row = blockIdx.x;
  const size_t base = (size_t)row * V;
  const T* xr = x + base;
  const T* tr = MODE == kCE ? nullptr : tg + base;
  T* dsr = ds + base;
  T* dtr = (MODE == kCE || dt == nullptr) ? nullptr : dt + base;
  Row r;
  r.logzs = has_lse(MODE) ? rows.logzs[row] : 0.f;
  r.logzt = is_kl(MODE) ? rows.logzt[row] : 0.f;
  r.e = is_kl(MODE) ? rows.e[row] : 0.f;
  r.gn = has_ce(MODE) ? rows.gn[row] : 0.f;
  r.gs = has_ce(MODE) ? rows.gs[row] : 0.f;
  r.gd = MODE == kCE ? 0.f : rows.gd[row];
  r.inv_v = inv_v;
  r.two_inv_v = two_inv_v;
  r.label = has_ce(MODE) ? labels[row] : -1;
  r.v_real = v_real;

  const int head = row_head(xr, V, vec);
  const int nvec = (V - head) / N;
  if (blockIdx.y == 0) {
    for (int c = threadIdx.x; c < head; c += blockDim.x)
      grad_scalar<T, MODE>(r, xr, tr, dsr, dtr, c);
    for (int c = head + nvec * N + threadIdx.x; c < V; c += blockDim.x)
      grad_scalar<T, MODE>(r, xr, tr, dsr, dtr, c);
  }
  const int k = blockIdx.y * blockDim.x + threadIdx.x;
  if (k >= nvec) return;
  const int c0 = head + k * N;
  float xa[N], ta[N], da[N], ea[N];
  load_vec(xr + c0, xa);
  if (MODE != kCE) load_vec(tr + c0, ta);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ea[i] = 0.f;
    grad_elem<MODE>(r, xa[i], MODE == kCE ? 0.f : ta[i], c0 + i, da[i], ea[i]);
  }
  store_vec(dsr + c0, da);
  if (dtr != nullptr) store_vec(dtr + c0, ea);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the 16-byte vector path needs every (T, V) operand's base at the same
// offset mod 16 (rows then share their misalignment, handled by the head)
int same_mod16(const void* a, const void* b, const void* c, const void* d) {
  const uintptr_t m = reinterpret_cast<uintptr_t>(a) % 16;
  const void* rest[3] = {b, c, d};
  for (const void* p : rest)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != m) return 0;
  return 1;
}

// one CTA a row
template <typename T, int MODE>
cudaError_t launch_fwd_one(const T* x, const T* t, const int* labels,
                           float* out, float* res, int n_tok, int V,
                           int v_real, int vec, int vps, cudaStream_t st) {
  fwd_kernel<T, MODE, false><<<n_tok, kFwdThreads, 0, st>>>(
      x, t, labels, out, res, n_tok, V, v_real, vec, vps, 1);
  return cudaGetLastError();
}

// a cluster of `splits` CTAs a row (the distillation modes), or one CTA
template <typename T, int MODE>
cudaError_t launch_fwd_split(const T* x, const T* t, const int* labels,
                             float* out, float* res, int n_tok, int V,
                             int v_real, int vec, int vps, int splits,
                             cudaStream_t st) {
  if (splits == 1)
    return launch_fwd_one<T, MODE>(x, t, labels, out, res, n_tok, V, v_real,
                                   vec, vps, st);
  auto kernel = fwd_kernel<T, MODE, true>;
  if (splits > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_tok * (unsigned)splits);
  cfg.blockDim = dim3(kFwdThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, t, labels, out,
                                           res, n_tok, V, v_real, vec, vps,
                                           splits);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
int launch_fwd(int mode, const void* x, const void* t, const int* labels,
               float* out, float* res, int n_tok, int V, int v_real, int vps,
               int splits, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* tp = static_cast<const T*>(t);
  const int vec = same_mod16(x, t, nullptr, nullptr);
  // only the distillation modes split a row; a grid of splits * T CTAs
  if (splits < 1 || splits > kMaxSplits || vps < 1 ||
      (splits > 1 && mode != kDistMSE && mode != kDistKL) ||
      (long long)n_tok * splits > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (mode) {
    case kCE: e = launch_fwd_one<T, kCE>(xp, tp, labels, out, res, n_tok, V, v_real, vec, vps, st); break;
    case kMSE: e = launch_fwd_one<T, kMSE>(xp, tp, labels, out, res, n_tok, V, v_real, vec, vps, st); break;
    case kKL: e = launch_fwd_one<T, kKL>(xp, tp, labels, out, res, n_tok, V, v_real, vec, vps, st); break;
    case kDistMSE: e = launch_fwd_split<T, kDistMSE>(xp, tp, labels, out, res, n_tok, V, v_real, vec, vps, splits, st); break;
    case kDistKL: e = launch_fwd_split<T, kDistKL>(xp, tp, labels, out, res, n_tok, V, v_real, vec, vps, splits, st); break;
    case kNLL: e = launch_fwd_one<T, kNLL>(xp, tp, labels, out, res, n_tok, V, v_real, vec, vps, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

template <typename T>
int launch_bwd(int mode, const void* x, const void* t, const int* labels,
               const BwdRows& rows, void* ds, void* dt, int n_tok, int V,
               int v_real, float inv_v, float two_inv_v, cudaStream_t st) {
  // every operand the mode reads must be there
  const bool ok = mode >= kCE && mode <= kDistKL &&
                  (!has_lse(mode) || rows.logzs != nullptr) &&
                  (!is_kl(mode) || (rows.logzt != nullptr && rows.e != nullptr)) &&
                  (!has_ce(mode) || (labels != nullptr && rows.gn != nullptr &&
                                     rows.gs != nullptr)) &&
                  (mode == kCE || (t != nullptr && rows.gd != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const T* tp = static_cast<const T*>(t);
  T* dsp = static_cast<T*>(ds);
  T* dtp = static_cast<T*>(dt);
  const int vec = same_mod16(x, t, ds, dt);
  // chunks cover the vector columns; chunk 0 also takes the scalar head and
  // tail (fewer than 2 * Vec<T>::n columns), so at least one chunk runs
  const int per_chunk = kBwdThreads * Vec<T>::n;
  const int chunks = V > 0 ? (V + per_chunk - 1) / per_chunk : 1;
  const dim3 grid(n_tok, chunks);
  switch (mode) {
    case kCE: bwd_kernel<T, kCE><<<grid, kBwdThreads, 0, st>>>(xp, tp, labels, rows, dsp, dtp, V, v_real, inv_v, two_inv_v, vec); break;
    case kMSE: bwd_kernel<T, kMSE><<<grid, kBwdThreads, 0, st>>>(xp, tp, labels, rows, dsp, dtp, V, v_real, inv_v, two_inv_v, vec); break;
    case kKL: bwd_kernel<T, kKL><<<grid, kBwdThreads, 0, st>>>(xp, tp, labels, rows, dsp, dtp, V, v_real, inv_v, two_inv_v, vec); break;
    case kDistMSE: bwd_kernel<T, kDistMSE><<<grid, kBwdThreads, 0, st>>>(xp, tp, labels, rows, dsp, dtp, V, v_real, inv_v, two_inv_v, vec); break;
    case kDistKL: bwd_kernel<T, kDistKL><<<grid, kBwdThreads, 0, st>>>(xp, tp, labels, rows, dsp, dtp, V, v_real, inv_v, two_inv_v, vec); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype codes: 0 = float32, 1 = bfloat16 (x and t share one).
// x, t (T, V); labels (T,) i32 (modes 0-2 and 5; unused, may be null, in
// modes 3 and 4); out (K, T) fp32 with K = 3, 4, 6, 1, 1, 1 for modes 0-5.
// t is unused (may be null) in modes 0 and 5. res (3, T) fp32 [logZ_s, logZ_t, E] is
// written in mode 4 when not null, and unused otherwise. Each row is split
// over `splits` CTAs (1..16; modes 3 and 4 only, else 1) of `vps` 16-byte
// vectors each (>= 1), the last taking the rest of the row.
int repro_fused_loss_fwd(const void* x, const void* t, const int* labels,
                         float* out, float* res, int n_tok, int V, int v_real,
                         int vps, int splits, int mode, int dtype,
                         void* stream) {
  if (n_tok == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fwd<float>(mode, x, t, labels, out, res, n_tok, V, v_real, vps, splits, st);
    case 1: return launch_fwd<__nv_bfloat16>(mode, x, t, labels, out, res, n_tok, V, v_real, vps, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One launch. logzs, logzt, e: the forward's fp32 (T,) residual rows,
// logZ_s in modes 0, 1, 2 and 4, logZ_t and E in modes 2 and 4; g_nll,
// g_smooth, g_dist: the fp32 (T,) cotangent rows, g_nll and g_smooth in
// modes 0-2, g_dist in modes 1-4. Each is a contiguous row of its own, null
// where the mode has none. ds (T, V) in x's dtype; dt (T, V) or null (not
// written) in modes 1-4. two_inv_v is 2 / v_real (modes 1, 3: 2 / v_total).
// An operand the mode needs that is null returns cudaErrorInvalidValue
// without a launch.
int repro_fused_loss_bwd(const void* x, const void* t, const int* labels,
                         const float* logzs, const float* logzt,
                         const float* e, const float* g_nll,
                         const float* g_smooth, const float* g_dist, void* ds,
                         void* dt, int n_tok, int V, int v_real, int mode,
                         int dtype, float inv_v, float two_inv_v,
                         void* stream) {
  if (n_tok == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdRows rows = {logzs, logzt, e, g_nll, g_smooth, g_dist};
  switch (dtype) {
    case 0: return launch_bwd<float>(mode, x, t, labels, rows, ds, dt, n_tok, V, v_real, inv_v, two_inv_v, st);
    case 1: return launch_bwd<__nv_bfloat16>(mode, x, t, labels, rows, ds, dt, n_tok, V, v_real, inv_v, two_inv_v, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
