// One-token GQA decode attention straight off the paged KV pool (sm_90a).
//
// Replaces the TPU kernels of the reference's kernels/paged_attention.py:
//   repro_paged_attention_decode <- paged_attention_decode (_decode_kernel /
//                                   _decode_body), fp32/bf16/fp16 pools, and
//                                   (_decode_kernel_quant) int8 and
//                                   float8_e4m3fn pools with fp32 row scales.
//
// Inputs: q (S, H, hd) in fp32/bf16/fp16; k_pool, v_pool (NB, BS, KVh, hd)
// in fp32/bf16/fp16/int8/e4m3, with k_scale, v_scale (NB, BS) fp32 for the
// quantized pools (null otherwise); table (S, MB) int32; lengths (S,) int32 =
// each slot's pre-step context length == the new token's position (keys at
// positions <= lengths[s] are valid; the new token's K/V was scattered before
// this launch, on the same stream). Output (S, H, hd) in q's dtype.
//
// What bounds it on an H100: bytes, then the fp32 arithmetic. At qwen2-7b
// (H = 28, KVh = 4, hd = 128, BS = 16) a position costs 2 KB of bf16 K and V
// (1 KB + 8 B of scales in int8/fp8) against 4 * H * hd = 14 KFLOP of fp32
// work: ~7 FLOP/B in bf16, ~14 in int8/fp8, far below the tensor cores' line
// and a wgmma tile of 64 rows (a KV head has G = 7 query rows). So the math
// runs on the CUDA cores in fp32, where the reference does it. Measured on
// an H100 80GB HBM3 (700 W) after an L2 flush, as chip_smoke.py times it
// (PERF.md section 6): at 4k-32k contexts bf16 takes ~1.2-1.4x a plain
// streaming read of the same bytes, and int8/fp8 are bound by the
// arithmetic (the pipeline alone runs at their byte floor); at the fleet's
// short contexts the chain of dependent loads (lengths and table, then the
// first block, then the combine's partials) sets the time.
//
// * Grid (split, slot, head group): one CTA takes a run of `bps` table
//   entries of one slot for a group of KVg KV heads. Where the shapes let
//   one CTA hold every KV head (KVg = KVh, one group: every config of the
//   repo but qwen1.5-4b), a pool block, (BS, KVh, hd), is one contiguous
//   span. Where they do not (20 KV heads at G = 1: too many warps, and a
//   bf16 stage of 160 KB that leaves the ring one stage; an fp32 one that
//   does not fit at all), the heads split into KVh / KVg groups sized so
//   that at least two stages of the group's K and V rows fit the ring
//   budget (kernels/paged_attention.py `decode_head_groups`: 4 heads in
//   bf16, int8 and fp8, 2 in fp32 at qwen1.5-4b). A group's slice of a
//   block is BS runs of KVg * hd contiguous elements, one row apart in the
//   pool; the producer warp copies them as BS 1D bulk copies each for K
//   and V, a lane a row. The split plan (`decode_split_plan`) comes from S,
//   MB, the group count and the SM count alone; the launch reads nothing
//   back from the device. Runs past n_live = min((len + BS) /
//   BS, MB) exit at once; no pool load is issued for m >= n_live, and an
//   out-of-range table entry reads the null block 0.
// * A CTA loads q, the slot's length and the run's table entries together,
//   once, and keeps up to 4 blocks in flight: per block one 1D bulk copy
//   each for K and V (BS of each for a head group; cp.async.bulk onto the
//   stage's mbarrier; plus the block's two rows of scales in the quantized
//   pools) into a ring of shared-memory stages. The last warp to release a stage (a shared-memory
//   count) issues the copies of the block `stages` ahead into it; no warp
//   waits for another in the loop, and there is no __syncthreads there.
// * Warps: WK per KV head (8 a CTA at qwen2-7b, two CTAs an SM: at most 128
//   registers a thread), each taking its share of every block's keys in
//   chunks of 4 steps. A lane owns 4 dims of a row (8 bytes of bf16, 4 of
//   int8/fp8), so hd / 4 lanes share a key. q (scaled by hd^-0.5 in fp32)
//   and the G x 4 accumulators stay in registers. A score is the lanes'
//   partial dots joined by shuffles: the G (padded to GP = 1, 2 or 8)
//   partials of a key halve at each shuffle step, so log2(hd / 4) shuffles
//   a step leave every lane one finished score. The lanes hold q in a
//   per-lane head order (slot i holds head i ^ h_lane) so that the halving
//   needs no select. Each warp runs its own fp32 online softmax per chunk
//   (running max m, denominator l, alpha = exp(m_prev - m_new)), hands p
//   and alpha to its lanes through a few words of shared memory, and
//   rescales its accumulators only when some alpha < 1. The warps of a KV
//   head merge their states through shared memory once, at the end of the
//   run.
// * Masks are selects (scores to NEG = -1e30 and p to exactly 0 for
//   positions past len and for rows past BS), never products with 0.
// * Conversions are exact: bf16 by shifts, int8 by __byte_perm into
//   2^23 + (b + 128) and one subtraction, e4m3 through cvt to half2.
//   Quantized rows dequantize in fp32 before their dot, as the reference's
//   `k * ks_ref.T` (float(k) * scale, one rounding); null-block scales are 0.
//
// Each run writes (m, l, acc) per head to fp32 scratch; the combine kernel,
// one CTA per (head, slot), merges the live runs: M = max m_i, L = sum l_i
// exp(m_i - M), A = sum acc_i exp(m_i - M), out = A / max(L, 1e-30). With
// one live run that is exactly acc / max(l, 1e-30). An inactive slot
// (length 0, all-zero table row) reads null block 0 once: its only valid key
// is the zero row, so its output is exactly 0.
//
// Instances: hd in {32, 64, 128} (4 dims a lane), GP in {1, 2, 8} (at most
// 8 warps a CTA for GP = 8, 16 otherwise; a head group of at most 8 KV heads
// keeps within both), BS any whose K and V rows of one KV head fit shared
// memory (a multiple of 4 for the quantized pools, whose scale rows are
// copied in bulk), every pool type, each as a one-group and a head-group
// instance; q's type is read at run time. cudaFuncSetAttribute runs once
// per instance.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDpl = 4;                  // dims of a row per lane
constexpr int kMaxStages = 4;
constexpr int kRingBudget = 100 * 1024;  // ring bytes per CTA (2 CTAs an SM)
constexpr int kMaxSmem = 227 * 1024;
constexpr int kCombineThreads = 512;

// pool types stored with a per-row fp32 scale
template <typename T> struct IsQuant { static constexpr bool value = false; };
template <> struct IsQuant<int8_t> { static constexpr bool value = true; };
template <> struct IsQuant<__nv_fp8_e4m3> { static constexpr bool value = true; };

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// 4 consecutive elements of q (global) as fp32
__device__ __forceinline__ void load_q4(const void* q, int qt, size_t i, float (&x)[4]) {
  if (qt == 0) {
    const float4 f = *reinterpret_cast<const float4*>(static_cast<const float*>(q) + i);
    x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
    return;
  }
  const uint2 u = *reinterpret_cast<const uint2*>(static_cast<const __half*>(q) + i);
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (qt == 1) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    } else {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[k]));
      x[2 * k] = f.x;
      x[2 * k + 1] = f.y;
    }
  }
}

// 4 consecutive elements of a row in shared memory, as fp32 (exact)
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(u.x << 16);
  x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16);
  x[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const __half* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&x)[4]) {
  // b + 128 into the low byte of 2^23's bits, then subtract 2^23 + 128
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    x[b] = __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7650u | b)) - 8388736.f;
}
__device__ __forceinline__ void load4(const __nv_fp8_e4m3* p, float (&x)[4]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> (16 * i)), __NV_E4M3);
    const float2 f = __half22float2(__half2(r));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
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
// 1D bulk copy global -> shared, completing `bytes` on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* table;
  const int* lengths;
  float* part_m;    // (S, nsplit, H)
  float* part_l;    // (S, nsplit, H)
  float* part_acc;  // (S, nsplit, H, hd)
  void* out;
  int S, H, KVh, hd, NB, BS, MB, bps, nsplit;
  int KVg;          // KV heads a CTA takes (KVh: one group)
  int G, WK, stages, q_dtype;
  float scale;
  int pool_block_bytes;  // one pool block, BS * KVh * hd elements
  int row_bytes;    // one pool row, KVh * hd elements
  int grow_bytes;   // a head group's slice of a row, KVg * hd elements
  int block_bytes;  // a head group's slice of a block, BS * KVg * hd elements
  int stage_bytes;  // K and V slices (+ their scale rows), 128-byte aligned
  int ring_bytes;   // the stages, or the warps' merge buffer if larger
};

// shared memory of the partial kernel: ring (also the merge buffer at the
// end), the full mbarriers and release counts of the stages, the run's
// table entries, then each warp's p and alpha words
template <int HD, int GP>
struct Layout {
  static constexpr int kLpk = HD / kDpl;      // lanes per key
  static constexpr int kKps = 32 / kLpk;      // keys per warp step
  static constexpr int kHspan = kLpk / GP;    // lanes that share a head's score
  // warp steps per softmax chunk: up to 4, one key to each lane of a head
  static constexpr int kSteps = kHspan < 4 ? kHspan : 4;
  static constexpr int kChunk = kSteps * kKps;  // keys per softmax chunk
  // floats per warp, a multiple of 4 (float4 stores)
  // (also the weights of up to 8 warps of a KV head at the end)
  static constexpr int kPbuf =
      ((kKps * GP * kSteps + GP > 8 * GP ? kKps * GP * kSteps + GP : 8 * GP) + 3) / 4 * 4;
  // floats of a warp's state in the end-of-run merge: acc [GP][HD], m [GP],
  // l [GP], padded to 16 bytes (float4 stores)
  static constexpr int kMerge = (GP * (HD + 2) + 3) / 4 * 4;
  __host__ __device__ static int merge_bytes(int nw) { return nw * kMerge * 4; }
  __host__ __device__ static int table_off(int ring_bytes) {
    return ring_bytes + kMaxStages * 12;  // 8-byte barriers, 4-byte counts
  }
  __host__ __device__ static int pbuf_off(int ring_bytes, int bps) {
    return table_off(ring_bytes) + (bps + 3) / 4 * 16;
  }
  __host__ __device__ static int bytes(int ring_bytes, int bps, int nw) {
    return pbuf_off(ring_bytes, bps) + nw * kPbuf * 4;
  }
};

// the scores of T keys (one warp step each), each spread as partial dots
// over the LPK lanes of a key group (slot i holds head i ^ h_lane): halve
// the GP slots at each shuffle step, sum the lanes of a head past the T
// lowest, then transpose the T keys over those: the lane ends with the
// score of head h_lane for key lane & (T - 1)
template <int LPK, int GP, int T>
__device__ __forceinline__ float reduce_scores(float (&v)[T][GP], int lane) {
#pragma unroll
  for (int k = 0; k < T; ++k) {
#pragma unroll
    for (int n = GP, o = LPK / 2; n > 1; n >>= 1, o >>= 1) {
#pragma unroll
      for (int i = 0; i < n / 2; ++i) v[k][i] += __shfl_xor_sync(kFull, v[k][i + n / 2], o);
    }
#pragma unroll
    for (int o = LPK / GP / 2; o >= T; o >>= 1) v[k][0] += __shfl_xor_sync(kFull, v[k][0], o);
  }
  float w[T];
#pragma unroll
  for (int k = 0; k < T; ++k) w[k] = v[k][0];
#pragma unroll
  for (int n = T, o = T / 2; n > 1; n >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? w[i] : w[i + n / 2];
      w[i] = (up ? w[i + n / 2] : w[i]) + __shfl_xor_sync(kFull, send, o);
    }
  }
  return w[0];
}

// GROUPED: a CTA takes a group of the KV heads (its own instances, so that
// the one-group instances keep their code and registers; the grouped GP = 8
// instances may use more than 128 registers, at one CTA an SM)
template <typename KT, int HD, int GP, bool GROUPED>
__global__ void __launch_bounds__(GP == 8 ? 256 : 512, GP == 8 && !GROUPED ? 2 : 1)
decode_partial_kernel(const Params p) {
  using L = Layout<HD, GP>;
  constexpr int kLpk = L::kLpk, kKps = L::kKps, kChunk = L::kChunk;
  constexpr int kHspan = L::kHspan, kSteps = L::kSteps;
  constexpr bool kQuant = IsQuant<KT>::value;
  extern __shared__ __align__(128) unsigned char smem[];

  const int split = blockIdx.x, s = blockIdx.y;
  const int kh0 = GROUPED ? blockIdx.z * p.KVg : 0;  // the group's first KV head
  const int m_begin = split * p.bps;

  const int nw = p.KVg * p.WK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kh = warp / p.WK, wk = warp % p.WK;  // kh within the group
  const int G = p.G;
  const int grp = lane / kLpk;   // key group of a step
  const int t = lane % kLpk;     // dims [4t, 4t + 4) of the row
  const int hl = (t / kHspan) % GP;  // the head this lane's score belongs to
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.ring_bytes);
  int* released = reinterpret_cast<int*>(full + kMaxStages);
  int* tbl = reinterpret_cast<int*>(smem + L::table_off(p.ring_bytes));
  float* pbuf = reinterpret_cast<float*>(smem + L::pbuf_off(p.ring_bytes, p.bps));

  // q, the slot's length and the run's table entries, loaded together (the
  // entries past n_live are read but never followed)
  float qr[GP][kDpl];  // slot i: head i ^ hl, scaled in fp32
#pragma unroll
  for (int i = 0; i < GP; ++i)
    if ((i ^ hl) < G)
      load_q4(p.q, p.q_dtype,
              ((size_t)s * p.H + (size_t)(kh0 + kh) * G + (i ^ hl)) * HD + t * kDpl, qr[i]);
  const int len = p.lengths[s];
  for (int i = threadIdx.x; i < min(p.bps, p.MB - m_begin); i += blockDim.x) {
    const int b = p.table[(size_t)s * p.MB + m_begin + i];
    tbl[i] = b < 0 || b >= p.NB ? 0 : b;  // a bad entry reads the null block
  }
  const int n_live = min((len + p.BS) / p.BS, p.MB);
  if (m_begin >= n_live) return;  // nothing live in this run
  const int nblk = min(n_live, m_begin + p.bps) - m_begin;
  if (threadIdx.x < kMaxStages) released[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // block i of the run into stage st: K, V (and their scale rows) in bulk.
  // One group: lane 0 alone, one copy each. Head groups: the whole warp,
  // lane 0 arming the barrier, then a lane a row of K and of V.
  auto issue = [&](int i, int st, int ln) {
    unsigned char* dst = smem + (size_t)st * p.stage_bytes;
    const size_t off = (size_t)tbl[i] * p.pool_block_bytes;
    const char* kg = static_cast<const char*>(p.k) + off;
    const char* vg = static_cast<const char*>(p.v) + off;
    const bool lead = !GROUPED || ln == 0;  // arms the barrier, copies the scales
    if (lead) mbar_expect_tx(full + st, 2 * p.block_bytes + (kQuant ? 8 * p.BS : 0));
    if constexpr (!GROUPED) {
      bulk_load(dst, kg, p.block_bytes, full + st);
      bulk_load(dst + p.block_bytes, vg, p.block_bytes, full + st);
    } else {
      __syncwarp();
      const size_t g0 = (size_t)kh0 * HD * sizeof(KT);
      for (int r = ln; r < p.BS; r += 32) {
        const size_t src = (size_t)r * p.row_bytes + g0;
        bulk_load(dst + r * p.grow_bytes, kg + src, p.grow_bytes, full + st);
        bulk_load(dst + p.block_bytes + r * p.grow_bytes, vg + src, p.grow_bytes,
                  full + st);
      }
    }
    if constexpr (kQuant) {
      if (lead) {
        float* sc = reinterpret_cast<float*>(dst + 2 * p.block_bytes);
        bulk_load(sc, p.ks + (size_t)tbl[i] * p.BS, 4 * p.BS, full + st);
        bulk_load(sc + p.BS, p.vs + (size_t)tbl[i] * p.BS, 4 * p.BS, full + st);
      }
    }
  };
  if (GROUPED ? warp == 0 : threadIdx.x == 0)
    for (int i = 0; i < min(p.stages, nblk); ++i) issue(i, i, lane);

  const int row_elems = p.KVg * HD;  // elements between two rows of a stage
  float acc[GP][kDpl];
#pragma unroll
  for (int i = 0; i < GP; ++i) {
#pragma unroll
    for (int d = 0; d < kDpl; ++d) {
      qr[i][d] = (i ^ hl) < G ? qr[i][d] * p.scale : 0.f;
      acc[i][d] = 0.f;
    }
  }
  float m_run = kNeg, l_run = 0.f;  // head hl; l over this lane's keys
  float* pw = pbuf + warp * L::kPbuf;  // [kKps][GP][kSteps] p, then [GP] alpha
  const int nchunk = (p.BS + kChunk - 1) / kChunk;

  for (int it = 0; it < nblk; ++it) {
    const int st = it % p.stages;
    mbar_wait(full + st, (it / p.stages) & 1);
    const KT* kb = reinterpret_cast<const KT*>(smem + (size_t)st * p.stage_bytes) +
                   kh * HD + t * kDpl;
    const KT* vb = reinterpret_cast<const KT*>(smem + (size_t)st * p.stage_bytes +
                                               p.block_bytes) + kh * HD + t * kDpl;
    const float* ksc = reinterpret_cast<const float*>(
        smem + (size_t)st * p.stage_bytes + 2 * p.block_bytes);
    const int pos0 = (m_begin + it) * p.BS;

    for (int c = wk; c < nchunk; c += p.WK) {
      // scores of kSteps x kKps keys; this lane ends with key kl's
      float part[kSteps][GP];
#pragma unroll
      for (int stp = 0; stp < kSteps; ++stp) {
        const int jr = min(c * kChunk + stp * kKps + grp, p.BS - 1);
        float x[kDpl];
        load4(kb + (size_t)jr * row_elems, x);
        if constexpr (kQuant) {
          const float sc = ksc[jr];
#pragma unroll
          for (int d = 0; d < kDpl; ++d) x[d] *= sc;
        }
#pragma unroll
        for (int i = 0; i < GP; ++i) {
          float a = qr[i][0] * x[0];
#pragma unroll
          for (int d = 1; d < kDpl; ++d) a = fmaf(qr[i][d], x[d], a);
          part[stp][i] = a;
        }
      }
      const int kl = lane & (kSteps - 1);
      const int j = c * kChunk + kl * kKps + grp;
      const bool valid = j < p.BS && pos0 + j <= len;
      const float score = reduce_scores<kLpk, GP, kSteps>(part, lane);  // all lanes
      const float sv = valid ? score : kNeg;
      float cmax = sv;
#pragma unroll
      for (int o = 1; o < kSteps; o <<= 1) cmax = fmaxf(cmax, __shfl_xor_sync(kFull, cmax, o));
#pragma unroll
      for (int o = kLpk; o < 32; o <<= 1) cmax = fmaxf(cmax, __shfl_xor_sync(kFull, cmax, o));
      const float m_new = fmaxf(m_run, cmax);
      const float alpha = expf(m_run - m_new);
      const float pv = valid ? expf(sv - m_new) : 0.f;
      l_run = l_run * alpha + pv;  // this lane's key
      m_run = m_new;
      if (t % kHspan < kSteps) {
        pw[(grp * GP + hl) * kSteps + kl] = pv;
        if (grp == 0 && kl == 0) pw[kKps * GP * kSteps + hl] = alpha;
      }
      __syncwarp();
      if (__any_sync(kFull, alpha < 1.f)) {
#pragma unroll
        for (int h = 0; h < GP; ++h) {
          if (h < G) {
            const float a = pw[kKps * GP * kSteps + h];
#pragma unroll
            for (int d = 0; d < kDpl; ++d) acc[h][d] *= a;
          }
        }
      }
      float ph[GP][kSteps];
#pragma unroll
      for (int h = 0; h < GP; ++h) {
        if constexpr (kSteps == 4) {
          const float4 f = *reinterpret_cast<const float4*>(pw + (grp * GP + h) * kSteps);
          ph[h][0] = f.x; ph[h][1] = f.y; ph[h][2] = f.z; ph[h][3] = f.w;
        } else {
#pragma unroll
          for (int stp = 0; stp < kSteps; ++stp) ph[h][stp] = pw[(grp * GP + h) * kSteps + stp];
        }
      }
#pragma unroll
      for (int stp = 0; stp < kSteps; ++stp) {
        const int jr = min(c * kChunk + stp * kKps + grp, p.BS - 1);
        float x[kDpl];
        load4(vb + (size_t)jr * row_elems, x);
        if constexpr (kQuant) {
          const float sc = ksc[p.BS + jr];
#pragma unroll
          for (int d = 0; d < kDpl; ++d) x[d] *= sc;
        }
#pragma unroll
        for (int h = 0; h < GP; ++h) {
          if (h < G) {
#pragma unroll
            for (int d = 0; d < kDpl; ++d) acc[h][d] = fmaf(ph[h][stp], x[d], acc[h][d]);
          }
        }
      }
      __syncwarp();  // pw is rewritten by the next chunk
    }
    // the last warp to release the stage refills it
    __syncwarp();
    if constexpr (!GROUPED) {
      if (lane == 0 && atomicAdd(released + st, 1) == nw - 1) {
        released[st] = 0;
        if (it + p.stages < nblk) issue(it + p.stages, st, 0);
      }
    } else {
      int last = 0;
      if (lane == 0) last = atomicAdd(released + st, 1) == nw - 1;
      if (__shfl_sync(kFull, last, 0)) {
        if (lane == 0) released[st] = 0;
        if (it + p.stages < nblk) issue(it + p.stages, st, lane);
      }
    }
  }

  // join the key groups of the warp (they share m), then the warps of a KV
  // head through shared memory (the ring is free once every warp is here)
#pragma unroll
  for (int o = 1; o < kSteps; o <<= 1) l_run += __shfl_xor_sync(kFull, l_run, o);
#pragma unroll
  for (int o = kLpk; o < 32; o <<= 1) {
    l_run += __shfl_xor_sync(kFull, l_run, o);
#pragma unroll
    for (int h = 0; h < GP; ++h)
#pragma unroll
      for (int d = 0; d < kDpl; ++d) acc[h][d] += __shfl_xor_sync(kFull, acc[h][d], o);
  }
  __syncthreads();
  float* mb = reinterpret_cast<float*>(smem) + (size_t)warp * L::kMerge;
  if (grp == 0) {
#pragma unroll
    for (int h = 0; h < GP; ++h) {
      if (h < G) {
        *reinterpret_cast<float4*>(mb + h * HD + t * kDpl) =
            make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
      }
    }
    if (t % kHspan == 0 && hl < G) {
      mb[GP * HD + hl] = m_run;
      mb[GP * HD + GP + hl] = l_run;
    }
  }
  __syncthreads();
  if (wk != 0) return;
  // per head the warps' weights exp(m_w - M) once (this warp's p words
  // hold them), then each element's sum over the warps by FMAs alone
  const float* mk = reinterpret_cast<const float*>(smem) + (size_t)kh * p.WK * L::kMerge;
  const size_t pbase = ((size_t)s * p.nsplit + split) * p.H + (size_t)(kh0 + kh) * G;
  float* wt = pw;  // [WK][GP]
  if (lane < G) {
    float M = kNeg;
    for (int w = 0; w < p.WK; ++w) M = fmaxf(M, mk[w * L::kMerge + GP * HD + lane]);
    float Ls = 0.f;
    for (int w = 0; w < p.WK; ++w) {
      const float* e = mk + w * L::kMerge;
      wt[w * GP + lane] = expf(e[GP * HD + lane] - M);
      Ls = fmaf(e[GP * HD + GP + lane], wt[w * GP + lane], Ls);
    }
    p.part_m[pbase + lane] = M;
    p.part_l[pbase + lane] = Ls;
  }
  __syncwarp();
  for (int i = lane; i < G * HD; i += 32) {
    const int h = i / HD, d = i - h * HD;
    float A = 0.f;
    for (int w = 0; w < p.WK; ++w) A = fmaf(mk[w * L::kMerge + h * HD + d], wt[w * GP + h], A);
    p.part_acc[(pbase + h) * HD + d] = A;
  }
}

__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    const float u = __shfl_xor_sync(kFull, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kCombineThreads / 32; ++w) v = is_max ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();
  return v;
}

// merge the live runs of (head, slot); runs past n_live never ran. Threads
// take the runs' m and l, warps the runs' accumulators (the first kUnroll
// of each warp in flight while the weights form), lanes the dims. Dynamic
// smem: m, then the weight, and l of each run. With one live run: M = m,
// its weight exp(0) = 1, L = l, A = acc exactly.
template <typename QT>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const Params p) {
  constexpr int kWarps = kCombineThreads / 32, kUnroll = 4;
  extern __shared__ float wsm[];
  float* lsm = wsm + p.nsplit;
  __shared__ float red[kWarps];
  __shared__ float asum[kWarps][128];
  const int h = blockIdx.x, s = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_live = min((p.lengths[s] + p.BS) / p.BS, p.MB);
  const int n_used = (n_live + p.bps - 1) / p.bps;
  const size_t base = (size_t)s * p.nsplit * p.H + h;  // run r at base + r * H
  float x[kUnroll][4];
  auto load_runs = [&](int r0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kWarps;
      const float* acc = p.part_acc + (base + (size_t)r * p.H) * p.hd;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[u][k] = r < n_used && lane + 32 * k < p.hd ? acc[lane + 32 * k] : 0.f;
    }
  };
  load_runs(warp);
  float M = kNeg;
  for (int r = threadIdx.x; r < n_used; r += kCombineThreads) {
    wsm[r] = p.part_m[base + (size_t)r * p.H];
    lsm[r] = p.part_l[base + (size_t)r * p.H];
    M = fmaxf(M, wsm[r]);
  }
  M = block_reduce(M, true, red);
  float Ls = 0.f;
  for (int r = threadIdx.x; r < n_used; r += kCombineThreads) {
    const float w = expf(wsm[r] - M);
    wsm[r] = w;
    Ls = fmaf(lsm[r], w, Ls);
  }
  Ls = block_reduce(Ls, false, red);  // its barrier also publishes wsm
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r0 = warp; r0 < n_used; r0 += kWarps * kUnroll) {
    if (r0 != warp) load_runs(r0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kWarps;
      const float w = r < n_used ? wsm[r] : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = fmaf(x[u][k], w, a[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (lane + 32 * k < p.hd) asum[warp][lane + 32 * k] = a[k];
  __syncthreads();
  for (int d = threadIdx.x; d < p.hd; d += kCombineThreads) {
    float A = asum[0][d];
    for (int w = 1; w < kWarps; ++w) A += asum[w][d];
    static_cast<QT*>(p.out)[((size_t)s * p.H + h) * p.hd + d] =
        from_f<QT>(A / fmaxf(Ls, 1e-30f));
  }
}

template <typename KT, int HD, int GP>
int launch_partial(Params& p, cudaStream_t st) {
  using L = Layout<HD, GP>;
  const bool grouped = p.KVg != p.KVh;
  auto kern = grouped ? decode_partial_kernel<KT, HD, GP, true>
                      : decode_partial_kernel<KT, HD, GP, false>;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(decode_partial_kernel<KT, HD, GP, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem),
      cudaFuncSetAttribute(decode_partial_kernel<KT, HD, GP, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem)};
  if (attr[grouped] != cudaSuccess) return static_cast<int>(attr[grouped]);
  if (p.KVg <= 0 || p.KVh % p.KVg != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (p.BS + L::kChunk - 1) / L::kChunk;
  p.WK = std::max(1, std::min(chunks, 8 / p.KVg));  // 8 warps a CTA where it can
  const int nw = p.KVg * p.WK;
  if (nw > (GP == 8 ? 8 : 16)) return static_cast<int>(cudaErrorInvalidValue);
  const int esize = sizeof(KT);
  p.row_bytes = p.KVh * HD * esize;
  p.pool_block_bytes = p.BS * p.row_bytes;
  p.grow_bytes = p.KVg * HD * esize;
  p.block_bytes = p.BS * p.grow_bytes;
  p.stage_bytes = (2 * p.block_bytes + (IsQuant<KT>::value ? 8 * p.BS : 0) + 127) / 128 * 128;
  // one stage past the budget still fits a CTA an SM (fp32 pools, many KV heads)
  p.stages = std::min({kMaxStages, std::max(1, kRingBudget / p.stage_bytes), p.bps});
  p.ring_bytes = std::max(p.stages * p.stage_bytes, L::merge_bytes(nw));
  const int bytes = L::bytes(p.ring_bytes, p.bps, nw);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<dim3(p.nsplit, p.S, p.KVh / p.KVg), nw * 32, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT, int HD>
int launch_gp(Params& p, cudaStream_t st) {
  if (p.G == 1) return launch_partial<KT, HD, 1>(p, st);
  if (p.G == 2) return launch_partial<KT, HD, 2>(p, st);
  if (p.G <= 8) return launch_partial<KT, HD, 8>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename KT>
int launch_kt(Params& p, cudaStream_t st) {
  if (IsQuant<KT>::value && (p.ks == nullptr || p.vs == nullptr || p.BS % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (p.hd) {
    case 32: return launch_gp<KT, 32>(p, st);
    case 64: return launch_gp<KT, 64>(p, st);
    case 128: return launch_gp<KT, 128>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename QT>
int launch_combine(const Params& p, cudaStream_t st) {
  if (2 * p.nsplit * sizeof(float) > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  decode_combine_kernel<QT><<<dim3(p.H, p.S), kCombineThreads,
                              2 * p.nsplit * sizeof(float), st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16, and for the pools
// also 3 = int8, 4 = float8_e4m3fn, which need k_scale and v_scale (NB, BS)
// fp32 (null for the other pools) and an fp32 or bf16 q. out has q's dtype.
// scale is hd^-0.5, rounded to fp32 by the caller as the reference does.
// bps: table entries per run (the caller's split plan); kvh_per_cta: the
// KV heads a CTA takes, a divisor of KVh (the caller's head-group plan;
// KVh for one group); part_m, part_l:
// (S, ceil(MB / bps), H) fp32 scratch; part_acc: the same with a trailing hd
// axis. The pools and scales start on a 16-byte boundary.
int repro_paged_attention_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const float* k_scale,
                                 const float* v_scale, const int* table,
                                 const int* lengths, float* part_m,
                                 float* part_l, float* part_acc, void* out,
                                 int S, int H, int KVh, int hd, int NB, int BS,
                                 int MB, int bps, int kvh_per_cta, float scale,
                                 int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || KVh <= 0 || H % KVh != 0 || bps <= 0 || q_dtype < 0 || q_dtype > 2 ||
      (kv_dtype >= 3 && q_dtype == 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q; p.k = k_pool; p.v = v_pool; p.ks = k_scale; p.vs = v_scale;
  p.table = table; p.lengths = lengths;
  p.part_m = part_m; p.part_l = part_l; p.part_acc = part_acc; p.out = out;
  p.S = S; p.H = H; p.KVh = KVh; p.hd = hd; p.NB = NB; p.BS = BS; p.MB = MB;
  p.bps = bps; p.nsplit = (MB + bps - 1) / bps; p.KVg = kvh_per_cta;
  p.G = H / KVh; p.q_dtype = q_dtype; p.scale = scale;
  int rc;
  switch (kv_dtype) {
    case 0: rc = launch_kt<float>(p, st); break;
    case 1: rc = launch_kt<__nv_bfloat16>(p, st); break;
    case 2: rc = launch_kt<__half>(p, st); break;
    case 3: rc = launch_kt<int8_t>(p, st); break;
    case 4: rc = launch_kt<__nv_fp8_e4m3>(p, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  switch (q_dtype) {
    case 0: return launch_combine<float>(p, st);
    case 1: return launch_combine<__nv_bfloat16>(p, st);
    default: return launch_combine<__half>(p, st);
  }
}

}  // extern "C"
