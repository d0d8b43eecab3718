// Single-query decode attention for Hopper (sm_90a), D = 64: one kernel
// body over two K/V formats and three modes, launched as two kernels
// (sqa_kernel for K3 and K6, sqa_v3_kernel for K2) that share the launch
// arguments, the column split, the staging and the exchanges.
//
// Replaces three TPU kernels:
//   K3 openai_whisper_coreml_tpu/ops/sqa_self.py:_sqa_self_kernel, over the
//      bf16 self-attention cache (B, H, D, C);
//   K6 openai_whisper_coreml_tpu/ops/sqa_int8.py:_sqa_kernel, over int8 K/V
//      (B, H, D, S) with fp32 (B, H, 1, S) column scales: int8 cross-KV
//      (S = 1500 audio positions) and the int8 self-attention cache;
//   K2 openai_whisper_coreml_tpu/ops/sqa_v3.py:_sqa3_kernel, the same int8
//      K/V with an int8 query (see "K2" below).
// One decode step's query per (row, head) attends the slice in its stored
// d-major layout, columns valid_from <= c <= pos with per-row bounds:
//
//   s[c] = (q . k[:, c]) * k_scale[c] * D^-0.5   fp32 (K3: bf16 q and K, no
//                                                 scale)
//   s[c] = -0.7 * FLT_MAX outside [valid_from, pos]
//   p    = exp(s - max s) / sum                  fp32
//   w    = p * v_scale[c]  (K6) or bf16(p) (K3: the TPU kernel rounds P
//          to bf16 before P.V)
//   out  = w . v                                 fp32, written as OutT
//
// K2 computes what the TPU kernel computes, in its order, with the query's
// row quantisation and the scale fold that JAX runs in XLA outside the
// kernel fused in:
//
//   qs    = max(max_d |q| / 127, 1e-12)              per (row, head)
//   q8    = clip(rint(q / qs), +-127)                round half to even
//   s[c]  = (float(q8 . k8[:, c]) * (k_scale[c] * qs)) * D^-0.5
//   p     = exp(s - max s), l = sum p, pv = p * v_scale[c]
//   av_int8:  wmax = max(max pv, 1e-20); w8 = clip(rint(pv * (127 / wmax)))
//             out = (float(int32 w8 . v8[d, :]) * (wmax / 127)) / l
//   else:     out = (sum bf16(pv) * v8[d, :], fp32) / l
//
// The Q.K dot is at most 64 * 127^2 < 2^24, so the fp32 products of K6's
// logit loop give the int32 dot's bits in any order. The int8 A.V sum
// (1500 * 127^2 > 2^24) is not exact in fp32: it runs on dp4a in int32 and
// the CTAs' 64-vectors are added as int32, exact in any order.
//
// K and V are never dequantised in memory: int8 values are converted in
// registers. The TPU K6's packed (B, H*D, S) layout and block-diagonal head
// packing work around Mosaic's int8 relayout limits and are not needed here;
// both TPU kernels take scalar bounds, these take per-row bounds (continuous
// batching gives rows different positions). pos is clamped to the last
// column: a finished continuous-batching row sits at pos == total_len,
// which may equal the cache length. Masked columns never enter the
// arithmetic: their exp is an exact 0 in fp32 next to any real logit, so
// leaving them out equals the plain versions (K2: columns past s_len, the
// 1500 -> 1536 lane padding, are never read). A row with no column in its
// bounds gets the plain versions' uniform weights over all columns.
//
// What bounds it on the H100: bytes. At large-v3 B=4, K6 over the cross K/V
// reads 15.36 MB of int8 and 0.96 MB of scales (>= 4.9 us at 3.35 TB/s),
// K3 over C=256 reads 5.24 MB (>= 1.6 us); each does ~4 operations per byte.
// K2 reads what K6 reads.
//
// The design, one launch a call: the grid is (splits, heads, batch) with
// thread-block clusters of (splits, 1, 1). The CTAs of a cluster split the
// row's [lo, hi] into contiguous slices of whole 32-bit words (16-byte
// vectors where rows and slices start on 16-byte boundaries), balanced per
// row; a CTA whose slice is empty reads nothing. Loads: all of a slice is
// put in flight at once into shared memory by bulk copies (the TMA's
// non-tensor form), one a K or V row, K's rows and both scale rows counted
// on one mbarrier and V's on a second, so V lands while the logits and the
// softmax run. A row of the int8 cross-KV is 1500 bytes, 4-byte aligned
// only: each copy takes the 16-byte granules that hold the row's columns
// and the arithmetic starts at the row's offset in its first granule (rows
// off 4-byte boundaries take plain loads). Logits: warp w multiplies d rows
// 16w..16w+15 (q in registers; K2: every CTA quantises the same 64 values
// to the same q8, so the prologue needs no exchange) with lanes over the
// slice's words, int8 turned into fp32 by a byte permute and one add. The
// combine goes over distributed shared memory, in the same launch: (1) each
// warp's (max, sum) pair is written into every CTA of the cluster; after
// cluster.sync() every warp folds the row's pairs in one fixed order,
// m = max m_i and l = sum l_i exp(m_i - m) (an empty slice's pair is
// (-inf, 0) and adds 0), so the weights are normalised before P.V, as K3's
// bf16 rounding of P needs (K2 divides by l at the end, as its plain
// version does); (K2 with int8 A.V) each warp's largest weight, taken with
// the row's m, is written into every CTA and the row's wmax is their max
// after one more cluster barrier: a max does not depend on order, so wmax
// and every code are the plain version's; (2) P.V over the slice, a thread
// per (d row, half of the columns), into rank 0's shared memory; after a
// second cluster.sync() rank 0 adds the CTAs' 64-vectors in rank order and
// writes the output. No atomics: the same inputs give the same bits. The
// split count is a rule (split_count below, from the sweep) or a count the
// caller passes in SqaArgs. What holds it above the bound on the H100
// (PERF.md): the chain of dependent steps a CTA runs after its loads
// (products, softmax, the cluster barriers), not the bytes.
//
// Bounds arrive as (pointer, element stride, value): a null pointer means
// the same value for every row, a stride of 0 one device scalar for all.
// Every entry point takes its scalar arguments as one SqaArgs, launches on
// its stream and returns cudaGetLastError() (or cudaErrorInvalidValue
// before any launch: a shape past the column limit, a split count past the
// largest cluster, or a slice larger than shared memory holds).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

// The launch's scalar arguments, built by the host once per call (the
// wrappers) or once per decode step (the layer entries, which then pass
// only the layer's pointers). Strides in elements; the K/V strides are those
// of one layer's (B, H, D, S) slice, the scales' of its (B, H, 1, S) slice
// (unused by K3). splits: the cluster size, 0 for the rule. Mirrored by
// SqaArgs in ops/sqa_int8.py.
struct SqaArgs {
  const void* pos;
  long long pos_stride;
  const void* valid_from;
  long long vf_stride;
  long long q_sb, q_sh, k_sb, k_sh, k_sd, ks_sb, ks_sh, v_sb, v_sh, v_sd, vs_sb, vs_sh, o_sb,
      o_sh;
  void* stream;
  int pos_value, vf_value, batch, heads, cols;
  float sm_scale;
  int splits;
};

namespace {

namespace cg = cooperative_groups;

constexpr int kD = 64;
constexpr float kMaskValue = -0.7f * FLT_MAX;

// Threads a CTA, the column limits (K3/K6; K2, whose rule's clusters of 16
// stage 768 columns a CTA at its limit) and the largest cluster.
constexpr int kSqaThreads = 128;
constexpr int kSqaWarps = kSqaThreads / 32;
constexpr int kSqaMaxCols = 4096;
constexpr int kV3MaxCols = 12288;
constexpr int kMaxSplits = 16;

// What the kernel body computes: K3/K6's attention, or K2's with an int8
// query and bf16 or int8 weights for A.V.
enum class Mode { kAttend, kQ8AvBf16, kQ8AvInt8 };

// The split rule, from the sweep on the H100 (PERF.md): the largest power
// of two up to 8 that keeps the grid within kGridCtas CTAs and the slices
// at kMinSliceCols columns or more, raised to the smallest power of two
// that leaves at most kMaxSliceCols columns a CTA. rows = batch * heads.
// Mirrored by ops/sqa_int8.split_count.
constexpr int kGridCtas = 320;
constexpr int kMinSliceCols = 56;
constexpr int kMaxSliceCols = 384;

int split_count(int cols, int rows) {
  int s = 1;
  while (s < 8 && 2 * s * rows <= kGridCtas && 2 * s * kMinSliceCols <= cols) s *= 2;
  while (s < kMaxSplits && s * kMaxSliceCols < cols) s *= 2;
  return s;
}

// Columns [c0, c1) of cluster rank `rank`: [lo, hi] widened to whole
// vectors of vc columns, cut into `splits` contiguous runs of vectors whose
// lengths differ by one at most. Mirrored by ops/sqa_int8.slice_bounds.
__device__ __forceinline__ void slice_of(int lo, int hi, int vc, int splits, int rank, int& c0,
                                         int& c1) {
  const int v0 = lo / vc;
  const int n = hi / vc + 1 - v0;
  c0 = (v0 + n * rank / splits) * vc;
  c1 = (v0 + n * (rank + 1) / splits) * vc;
}

struct Bound {
  const int* ptr;
  long long stride;
  int value;
  __device__ __forceinline__ int at(int row) const {
    return ptr ? ptr[row * stride] : value;
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

// bf16 K or V of the self-attention cache: (B, H, D, C), no scales.
struct Bf16KV {
  using T = __nv_bfloat16;
  static constexpr int kBytes = 2;
  static constexpr int kPerWord = 2;
  static constexpr bool kScaled = false;
  const __nv_bfloat16* x;
  long long sb, sh, sd;
  __device__ __forceinline__ const __nv_bfloat16* row(int b, int h, int d) const {
    return x + b * sb + h * sh + d * sd;
  }
  // two bf16 of a 32-bit word, low column first
  __device__ __forceinline__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  // K3 rounds the normalised probabilities to bf16 before P.V
  __device__ __forceinline__ static float weight_of(float p, float) {
    return __bfloat162float(__float2bfloat16(p));
  }
};

// int8 K or V (B, H, D, S) with fp32 (B, H, 1, S) column scales.
struct Int8KV {
  using T = int8_t;
  static constexpr int kBytes = 1;
  static constexpr int kPerWord = 4;
  static constexpr bool kScaled = true;
  const int8_t* x;
  const float* s;
  long long sb, sh, sd, s_sb, s_sh;
  __device__ __forceinline__ const int8_t* row(int b, int h, int d) const {
    return x + b * sb + h * sh + d * sd;
  }
  __device__ __forceinline__ const float* scales(int b, int h) const {
    return s + b * s_sb + h * s_sh;
  }
  // four int8 of a 32-bit word, low column first, exactly: the byte with
  // its sign bit flipped (x + 128) becomes the low mantissa byte of
  // 2^23 = 0x4B000000, and 2^23 + 128 comes off again
  __device__ __forceinline__ static void unpack(uint32_t w, float* f) {
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + e)) - 8388736.f;
    }
  }
  // V's column scale folds into the weights
  __device__ __forceinline__ static float weight_of(float p, float v_scale) {
    return p * v_scale;
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// The kernel body

// The launch's plan, made by the host from SqaArgs and the pointers.
struct SqaPlan {
  Bound pos, valid_from;
  long long q_sb, q_sh, o_sb, o_sh;
  float sm_scale;
  int cols, splits;
  int windows;  // 1: K/V rows start on 4-byte boundaries, staged as 16-byte windows
                // by bulk copies
  int pv16;     // 1: every row and slice starts on a 16-byte boundary (16-byte P.V reads)
  int bulk_scales;  // 1: scale rows staged by bulk copies (16-byte aligned); 0: plain loads
  int vc;       // columns a slice boundary is a multiple of
  int cap;      // the most columns a slice can have
  int pitch;    // bytes per staged K or V row: an odd number of 16-byte vectors
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// Raise the bytes the barrier's phase waits for (no arrival).
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the barrier's first phase. A wait that never ends traps, so it
// surfaces as a launch error instead of a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// One bulk copy (the TMA's non-tensor form): 16-byte aligned ends, a
// multiple of 16 bytes, completing on the barrier's transaction count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The cluster barrier in halves: an arrival that orders nothing (every CTA
// has started), and the wait that completes a phase.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Byte offset of column c0 of row d inside its staged window: rows staged
// as 16-byte windows keep their address's place in a 16-byte granule.
__device__ __forceinline__ int window_shift(const unsigned char* row_c0, int windows) {
  return windows ? static_cast<int>(reinterpret_cast<uintptr_t>(row_c0) & 15) : 0;
}

// The slice's columns [c0, c0 + n) of K or V rows 0..63 into shared memory,
// rows `pitch` apart. Windows: one bulk copy a row (lane l of the calling
// warp takes rows l and l + 32) of the 16-byte granules that hold the
// row's columns, counted on `bar` (a granule that holds an owned byte never
// crosses a page, and the bytes beside the columns never enter the
// arithmetic). load_rows, for rows off 4-byte boundaries, is plain loads
// by the whole CTA: only columns inside [lo, hi], 0 elsewhere.
template <typename KV>
__device__ __forceinline__ void stage_rows(const KV& kv, int b, int h, int c0, int n,
                                           unsigned char* dst, uint32_t bar, const SqaPlan& p) {
  const int nbytes = n * KV::kBytes;
  const int lane = threadIdx.x & 31;
  uint32_t bytes[2];
  const unsigned char* src[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    src[i] = reinterpret_cast<const unsigned char*>(kv.row(b, h, lane + 32 * i) + c0);
    const int shift = window_shift(src[i], 1);
    src[i] -= shift;
    bytes[i] = static_cast<uint32_t>((shift + nbytes + 15) & ~15);
  }
  mbar_expect_tx(bar, bytes[0] + bytes[1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) bulk_copy(smem_u32(dst + (lane + 32 * i) * p.pitch), src[i], bytes[i], bar);
}

template <typename KV>
__device__ __forceinline__ void load_rows(const KV& kv, int b, int h, int c0, int n, int lo,
                                          int hi, unsigned char* dst, const SqaPlan& p) {
  using T = typename KV::T;
  for (int d = threadIdx.x >> 5; d < kD; d += kSqaWarps) {
    const T* r = kv.row(b, h, d);
    T* out = reinterpret_cast<T*>(dst + d * p.pitch);
    for (int j = threadIdx.x & 31; j < n; j += 32) {
      const int c = c0 + j;
      out[j] = (c >= lo && c <= hi) ? r[c] : T(0);
    }
  }
}

// Column scales [c0, c0 + n): one bulk copy on `bar` (16-byte aligned
// scale rows), or plain loads of those before the last column.
__device__ __forceinline__ void stage_scales(const float* src, int c0, int n, float* dst,
                                             uint32_t bar) {
  mbar_expect_tx(bar, 4 * n);
  bulk_copy(smem_u32(dst), src + c0, 4 * n, bar);
}

__device__ __forceinline__ void load_scales(const float* src, int c0, int n, int cols,
                                            float* dst) {
  for (int j = threadIdx.x; j < min(n, cols - c0); j += kSqaThreads) dst[j] = src[c0 + j];
}

// Zero the staged V columns of [c0, c0 + n) that lie outside [lo, hi]: at
// most a vector's worth at each end of the row's range.
template <typename KV>
__device__ __forceinline__ void zero_masked_ends(const KV& v, int b, int h, unsigned char* v_s,
                                                 int c0, int n, int lo, int hi,
                                                 const SqaPlan& p) {
  using T = typename KV::T;
  const int left = min(max(lo - c0, 0), n);
  const int right = min(max(hi + 1 - c0, 0), n);  // columns [right, n) are past hi
  const int per_row = left + (n - right);
  for (int i = threadIdx.x; i < kD * per_row; i += kSqaThreads) {
    const int d = i / per_row;
    const int k = i - d * per_row;
    const int shift =
        window_shift(reinterpret_cast<const unsigned char*>(v.row(b, h, d) + c0), p.windows);
    reinterpret_cast<T*>(v_s + d * p.pitch + shift)[k < left ? k : right + (k - left)] = T(0);
  }
}

// One thread's share of P.V: a staged row (n columns from its first byte)
// against the weights w, every kParts-th vector of kVec bytes from `part`
// on, two vectors in flight; one accumulator per column of a 32-bit word,
// added in a fixed order.
template <typename KV, int kVec, int kParts>
__device__ __forceinline__ float pv_part(const unsigned char* row, const float* w, int n,
                                         int part) {
  constexpr int kWords = kVec / 4;
  constexpr int kCols = kVec / KV::kBytes;
  float acc[KV::kPerWord] = {};
  const int nv = n / kCols;
#pragma unroll 2
  for (int u = part; u < nv; u += kParts) {
    uint32_t words[kWords];
    if constexpr (kVec == 16) {
      const uint4 x = *reinterpret_cast<const uint4*>(row + u * 16);
      words[0] = x.x, words[1] = x.y, words[2] = x.z, words[3] = x.w;
    } else {
      words[0] = *reinterpret_cast<const uint32_t*>(row + u * 4);
    }
    float wu[kCols];
    if constexpr (kCols % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kCols / 4; ++i) {
        const float4 x = reinterpret_cast<const float4*>(w + u * kCols)[i];
        wu[4 * i] = x.x, wu[4 * i + 1] = x.y, wu[4 * i + 2] = x.z, wu[4 * i + 3] = x.w;
      }
    } else {
      const float2 x = *reinterpret_cast<const float2*>(w + u * kCols);
      wu[0] = x.x, wu[1] = x.y;
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      float f[KV::kPerWord];
      KV::unpack(words[i], f);
#pragma unroll
      for (int e = 0; e < KV::kPerWord; ++e) {
        acc[e] = fmaf(wu[i * KV::kPerWord + e], f[e], acc[e]);
      }
    }
  }
  float r = acc[0];
#pragma unroll
  for (int e = 1; e < KV::kPerWord; ++e) r += acc[e];
  return r;
}

// K2's int8 A.V share of one thread: a staged int8 V row against the int8
// codes w8, every kParts-th vector of kCols bytes from `part` on, on dp4a:
// four products a 32-bit word, summed in int32 (exact in any order).
template <int kCols, int kParts>
__device__ __forceinline__ int pv_part_int8(const unsigned char* row, const int8_t* w8, int n,
                                            int part) {
  int acc = 0;
  const int nv = n / kCols;
#pragma unroll 2
  for (int u = part; u < nv; u += kParts) {
    if constexpr (kCols == 16) {
      const int4 x = *reinterpret_cast<const int4*>(row + u * 16);
      const int4 w = *reinterpret_cast<const int4*>(w8 + u * 16);
      acc = __dp4a(x.x, w.x, acc);
      acc = __dp4a(x.y, w.y, acc);
      acc = __dp4a(x.z, w.z, acc);
      acc = __dp4a(x.w, w.w, acc);
    } else {
      acc = __dp4a(*reinterpret_cast<const int*>(row + u * 4),
                   *reinterpret_cast<const int*>(w8 + u * 4), acc);
    }
  }
  return acc;
}

// (m, l) += (m2, l2): both sums rescaled to the larger max and added (an
// empty pair, l = 0, adds 0)
__device__ __forceinline__ void combine(float& m, float& l, float m2, float l2) {
  const float mx = fmaxf(m, m2);
  l = (l > 0.f ? l * expf(m - mx) : 0.f) + (l2 > 0.f ? l2 * expf(m2 - mx) : 0.f);
  m = mx;
}

// Every lane gets the warp's pair: the largest max, and each lane's sum
// rescaled to it and added (one exp a lane; an empty pair adds 0).
__device__ __forceinline__ void warp_combine(float& m, float& l) {
  const float mx = warp_max(m);
  l = warp_sum(l > 0.f ? l * expf(m - mx) : 0.f);
  m = mx;
}

constexpr int kRowsPerWarp = kD / kSqaWarps;  // multiplied by one warp

template <typename KV, typename QT, typename OutT, Mode kMode>
__device__ __forceinline__ void sqa_body(const QT* __restrict__ q, const KV& k, const KV& v,
                                         OutT* __restrict__ out, const SqaPlan& p) {
  constexpr int kParts = kSqaThreads / kD;
  constexpr bool kQ8 = kMode != Mode::kAttend;  // K2
  constexpr bool kAv8 = kMode == Mode::kQ8AvInt8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float pair_s[2][kMaxSplits * kSqaWarps];  // every warp's (max, sum) of the row
  __shared__ float wmax_s[kAv8 ? kMaxSplits * kSqaWarps : 1];  // every warp's largest weight
  __shared__ float pvp_s[kParts][kD];  // int32 bits with int8 A.V
  __shared__ uint64_t bar_s[2];  // K and the scales; V

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  int lo = max(p.valid_from.at(b), 0);
  int hi = min(p.pos.at(b), p.cols - 1);
  const bool none = lo > hi;
  if (none) {
    lo = 0;
    hi = p.cols - 1;
  }
  int c0, c1;
  slice_of(lo, hi, p.vc, p.splits, rank, c0, c1);
  const int n = c1 - c0;  // 0: an empty slice

  unsigned char* k_s = smem;
  unsigned char* v_s = smem + kD * p.pitch;
  // [warps][cap] partial dots; row 0 then holds the logits, then the weights
  float* part_s = reinterpret_cast<float*>(smem + 2 * kD * p.pitch);
  float* s_s = part_s;
  float* ks_s = part_s + kSqaWarps * p.cap;  // [cap] (K6, K2)
  float* vs_s = ks_s + p.cap;                // [cap] (K6, K2)
  // [cap] K2's int8 weights, in row 1 of the partial dots once they are added
  [[maybe_unused]] int8_t* w8_s = reinterpret_cast<int8_t*>(part_s + p.cap);
  // [splits][64] on rank 0: every CTA's share of the output, written after
  // exchange one, when K is no longer read
  float* pv_s = reinterpret_cast<float*>(k_s);

  // every load in flight: warp 0 puts K's rows and the scales on one
  // barrier, warp 1 V's rows on a second (element loads: the whole CTA)
  const uint32_t bar_k = smem_u32(&bar_s[0]);
  const uint32_t bar_v = smem_u32(&bar_s[1]);
  if (tid == 0) {
    mbar_init(bar_k);
    mbar_init(bar_v);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (n > 0 && p.windows && warp < 2) {
    if (warp == 0) {
      if (!none) stage_rows(k, b, h, c0, n, k_s, bar_k, p);
      if constexpr (KV::kScaled) {
        if (p.bulk_scales && lane == 0 && !none) stage_scales(k.scales(b, h), c0, n, ks_s, bar_k);
        if (p.bulk_scales && lane == 1) stage_scales(v.scales(b, h), c0, n, vs_s, bar_k);
      }
    } else {
      stage_rows(v, b, h, c0, n, v_s, bar_v, p);
    }
    __syncwarp();
  }
  if (tid == 0) mbar_arrive(bar_k);
  if (tid == 32) mbar_arrive(bar_v);
  if (n > 0 && !p.windows) {
    if (!none) load_rows(k, b, h, c0, n, lo, hi, k_s, p);
    load_rows(v, b, h, c0, n, lo, hi, v_s, p);
  }
  if constexpr (KV::kScaled) {
    if (n > 0 && !p.bulk_scales) {
      if (!none) load_scales(k.scales(b, h), c0, n, p.cols, ks_s);
      load_scales(v.scales(b, h), c0, n, p.cols, vs_s);
    }
  }
  if (!p.windows || (KV::kScaled && !p.bulk_scales)) __syncthreads();  // plain loads are in
  cluster_arrive_relaxed();  // waited for before the first write to a peer

  // K2: the query's row scale, in every warp (IEEE division: no fast math)
  const QT* qb = q + b * p.q_sb + h * p.q_sh;
  [[maybe_unused]] float qs = 1.f;
  if constexpr (kQ8) {
    qs = warp_max(fmaxf(fabsf(to_float(qb[lane])), fabsf(to_float(qb[lane + 32]))));
    qs = fmaxf(qs / 127.f, 1e-12f);
  }

  // partial dots: warp w over its 16 d rows (q in registers), lanes over
  // the slice's 32-bit words
  const int words = n * KV::kBytes / 4;
  if (!none && n > 0) {
    const int d0 = warp * kRowsPerWarp;
    float qd[kRowsPerWarp];
    int off[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      qd[i] = to_float(qb[d0 + i]);
      if constexpr (kQ8) qd[i] = fminf(fmaxf(rintf(qd[i] / qs), -127.f), 127.f);
      off[i] = (d0 + i) * p.pitch +
               window_shift(reinterpret_cast<const unsigned char*>(k.row(b, h, d0 + i) + c0),
                            p.windows);
    }
    mbar_wait(bar_k);
    for (int u = lane; u < words; u += 32) {
      float acc[KV::kPerWord] = {};
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        float f[KV::kPerWord];
        KV::unpack(*reinterpret_cast<const uint32_t*>(k_s + off[i] + 4 * u), f);
#pragma unroll
        for (int e = 0; e < KV::kPerWord; ++e) acc[e] = fmaf(qd[i], f[e], acc[e]);
      }
#pragma unroll
      for (int e = 0; e < KV::kPerWord; ++e) {
        part_s[warp * p.cap + u * KV::kPerWord + e] = acc[e];
      }
    }
  }
  mbar_wait(bar_k);  // the scales
  __syncthreads();

  // this slice's logits (-inf outside [lo, hi]: in no sum), each thread's
  // (max, sum) over its columns, then each warp's
  float m = -INFINITY, l = 0.f;
  for (int j = tid; j < n; j += kSqaThreads) {
    const int c = c0 + j;
    float s = -INFINITY;
    if (c >= lo && c <= hi) {
      if (none) {
        s = kMaskValue;
      } else {
        float dot = part_s[j];  // overwritten by the logit below, in this thread
#pragma unroll
        for (int i = 1; i < kSqaWarps; ++i) dot += part_s[i * p.cap + j];
        if constexpr (kQ8) {
          dot *= ks_s[j] * qs;  // the plain version folds k_scale * qs first
        } else if constexpr (KV::kScaled) {
          dot *= ks_s[j];
        }
        s = dot * p.sm_scale;
      }
      if (s > m) {  // one exp a column: rescale the sum when the max moves
        l = l * expf(m - s) + 1.f;
        m = s;
      } else {
        l += expf(s - m);
      }
    }
    s_s[j] = s;
  }
  warp_combine(m, l);

  // exchange one: every warp's pair into every CTA of the cluster; then
  // every warp folds the row's pairs in one fixed order, the same in every
  // warp of every CTA
  cluster_wait();  // every CTA of the cluster has started
  if (lane < p.splits) {
    float* peer = cluster.map_shared_rank(&pair_s[0][0], lane);
    peer[rank * kSqaWarps + warp] = m;
    peer[kMaxSplits * kSqaWarps + rank * kSqaWarps + warp] = l;
  }
  cluster.sync();  // exchange one
  float row_m = -INFINITY, row_l = 0.f;
  for (int i = lane; i < p.splits * kSqaWarps; i += 32) {
    combine(row_m, row_l, pair_s[0][i], pair_s[1][i]);
  }
  warp_combine(row_m, row_l);

  // the weights: normalised by the row's sum (K3, K6), or K2's pv (the sum
  // divides the output)
  [[maybe_unused]] float wmax = 0.f;  // K2, int8 A.V: this thread's largest weight (pv >= 0)
  for (int j = tid; j < n; j += kSqaThreads) {
    const float s = s_s[j];
    float w = 0.f;
    if (s != -INFINITY) {
      if constexpr (kQ8) {
        w = expf(s - row_m) * vs_s[j];
        if constexpr (kAv8) {
          wmax = fmaxf(wmax, w);
        } else {
          w = __bfloat162float(__float2bfloat16(w));
        }
      } else {
        w = KV::weight_of(expf(s - row_m) / row_l, KV::kScaled ? vs_s[j] : 1.f);
      }
    }
    s_s[j] = w;
  }
  // K2, int8 A.V: every warp's largest weight into every CTA; the row's
  // wmax is their max, then the codes w8 = clip(rint(pv * (127 / wmax)))
  [[maybe_unused]] float row_wmax = 0.f;
  if constexpr (kAv8) {
    wmax = warp_max(wmax);
    if (lane < p.splits) cluster.map_shared_rank(wmax_s, lane)[rank * kSqaWarps + warp] = wmax;
    cluster.sync();  // the row's largest weight
    row_wmax = 1e-20f;
    for (int i = 0; i < p.splits * kSqaWarps; ++i) row_wmax = fmaxf(row_wmax, wmax_s[i]);
    const float r = 127.f / row_wmax;
    for (int j = tid; j < n; j += kSqaThreads) {
      w8_s[j] = static_cast<int8_t>(fminf(fmaxf(rintf(s_s[j] * r), -127.f), 127.f));
    }
  }
  mbar_wait(bar_v);
  __syncthreads();
  zero_masked_ends(v, b, h, v_s, c0, n, lo, hi, p);
  __syncthreads();

  // exchange two: P.V over the slice, a thread per (d, part), into rank 0's
  // shared memory; rank 0 adds the CTAs' 64-vectors in rank order (int8
  // A.V: int32, exact in any order)
  {
    const int d = tid % kD;
    const int part = tid / kD;
    const unsigned char* row =
        v_s + d * p.pitch +
        window_shift(reinterpret_cast<const unsigned char*>(v.row(b, h, d) + c0), p.windows);
    if constexpr (kAv8) {
      pvp_s[part][d] = __int_as_float(p.pv16 ? pv_part_int8<16, kParts>(row, w8_s, n, part)
                                             : pv_part_int8<4, kParts>(row, w8_s, n, part));
    } else {
      pvp_s[part][d] = p.pv16 ? pv_part<KV, 16, kParts>(row, s_s, n, part)
                              : pv_part<KV, 4, kParts>(row, s_s, n, part);
    }
  }
  __syncthreads();
  if (tid < kD) {
    float r = pvp_s[0][tid];
#pragma unroll
    for (int i = 1; i < kParts; ++i) {
      r = kAv8 ? __int_as_float(__float_as_int(r) + __float_as_int(pvp_s[i][tid]))
               : r + pvp_s[i][tid];
    }
    cluster.map_shared_rank(pv_s, 0)[rank * kD + tid] = r;
  }
  cluster.sync();  // exchange two
  if (rank == 0 && tid < kD) {
    OutT* o = out + b * p.o_sb + h * p.o_sh + tid;
    if constexpr (kAv8) {
      int acc = 0;
      for (int r = 0; r < p.splits; ++r) acc += __float_as_int(pv_s[r * kD + tid]);
      store(static_cast<float>(acc) * (row_wmax / 127.f) / row_l, o);
    } else {
      float sum = 0.f;
      for (int r = 0; r < p.splits; ++r) sum += pv_s[r * kD + tid];
      store(kQ8 ? sum / row_l : sum, o);
    }
  }
}

// K3 and K6.
template <typename KV, typename QT, typename OutT>
__global__ void __launch_bounds__(kSqaThreads)
sqa_kernel(const QT* __restrict__ q, KV k, KV v, OutT* __restrict__ out, SqaPlan p) {
  sqa_body<KV, QT, OutT, Mode::kAttend>(q, k, v, out, p);
}

// K2: a kernel of its own name, so a profile tells its launches from K6's.
template <typename QT, bool kAvInt8>
__global__ void __launch_bounds__(kSqaThreads)
sqa_v3_kernel(const QT* __restrict__ q, Int8KV k, Int8KV v, QT* __restrict__ out, SqaPlan p) {
  sqa_body<Int8KV, QT, QT, kAvInt8 ? Mode::kQ8AvInt8 : Mode::kQ8AvBf16>(q, k, v, out, p);
}

bool aligned(const void* ptr, long long sb, long long sh, long long sd, int elem, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0 && (sb * elem) % bytes == 0 &&
         (sh * elem) % bytes == 0 && (sd * elem) % bytes == 0;
}

// A kernel's attributes, set once: the opt-in shared memory and clusters
// past the portable 8. Returns the dynamic shared memory a launch may take,
// or minus the CUDA error.
int configure(const void* fn) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  const int dyn = optin - static_cast<int>(attr.sharedSizeBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err == cudaSuccess ? dyn : -static_cast<int>(err);
}

// One launch of kernel kFn (sqa_kernel or sqa_v3_kernel) over rows of at
// most max_cols columns, split as SqaArgs says or by the rule's `rule_splits`.
template <typename KV, typename QT, typename OutT,
          void (*kFn)(const QT*, KV, KV, OutT*, SqaPlan)>
int launch(const SqaArgs& a, int max_cols, int rule_splits, const void* q, KV k, KV v,
           void* out) {
  if (a.batch < 1 || a.heads < 1 || a.cols < 1 || a.cols > max_cols || a.batch > 65535 ||
      a.heads > 65535 || a.splits < 0 || a.splits > kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const int max_dyn = configure(reinterpret_cast<const void*>(kFn));
  if (max_dyn < 0) return -max_dyn;
  SqaPlan p;
  p.pos = Bound{static_cast<const int*>(a.pos), a.pos_stride, a.pos_value};
  p.valid_from = Bound{static_cast<const int*>(a.valid_from), a.vf_stride, a.vf_value};
  p.q_sb = a.q_sb, p.q_sh = a.q_sh, p.o_sb = a.o_sb, p.o_sh = a.o_sh;
  p.sm_scale = a.sm_scale;
  p.cols = a.cols;
  p.splits = a.splits ? a.splits : rule_splits;
  constexpr int e = KV::kBytes;
  // rows on 4-byte boundaries are staged in 16-byte windows; on 16-byte
  // boundaries with 16-byte slices P.V reads 16 bytes at a time (K3 at
  // (8, 20, 64, 448) 8-11% faster than with 4-byte reads on the H100, PERF.md)
  p.windows = aligned(k.x, k.sb, k.sh, k.sd, e, 4) && aligned(v.x, v.sb, v.sh, v.sd, e, 4);
  p.pv16 = aligned(k.x, k.sb, k.sh, k.sd, e, 16) && aligned(v.x, v.sb, v.sh, v.sd, e, 16) &&
           (static_cast<long long>(a.cols) * e) % 16 == 0;
  p.vc = (p.pv16 ? 16 : 4) / e;
  p.bulk_scales = 0;
  if constexpr (KV::kScaled) {
    // bulk copies of scales need slices on 4-column boundaries (windows)
    // and 16-byte aligned (b, h) scale rows
    p.bulk_scales = p.windows && aligned(k.s, k.s_sb, k.s_sh, 0, 4, 16) &&
                    aligned(v.s, v.s_sb, v.s_sh, 0, 4, 16);
  }
  const int vectors = (a.cols + p.vc - 1) / p.vc;
  p.cap = (vectors + p.splits - 1) / p.splits * p.vc;
  // a window may start 15 bytes early; K's rows hold rank 0's [splits][64]
  // shares of the output at the end
  const int row_vectors = max((15 + p.cap * e + 15) / 16, kMaxSplits * kD * 4 / (16 * kD));
  p.pitch = (row_vectors | 1) * 16;  // odd: a warp's 16-byte V reads hit distinct banks
  const size_t smem = 2 * static_cast<size_t>(kD) * p.pitch +
                      static_cast<size_t>(p.cap) * (kSqaWarps + 2) * sizeof(float);
  if (smem > static_cast<size_t>(max_dyn)) return static_cast<int>(cudaErrorInvalidValue);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, a.heads, a.batch);
  cfg.blockDim = dim3(kSqaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(a.stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = p.splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kFn, static_cast<const QT*>(q), k, v,
                                             static_cast<OutT*>(out), p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The split rule, for the wrappers' mirror to be held against.
int whisper_sqa_split_count(int cols, int rows) { return split_count(cols, rows); }

// K6. q and out (B, H, 64) in one type (bf16 or fp32); k8, v8 (B, H, 64, S)
// int8 and k_scale, v_scale (B, H, 1, S) fp32, unit column strides.
#define WHISPER_SQA_INT8_ENTRY(NAME, T)                                                         \
  int NAME(const SqaArgs* a, const void* q, const void* k8, const void* k_scale, const void* v8, \
           const void* v_scale, void* out) {                                                    \
    const Int8KV k{static_cast<const int8_t*>(k8), static_cast<const float*>(k_scale), a->k_sb, \
                   a->k_sh, a->k_sd, a->ks_sb, a->ks_sh};                                       \
    const Int8KV v{static_cast<const int8_t*>(v8), static_cast<const float*>(v_scale), a->v_sb, \
                   a->v_sh, a->v_sd, a->vs_sb, a->vs_sh};                                       \
    return launch<Int8KV, T, T, sqa_kernel<Int8KV, T, T>>(                                      \
        *a, kSqaMaxCols, split_count(a->cols, a->batch * a->heads), q, k, v, out);              \
  }

WHISPER_SQA_INT8_ENTRY(whisper_sqa_int8_bf16, __nv_bfloat16)
WHISPER_SQA_INT8_ENTRY(whisper_sqa_int8_f32, float)

// K3. q (B, H, 64) bf16, k and v (B, H, 64, C) bf16 with unit column
// stride; out (B, H, 64) bf16 or fp32.
#define WHISPER_SQA_SELF_ENTRY(NAME, OutT)                                                    \
  int NAME(const SqaArgs* a, const void* q, const void* k, const void* v, void* out) {        \
    const Bf16KV kk{static_cast<const __nv_bfloat16*>(k), a->k_sb, a->k_sh, a->k_sd};         \
    const Bf16KV vv{static_cast<const __nv_bfloat16*>(v), a->v_sb, a->v_sh, a->v_sd};         \
    return launch<Bf16KV, __nv_bfloat16, OutT, sqa_kernel<Bf16KV, __nv_bfloat16, OutT>>(     \
        *a, kSqaMaxCols, split_count(a->cols, a->batch * a->heads), q, kk, vv, out);          \
  }

WHISPER_SQA_SELF_ENTRY(whisper_sqa_self_bf16, __nv_bfloat16)
WHISPER_SQA_SELF_ENTRY(whisper_sqa_self_f32, float)

// K2. q and out (B, H, 64) in one type (bf16 or fp32); k8, v8 (B, H, 64, S)
// int8 and k_scale, v_scale (B, H, 1, S) fp32, unit column strides, S <=
// 12288; the bounds carry s_len; av_int8 != 0 takes the int8 A.V product.
#define WHISPER_SQA_V3_ENTRY(NAME, T)                                                           \
  int NAME(const SqaArgs* a, int av_int8, const void* q, const void* k8, const void* k_scale,   \
           const void* v8, const void* v_scale, void* out) {                                    \
    const Int8KV k{static_cast<const int8_t*>(k8), static_cast<const float*>(k_scale), a->k_sb, \
                   a->k_sh, a->k_sd, a->ks_sb, a->ks_sh};                                       \
    const Int8KV v{static_cast<const int8_t*>(v8), static_cast<const float*>(v_scale), a->v_sb, \
                   a->v_sh, a->v_sd, a->vs_sb, a->vs_sh};                                       \
    const int rule = split_count(a->cols, a->batch * a->heads);                                 \
    return av_int8 ? launch<Int8KV, T, T, sqa_v3_kernel<T, true>>(*a, kV3MaxCols, rule, q, k, v, \
                                                                  out)                          \
                   : launch<Int8KV, T, T, sqa_v3_kernel<T, false>>(*a, kV3MaxCols, rule, q, k,  \
                                                                   v, out);                     \
  }

WHISPER_SQA_V3_ENTRY(whisper_sqa_v3_bf16, __nv_bfloat16)
WHISPER_SQA_V3_ENTRY(whisper_sqa_v3_f32, float)

#undef WHISPER_SQA_INT8_ENTRY
#undef WHISPER_SQA_SELF_ENTRY
#undef WHISPER_SQA_V3_ENTRY

}  // extern "C"
