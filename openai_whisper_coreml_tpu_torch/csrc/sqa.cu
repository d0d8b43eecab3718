// Single-query decode attention for Hopper (sm_90a), D = 64: one kernel
// over two K/V formats, and beside it the int8 x int8 cross-attention
// kernel (K2, at the end of this file), which shares the launch arguments,
// the bounds and the block reductions.
//
// Replaces three TPU kernels:
//   K3 openai_whisper_coreml_tpu/ops/sqa_self.py:_sqa_self_kernel, over the
//      bf16 self-attention cache (B, H, D, C);
//   K6 openai_whisper_coreml_tpu/ops/sqa_int8.py:_sqa_kernel, over int8 K/V
//      (B, H, D, S) with fp32 (B, H, 1, S) column scales: int8 cross-KV
//      (S = 1500 audio positions) and the int8 self-attention cache;
//   K2 openai_whisper_coreml_tpu/ops/sqa_v3.py:_sqa3_kernel (see below).
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
// K and V are never dequantised in memory: int8 values are converted in
// registers. The TPU K6's packed (B, H*D, S) layout and block-diagonal head
// packing work around Mosaic's int8 relayout limits and are not needed here;
// both TPU kernels take scalar bounds, these take per-row bounds (continuous
// batching gives rows different positions). pos is clamped to the last
// column: a finished continuous-batching row sits at pos == total_len,
// which may equal the cache length. Masked columns are never read: their
// exp is an exact 0 in fp32 next to any real logit, so skipping them equals
// the plain versions. A row with no column in its bounds gets the plain
// versions' uniform weights over all columns.
//
// What bounds it on the H100: at large-v3 B=4, K3 over C=256 reads 5.24 MB
// (>= 1.6 us at 3.35 TB/s), K6 over the cross K/V reads 15.36 MB of int8
// and 0.96 MB of scales (>= 4.9 us). Both are below launch latency: the
// kernel pays off by replacing the ~15 small launches and the dtype copies
// of the plain sublayer, not by bandwidth. This first design: one CTA per
// (row, head); threads over columns for the logits (the d-major slice is
// contiguous in the column, so a warp's loads coalesce); logits and weights
// in shared memory (6 KB at 1500 columns); block max/sum reductions; warps
// over d and lanes over columns for P.V, finished by a shuffle reduction.
// Split-S "flash-decoding", cp.async and vector loads are left for later.
//
// Bounds arrive as (pointer, element stride, value): a null pointer means
// the same value for every row, a stride of 0 one device scalar for all.
// Every entry point takes its scalar arguments as one SqaArgs, launches on
// its stream and returns cudaGetLastError() (or cudaErrorInvalidValue
// before any launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

// The launch's scalar arguments, built by the host once per call (the
// wrappers) or once per decode step (the layer entries, which then pass
// only the layer's pointers). Strides in elements; the K/V strides are those
// of one layer's (B, H, D, S) slice, the scales' of its (B, H, 1, S) slice
// (unused by K3). Mirrored by SqaArgs in ops/sqa_int8.py.
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
};

namespace {

constexpr int kD = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 12288;  // 48 KB of fp32 logits: no opt-in needed
constexpr float kMaskValue = -0.7f * FLT_MAX;

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
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

// bf16 K or V of the self-attention cache: (B, H, D, C), no scales.
struct Bf16KV {
  const __nv_bfloat16* x;
  long long sb, sh, sd;
  __device__ __forceinline__ const __nv_bfloat16* row(int b, int h, int d) const {
    return x + b * sb + h * sh + d * sd;
  }
  __device__ __forceinline__ float scale(int, int, int) const { return 1.f; }
  // K3 rounds the normalised probabilities to bf16 before P.V
  __device__ __forceinline__ float weight(float p, int, int, int) const {
    return __bfloat162float(__float2bfloat16(p));
  }
};

// int8 K or V (B, H, D, S) with fp32 (B, H, 1, S) column scales.
struct Int8KV {
  const int8_t* x;
  const float* s;
  long long sb, sh, sd, s_sb, s_sh;
  __device__ __forceinline__ const int8_t* row(int b, int h, int d) const {
    return x + b * sb + h * sh + d * sd;
  }
  __device__ __forceinline__ float scale(int b, int h, int c) const {
    return s[b * s_sb + h * s_sh + c];
  }
  // V's column scale folds into the weights
  __device__ __forceinline__ float weight(float p, int b, int h, int c) const {
    return p * scale(b, h, c);
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

// Every thread gets the block's result; red[] is free again on return.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r += red[i];
  __syncthreads();
  return r;
}

template <typename KV, typename QT, typename OutT>
__global__ void __launch_bounds__(kThreads)
sqa_kernel(const QT* __restrict__ q, KV k, KV v, OutT* __restrict__ out, Bound pos,
           Bound valid_from, int cols, long long q_sb, long long q_sh, long long o_sb,
           long long o_sh, float sm_scale) {
  extern __shared__ float w_s[];  // [cols]: logits, then weights
  __shared__ float q_s[kD];
  __shared__ float red[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x;
  const int b = blockIdx.y;

  int lo = max(valid_from.at(b), 0);
  int hi = min(pos.at(b), cols - 1);
  const bool none = lo > hi;
  if (none) {
    lo = 0;
    hi = cols - 1;
  }

  if (tid < kD) q_s[tid] = to_float(q[b * q_sb + h * q_sh + tid]);
  __syncthreads();

  const auto* kb = k.row(b, h, 0);
  float m = -INFINITY;
  for (int c = lo + tid; c <= hi; c += kThreads) {
    float s = kMaskValue;
    if (!none) {
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < kD; ++d) dot = fmaf(q_s[d], to_float(kb[d * k.sd + c]), dot);
      s = dot * k.scale(b, h, c) * sm_scale;
    }
    w_s[c] = s;
    m = fmaxf(m, s);
  }
  m = block_max(m, red);

  float l = 0.f;
  for (int c = lo + tid; c <= hi; c += kThreads) {
    const float e = expf(w_s[c] - m);
    w_s[c] = e;
    l += e;
  }
  l = block_sum(l, red);
  for (int c = lo + tid; c <= hi; c += kThreads) w_s[c] = v.weight(w_s[c] / l, b, h, c);
  __syncthreads();

  OutT* ob = out + b * o_sb + h * o_sh;
  for (int d = warp; d < kD; d += kWarps) {
    const auto* vrow = v.row(b, h, d);
    float acc = 0.f;
    for (int c = lo + lane; c <= hi; c += 32) acc = fmaf(w_s[c], to_float(vrow[c]), acc);
    acc = warp_sum(acc);
    if (lane == 0) store(acc, ob + d);
  }
}

template <typename KV, typename QT, typename OutT>
int launch(const SqaArgs& a, const void* q, KV k, KV v, void* out) {
  if (a.batch < 1 || a.heads < 1 || a.cols < 1 || a.cols > kMaxCols || a.batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sqa_kernel<KV, QT, OutT><<<dim3(a.heads, a.batch), kThreads, a.cols * sizeof(float),
                             static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const QT*>(q), k, v, static_cast<OutT*>(out),
      Bound{static_cast<const int*>(a.pos), a.pos_stride, a.pos_value},
      Bound{static_cast<const int*>(a.valid_from), a.vf_stride, a.vf_value}, a.cols, a.q_sb,
      a.q_sh, a.o_sb, a.o_sh, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K2: single-query cross-attention with an int8 query (ops/sqa_v3.py).
//
// The TPU kernel's arithmetic, in its order, with the query's row
// quantisation and the scale fold that JAX runs in XLA outside the kernel
// fused in (one warp reduction over D = 64 instead of ~6 launches):
//
//   qs    = max(max_d |q| / 127, 1e-12)              per (row, head)
//   q8    = clip(rint(q / qs), +-127)                round half to even
//   s[c]  = (float(int32 q8 . k8[:, c]) * (k_scale[c] * qs)) * D^-0.5
//   p     = exp(s - max s), denom = sum p, pv = p * v_scale[c]
//   av_int8:  wmax = max(max pv, 1e-20); w8 = clip(rint(pv * (127 / wmax)))
//             out = (float(int32 w8 . v8[d, :]) * (wmax / 127)) / denom
//   else:     out = (sum bf16(pv) * v8[d, :], fp32) / denom
//
// Columns outside [valid_from, pos] (the 1500 -> 1536 lane padding: pos =
// s_len - 1, valid_from = 0) take the TPU kernel's -0.7 FLT_MAX logit, whose
// weight is an exact 0; they are never read. The int32 sums are exact: the
// QK dot is at most 64 * 127^2, the A.V sum 1500 * 127^2 < 2^31.
//
// What bounds it on the H100: at (4, 20, 64, 1500 of 1536) it must read
// 15.36 MB of int8 K/V and 0.96 MB of scales (>= 4.9 us at 3.35 TB/s); its
// ~3.1e7 int8 operations are negligible. Byte-bound like K6, whose design it
// follows: one CTA per (row, head), threads over columns for the logits
// (coalesced along the d-major slice), fp32 logits and weights in shared
// memory, block reductions, warps over d for A.V. dp4a or mma int8, split-S,
// vector loads and cp.async are later work.

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename QT, bool kAvInt8>
__global__ void __launch_bounds__(kThreads)
sqa_v3_kernel(const QT* __restrict__ q, Int8KV k, Int8KV v, QT* __restrict__ out, Bound pos,
              Bound valid_from, int cols, long long q_sb, long long q_sh, long long o_sb,
              long long o_sh, float sm_scale) {
  extern __shared__ float w_s[];  // [cols]: logits, then weights (w8 as floats)
  __shared__ int q8_s[kD];
  __shared__ float qs_s;
  __shared__ float red[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // the wrapper passes 0 <= valid_from <= pos < cols
  const int lo = max(valid_from.at(b), 0);
  const int hi = min(pos.at(b), cols - 1);

  if (warp == 0) {  // quantize_q_rows; IEEE division (no fast math)
    const QT* qb = q + b * q_sb + h * q_sh;
    const float x0 = to_float(qb[lane]);
    const float x1 = to_float(qb[lane + 32]);
    const float qs = fmaxf(warp_max(fmaxf(fabsf(x0), fabsf(x1))) / 127.f, 1e-12f);
    q8_s[lane] = static_cast<int>(fminf(fmaxf(rintf(x0 / qs), -127.f), 127.f));
    q8_s[lane + 32] = static_cast<int>(fminf(fmaxf(rintf(x1 / qs), -127.f), 127.f));
    if (lane == 0) qs_s = qs;
  }
  __syncthreads();
  const float qs = qs_s;

  const int8_t* kb = k.row(b, h, 0);
  float m = -INFINITY;
  for (int c = lo + tid; c <= hi; c += kThreads) {
    int dot = 0;
#pragma unroll 16
    for (int d = 0; d < kD; ++d) dot += q8_s[d] * static_cast<int>(kb[d * k.sd + c]);
    const float s = (static_cast<float>(dot) * (k.scale(b, h, c) * qs)) * sm_scale;
    w_s[c] = s;
    m = fmaxf(m, s);
  }
  m = block_max(m, red);

  float l = 0.f;
  float wmax = 0.f;  // pv >= 0
  for (int c = lo + tid; c <= hi; c += kThreads) {
    const float p = expf(w_s[c] - m);
    l += p;
    const float pv = p * v.scale(b, h, c);
    w_s[c] = pv;
    wmax = fmaxf(wmax, pv);
  }
  l = block_sum(l, red);
  if constexpr (kAvInt8) {
    wmax = fmaxf(block_max(wmax, red), 1e-20f);
    const float r = 127.f / wmax;
    for (int c = lo + tid; c <= hi; c += kThreads) {
      w_s[c] = fminf(fmaxf(rintf(w_s[c] * r), -127.f), 127.f);
    }
  }
  __syncthreads();

  QT* ob = out + b * o_sb + h * o_sh;
  for (int d = warp; d < kD; d += kWarps) {
    const int8_t* vrow = v.row(b, h, d);
    if constexpr (kAvInt8) {
      int acc = 0;
      for (int c = lo + lane; c <= hi; c += 32) {
        acc += static_cast<int>(w_s[c]) * static_cast<int>(vrow[c]);
      }
      acc = warp_sum_int(acc);
      if (lane == 0) store(static_cast<float>(acc) * (wmax / 127.f) / l, ob + d);
    } else {
      float acc = 0.f;
      for (int c = lo + lane; c <= hi; c += 32) {
        acc = fmaf(__bfloat162float(__float2bfloat16(w_s[c])), static_cast<float>(vrow[c]),
                   acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) store(acc / l, ob + d);
    }
  }
}

template <typename QT, bool kAvInt8>
int launch_v3(const SqaArgs& a, const void* q, Int8KV k, Int8KV v, void* out) {
  if (a.batch < 1 || a.heads < 1 || a.cols < 1 || a.cols > kMaxCols || a.batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sqa_v3_kernel<QT, kAvInt8><<<dim3(a.heads, a.batch), kThreads, a.cols * sizeof(float),
                               static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const QT*>(q), k, v, static_cast<QT*>(out),
      Bound{static_cast<const int*>(a.pos), a.pos_stride, a.pos_value},
      Bound{static_cast<const int*>(a.valid_from), a.vf_stride, a.vf_value}, a.cols, a.q_sb,
      a.q_sh, a.o_sb, a.o_sh, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K6. q and out (B, H, 64) in one type (bf16 or fp32); k8, v8 (B, H, 64, S)
// int8 and k_scale, v_scale (B, H, 1, S) fp32, unit column strides.
#define WHISPER_SQA_INT8_ENTRY(NAME, T)                                                         \
  int NAME(const SqaArgs* a, const void* q, const void* k8, const void* k_scale, const void* v8, \
           const void* v_scale, void* out) {                                                    \
    const Int8KV k{static_cast<const int8_t*>(k8), static_cast<const float*>(k_scale), a->k_sb, \
                   a->k_sh, a->k_sd, a->ks_sb, a->ks_sh};                                       \
    const Int8KV v{static_cast<const int8_t*>(v8), static_cast<const float*>(v_scale), a->v_sb, \
                   a->v_sh, a->v_sd, a->vs_sb, a->vs_sh};                                       \
    return launch<Int8KV, T, T>(*a, q, k, v, out);                                              \
  }

WHISPER_SQA_INT8_ENTRY(whisper_sqa_int8_bf16, __nv_bfloat16)
WHISPER_SQA_INT8_ENTRY(whisper_sqa_int8_f32, float)

// K3. q (B, H, 64) bf16, k and v (B, H, 64, C) bf16 with unit column
// stride; out (B, H, 64) bf16 or fp32.
#define WHISPER_SQA_SELF_ENTRY(NAME, OutT)                                                    \
  int NAME(const SqaArgs* a, const void* q, const void* k, const void* v, void* out) {        \
    const Bf16KV kk{static_cast<const __nv_bfloat16*>(k), a->k_sb, a->k_sh, a->k_sd};         \
    const Bf16KV vv{static_cast<const __nv_bfloat16*>(v), a->v_sb, a->v_sh, a->v_sd};         \
    return launch<Bf16KV, __nv_bfloat16, OutT>(*a, q, kk, vv, out);                           \
  }

WHISPER_SQA_SELF_ENTRY(whisper_sqa_self_bf16, __nv_bfloat16)
WHISPER_SQA_SELF_ENTRY(whisper_sqa_self_f32, float)

// K2. q and out (B, H, 64) in one type (bf16 or fp32); k8, v8 (B, H, 64, S)
// int8 and k_scale, v_scale (B, H, 1, S) fp32, unit column strides; the
// bounds carry s_len; av_int8 != 0 takes the int8 A.V product.
#define WHISPER_SQA_V3_ENTRY(NAME, T)                                                           \
  int NAME(const SqaArgs* a, int av_int8, const void* q, const void* k8, const void* k_scale,   \
           const void* v8, const void* v_scale, void* out) {                                    \
    const Int8KV k{static_cast<const int8_t*>(k8), static_cast<const float*>(k_scale), a->k_sb, \
                   a->k_sh, a->k_sd, a->ks_sb, a->ks_sh};                                       \
    const Int8KV v{static_cast<const int8_t*>(v8), static_cast<const float*>(v_scale), a->v_sb, \
                   a->v_sh, a->v_sd, a->vs_sb, a->vs_sh};                                       \
    return av_int8 ? launch_v3<T, true>(*a, q, k, v, out)                                       \
                   : launch_v3<T, false>(*a, q, k, v, out);                                     \
  }

WHISPER_SQA_V3_ENTRY(whisper_sqa_v3_bf16, __nv_bfloat16)
WHISPER_SQA_V3_ENTRY(whisper_sqa_v3_f32, float)

#undef WHISPER_SQA_INT8_ENTRY
#undef WHISPER_SQA_SELF_ENTRY
#undef WHISPER_SQA_V3_ENTRY

}  // extern "C"
