// Flash attention forward for Hopper (sm_90a), D = 64: non-causal and causal,
// any number of keys.
//
// Replaces two TPU kernels of openai_whisper_coreml_tpu/ops/flash_attention.py:
//   * K1 :_fa_kernel_single (all keys in one <= 1536 block: the encoder's
//     1500-position self-attention, and with `causal` the decoder's
//     teacher-forcing self-attention, Tq = Tk <= 448);
//   * K5 :_fa_kernel (the online-softmax kernel over several KV blocks, used
//     when Tk > 1536).
// It computes what those kernels compute, not their block structure:
//
//   q' = cast(float(q) * D^-0.5)          (exact for D = 64: a power of two)
//   S  = q' K^T                           fp32 accumulate
//   non-causal: S += -0.7 * FLT_MAX on keys >= kv_len  (additive key-padding bias)
//   causal:     S  = (key < kv_len && key <= row) ? S : -0.7 * FLT_MAX  (select)
//   P  = exp(S - rowmax(S)),  l = rowsum(P) in fp32
//   O  = cast(P) V / l                    P rounded to V's type first; l == 0 -> 1
//
// K1 scales q before the product and K5 scales S after it. With D = 64 the
// scale is 2^-3, so both are exact (q * 2^-3 rounds to q's type without
// loss, S * 2^-3 in fp32 likewise): one kernel matches both. The mask forms
// differ (K1's non-causal path adds a bias row, K5 and every causal path
// select) and give the same P: exp(MASK_VALUE - m) is 0 either way.
//
// The TPU kernels hold up to 1536 keys in one VMEM block. K and V for 1500
// keys (~384 KB in bf16) do not fit the 227 KB of shared memory a Hopper
// block may use, so here one CTA owns one (batch, head, 64-query tile) and
// walks 64-key tiles with the online softmax recurrence (running max, sum
// and accumulator in fp32): that is K5's recurrence, and it equals the
// plain softmax of K1 up to rounding, so keys beyond 1536 need no second
// kernel. In causal mode a CTA stops at the tile that holds its last row's
// diagonal: whole 64-key tiles above the diagonal are skipped, as K5's
// `should_run` skips KV blocks. Every row's first tile holds key 0, which no
// row masks, so the running max is finite from the first tile on.
//
// What bounds it on the H100: QK^T and PV are 4 * B * H * Tq * Tk * D FLOPs
// per call (about half that when causal); at the encoder's T = 1500, D = 64,
// H = 20, B = 4 that is 46 GFLOP against 3 x 4 * 1500 * 20 * 64 * 2 B = 46 MB
// of q/k/v traffic, so at full batch the kernel is tensor-core (and
// softmax-exp) bound, not memory bound. The decoder's causal T <= 448 does
// ~13x fewer operations per byte and is near the balance point. This first
// design uses warp-level mma.sync (m16n8k16 bf16 -> fp32) with K/V staged
// through shared memory by plain loads; it leaves on the table wgmma (the
// only route to Hopper's full tensor-core rate), TMA with a multi-stage
// shared-memory ring to overlap loads with math, ldmatrix in place of the
// transposed V store, exp2 with a folded log2(e), and warp specialisation.
//
// The fp32 instantiation (used for parity checks on the card) is a plain
// SIMT kernel with FMA, one query row per thread.
//
// There is no backward kernel: the TPU package has none either. Its custom
// VJP recomputes the plain attention and differentiates it, and so does the
// wrapper's autograd Function (ops/flash_attention.py).
//
// Layout: q (B, Tq, H, D), k and v (B, Tk, H, D), read through their batch,
// time and head strides (in elements; the D stride must be 1). The output
// is written with its own strides. Every entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;         // head dim (Whisper: all sizes)
constexpr int kBlockM = 64;    // query rows per CTA
constexpr int kBlockN = 64;    // keys per shared-memory tile
constexpr int kPad = 8;        // row padding (bf16 elements): conflict-free fragment reads
constexpr int kLd = kD + kPad; // 72 bf16 = 144 B per shared-memory row
constexpr float kMaskValue = -0.7f * FLT_MAX;

struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// bf16: 4 warps, each owning 16 query rows of the CTA's 64-row tile.
//
// mma.m16n8k16 fragment map (g = lane / 4, c = lane % 4):
//   A (16x16 row-major): a0 (g, 2c..2c+1)  a1 (g+8, 2c..)  a2 (g, 2c+8..)  a3 (g+8, 2c+8..)
//   B (16x8 col-major):  b0 (k=2c..2c+1, n=g)  b1 (k=2c+8.., n=g)
//   C (16x8):            c0,c1 (g, 2c..2c+1)  c2,c3 (g+8, 2c..2c+1)
// Two neighbouring 8-key C tiles of S are exactly one 16-key A fragment of
// P, so P never leaves registers between the two products.
// ---------------------------------------------------------------------------
template <bool kCausal>
__global__ void __launch_bounds__(128)
fa_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                   int tq, int tk, Strides qs, Strides ks, Strides vs, Strides os,
                   float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockN][kLd];   // [key][dim]
  __shared__ __align__(16) __nv_bfloat16 vt_s[kD][kLd];       // [dim][key] (V transposed)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kBlockM + warp * 16;
  // causal: the CTA's last row is blockIdx.x * 64 + 63; tiles starting past
  // it hold no key that any of its rows keeps
  const int key_end = kCausal ? min(tk, static_cast<int>(blockIdx.x + 1) * kBlockM) : tk;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  // Q fragments for the 4 k-steps of D = 64, pre-scaled as the TPU kernel
  // does it: upcast, multiply, round back to bf16.
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + (r & 1) * 8;
      const int col = kk * 16 + 2 * c + (r >> 1) * 8;
      float lo = 0.f, hi = 0.f;
      if (row < tq) {
        __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(qb + row * qs.t + col);
        lo = __bfloat162float(x.x) * sm_scale;
        hi = __bfloat162float(x.y) * sm_scale;
      }
      qa[kk][r] = pack_bf16(lo, hi);
    }
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};               // this thread's partial row sums

  for (int key0 = 0; key0 < key_end; key0 += kBlockN) {
    __syncthreads();  // previous tile fully consumed
    // 64 keys x 64 dims = 512 chunks of 8 bf16 (16 B); 4 per thread.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int chunk = tid + i * 128;
      const int kr = chunk / 8;
      const int d0 = (chunk % 8) * 8;
      const int key = key0 + kr;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < tk) {
        kv = *reinterpret_cast<const uint4*>(kb + key * ks.t + d0);
        vv = *reinterpret_cast<const uint4*>(vb + key * vs.t + d0);
      }
      *reinterpret_cast<uint4*>(&k_s[kr][d0]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_s[d0 + e][kr] = ve[e];
    }
    __syncthreads();

    // S = q' K^T for this warp's 16 rows x 64 keys.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&k_s[j * 8 + g][kk * 16 + 2 * c]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&k_s[j * 8 + g][kk * 16 + 8 + 2 * c]);
        mma_bf16_16816(s[j], qa[kk], b0, b1);
      }
    }

    // Key-padding bias (causal: the select mask), then the online-softmax
    // update.
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + j * 8 + 2 * c + (e & 1);
        if (kCausal) {
          const int row = row0 + g + (e >> 1) * 8;
          if (!(key < tk && key <= row)) s[j][e] = kMaskValue;
        } else if (key >= tk) {
          s[j][e] += kMaskValue;
        }
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m_run[r], tile_max[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    uint32_t pa[kBlockN / 16][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_run[e >> 1]);
        l_run[e >> 1] += s[j][e];
      }
      // C tile j -> half of A fragment j / 2 (P rounded to bf16 here).
      pa[j / 2][(j & 1) * 2 + 0] = pack_bf16(s[j][0], s[j][1]);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
    }

    // acc = acc * alpha + P V
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&vt_s[j * 8 + g][kk * 16 + 2 * c]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&vt_s[j * 8 + g][kk * 16 + 8 + 2 * c]);
        mma_bf16_16816(acc[j], pa[kk], b0, b1);
      }
    }
  }

  // Finish the row sums across the 4 threads of each row, then normalise.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = (l == 0.f) ? 1.f : 1.f / l;
  }
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    if (row >= tq) continue;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(ob + row * os.t + j * 8 + 2 * c) =
          pack_bf16(acc[j][2 * r] * inv[r], acc[j][2 * r + 1] * inv[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: one query row per thread, 64 rows per CTA, keys in chunks of 16.
// ---------------------------------------------------------------------------
template <bool kCausal>
__global__ void __launch_bounds__(kBlockM)
fa_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int tq, int tk,
                  Strides qs, Strides ks, Strides vs, Strides os, float sm_scale) {
  __shared__ float k_s[kBlockN][kD];
  __shared__ float v_s[kBlockN][kD];
  constexpr int kChunk = 16;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kBlockM + tid;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  float qr[kD], acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = row < tq ? qb[row * qs.t + d] * sm_scale : 0.f;
    acc[d] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;
  const int key_end = kCausal ? min(tk, static_cast<int>(blockIdx.x + 1) * kBlockM) : tk;

  for (int key0 = 0; key0 < key_end; key0 += kBlockN) {
    __syncthreads();
    for (int e = tid; e < kBlockN * kD; e += kBlockM) {
      const int kr = e / kD, d = e % kD, key = key0 + kr;
      k_s[kr][d] = key < tk ? kb[key * ks.t + d] : 0.f;
      v_s[kr][d] = key < tk ? vb[key * vs.t + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kBlockN; j0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < kD; ++d) dot = fmaf(qr[d], k_s[j0 + j][d], dot);
        const int key = key0 + j0 + j;
        if (kCausal) {
          if (!(key < tk && key <= row)) dot = kMaskValue;
        } else if (key >= tk) {
          dot += kMaskValue;
        }
        s[j] = dot;
        cmax = fmaxf(cmax, dot);
      }
      const float m_new = fmaxf(m_run, cmax);
      const float alpha = expf(m_run - m_new);
      m_run = m_new;
      l_run *= alpha;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - m_new);
        l_run += p;
#pragma unroll
        for (int d = 0; d < kD; ++d) acc[d] = fmaf(p, v_s[j0 + j][d], acc[d]);
      }
    }
  }
  if (row < tq) {
    const float inv = (l_run == 0.f) ? 1.f : 1.f / l_run;
    float* orow = o + b * os.b + h * os.h + row * os.t;
#pragma unroll
    for (int d = 0; d < kD; ++d) orow[d] = acc[d] * inv;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue without launching when causal is set and tq != tk
// (the mask aligns queries and keys at position 0).
int whisper_fa_forward_bf16(const void* q, const void* k, const void* v, void* o, int batch,
                            int tq, int tk, int heads, long long q_sb, long long q_st,
                            long long q_sh, long long k_sb, long long k_st, long long k_sh,
                            long long v_sb, long long v_st, long long v_sh, long long o_sb,
                            long long o_st, long long o_sh, float sm_scale, int causal,
                            void* stream) {
  if (causal && tq != tk) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((tq + kBlockM - 1) / kBlockM, heads, batch);
  auto kernel = causal ? fa_fwd_bf16_kernel<true> : fa_fwd_bf16_kernel<false>;
  kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), tq, tk,
      Strides{q_sb, q_st, q_sh}, Strides{k_sb, k_st, k_sh}, Strides{v_sb, v_st, v_sh},
      Strides{o_sb, o_st, o_sh}, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int whisper_fa_forward_f32(const void* q, const void* k, const void* v, void* o, int batch,
                           int tq, int tk, int heads, long long q_sb, long long q_st,
                           long long q_sh, long long k_sb, long long k_st, long long k_sh,
                           long long v_sb, long long v_st, long long v_sh, long long o_sb,
                           long long o_st, long long o_sh, float sm_scale, int causal,
                           void* stream) {
  if (causal && tq != tk) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((tq + kBlockM - 1) / kBlockM, heads, batch);
  auto kernel = causal ? fa_fwd_f32_kernel<true> : fa_fwd_f32_kernel<false>;
  kernel<<<grid, kBlockM, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), tq, tk, Strides{q_sb, q_st, q_sh}, Strides{k_sb, k_st, k_sh},
      Strides{v_sb, v_st, v_sh}, Strides{o_sb, o_st, o_sh}, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
