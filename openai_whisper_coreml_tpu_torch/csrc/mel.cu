// Fused log-mel frontend for Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernel openai_whisper_coreml_tpu/ops/mel_kernel.py
// :_mel_kernel. It computes what that kernel computes, per frame t of the
// reflect-padded audio x (the wrapper pads; frame t is x[160 t, 160 t + 400)):
//
//   X[t, f]   = sum_k x[160 t + k] * hann[k] * exp(-2 pi i k f / 400)
//   mel[t, m] = sum_f |X[t, f]|^2 * fb[m, f]                 f < 201
//   out[t, m] = log10(max(mel[t, m], 1e-10))                 (unclamped)
//
// The per-sample max - 8 floor, the (x + 4) / 4 rescale and the transpose
// to (B, n_mels, T) stay outside, in the wrapper, as in the JAX package.
//
// The transform is a 400-point real FFT per frame, not the TPU kernel's
// dense DFT (five shifted 80-column products, which avoid a strided gather
// on the TPU; a CTA needs no such trick). Its rounding error grows as
// O(log N) ulps, the dense DFT's as O(sqrt N), so fp32 stays within the
// frontend's gate (1e-3 against fp64) where TF32 tensor cores do not. The
// real FFT is a 200-point complex FFT of z[n] = x[2n] + i x[2n+1] (window
// folded in), 200 = 8 x 25:
//
//   A  for each n2 < 25: an 8-point DFT over n1 of z[25 n1 + n2], times
//      W200^(n2 k1)                                   -> y[k1][n2]
//   B  for each k1 < 8: a 25-point DFT over n2 as 5 x 5 (n2 = 5 m1 + m2):
//      5-point DFTs over m1, times W25^(m2 j1), 5-point DFTs over m2
//                                                     -> Z[k1 + 8 (j1 + 5 j2)]
//   C  X[k] = (Z[k] + conj Z[200-k]) / 2 - i W400^k (Z[k] - conj Z[200-k]) / 2,
//      k <= 200, and the power |X[k]|^2
//
// with W_N^e = exp(-2 pi i e / N) from a table the wrapper builds in fp64
// and rounds once to fp32 (ops/mel_kernel.py:_tables, 425 twiddles and the
// Hann window: 5,000 bytes), as are the 5-point DFT's constants (W25^5,
// W25^10) and the 8-point DFT's sqrt(1/2) (W400^50), read from it.
//
// What bounds it on the H100: bytes. A frame needs ~10 k fp32 operations
// (the FFT ~9 k, the mel product over the filterbank's non-zero entries)
// against 640 bytes of new audio and 4 n_mels bytes of output: ~9 operations
// a byte, below the ~20 at which 67 TFLOP/s of fp32 outruns 3.35 TB/s.
// At (4, 480 000) x 128 the function must move 13.8 MB (>= 4.1 us).
//
// The design, one launch a call:
//  * One CTA owns (sample, 32 consecutive frames), 256 threads. It stages
//    the frames' span of audio, 31 * 160 + 400 samples (16-byte loads where
//    the rows allow), and the table in shared memory once, so overlapping
//    frames are read from shared memory.
//  * Stage A: a thread per (frame, n2), 8 complex values in registers, the
//    window applied as the samples are read (float2 reads: the even and odd
//    sample of one z); y goes to a (frame, k1, n2) buffer in shared memory.
//  * Stages B and C: a thread per (frame, k1) reads its 25 values of y and
//    runs the 25-point DFT in registers. Z[200 - k] sits in the thread of
//    k1' = (8 - k1) % 8, four lanes away or the same lane in one warp, so
//    the pairs of stage C are exchanged by warp shuffles; each thread
//    writes the power of its 25 bins into the buffer it read (after a
//    __syncthreads(): every y is in registers by then).
//  * The mel product runs as 4 frames x 4 mels per thread over only the
//    bins where one of the 4 filters is non-zero, ~8-12 of 201 (the skipped
//    terms are exact zeros): the wrapper packs each group's [lo, hi) bins'
//    4 weights as float4s (3.9 KB for all groups, against 103 KB for the
//    whole filterbank at 128 mels), read through the read-only cache.
//  * 77,640 bytes of dynamic shared memory (above the 48 KB default, so
//    the entry point opts in): 2 CTAs an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNfft = 400;
constexpr int kHop = 160;
constexpr int kTileT = 32;                            // frames per CTA
constexpr int kThreads = 8 * kTileT;                  // stage B: a thread per (frame, k1)
constexpr int kSpan = (kTileT - 1) * kHop + kNfft;    // audio samples a CTA reads
constexpr int kFrameFloats = kNfft;                   // y: 200 complex a frame; then the power
// the table: twiddles as (re, im) pairs, then the Hann window
constexpr int kTwA = 0;                               // W200^(n2 k1) at 25 k1 + n2
constexpr int kTwB = 200;                             // W25^e, e < 25
constexpr int kTwC = 225;                             // W400^k, k < 200
constexpr int kTwiddles = 425;
constexpr int kTableFloats = 2 * kTwiddles + kNfft;
constexpr int kSmemFloats = kTableFloats + kSpan + kTileT * kFrameFloats;
constexpr int kSmemBytes = kSmemFloats * 4;
// CTAs an SM holds: by shared memory, at 128 registers a thread at most
constexpr int kMinBlocks = 232448 / kSmemBytes < 512 / kThreads ? 232448 / kSmemBytes
                                                                 : 512 / kThreads;

static_assert(kSpan % 4 == 0 && kTableFloats % 2 == 0, "16-byte span, 8-byte table entries");
static_assert(kTileT % 4 == 0 && kThreads % 32 == 0, "4 frames a warp in stage B");

struct __align__(8) cf {
  float x, y;
};

__device__ __forceinline__ cf add(cf a, cf b) { return {a.x + b.x, a.y + b.y}; }
__device__ __forceinline__ cf sub(cf a, cf b) { return {a.x - b.x, a.y - b.y}; }
__device__ __forceinline__ cf mul(cf a, cf w) {
  return {fmaf(a.x, w.x, -a.y * w.y), fmaf(a.x, w.y, a.y * w.x)};
}
__device__ __forceinline__ cf mul_neg_i(cf a) { return {a.y, -a.x}; }  // -i a

// The 5-point DFT in place, X[j] = sum_m a[m] W5^(m j); c1 - i s1 = W5,
// c2 - i s2 = W5^2.
__device__ __forceinline__ void dft5(cf* a, float c1, float s1, float c2, float s2) {
  const cf b1 = add(a[1], a[4]), b4 = sub(a[1], a[4]);
  const cf b2 = add(a[2], a[3]), b3 = sub(a[2], a[3]);
  const cf r1 = {fmaf(c2, b2.x, fmaf(c1, b1.x, a[0].x)), fmaf(c2, b2.y, fmaf(c1, b1.y, a[0].y))};
  const cf r2 = {fmaf(c1, b2.x, fmaf(c2, b1.x, a[0].x)), fmaf(c1, b2.y, fmaf(c2, b1.y, a[0].y))};
  // i1 = s1 b4 + s2 b3, i2 = s2 b4 - s1 b3
  const cf i1 = {fmaf(s2, b3.x, s1 * b4.x), fmaf(s2, b3.y, s1 * b4.y)};
  const cf i2 = {fmaf(-s1, b3.x, s2 * b4.x), fmaf(-s1, b3.y, s2 * b4.y)};
  a[0] = add(a[0], add(b1, b2));
  a[1] = add(r1, mul_neg_i(i1));
  a[4] = sub(r1, mul_neg_i(i1));
  a[2] = add(r2, mul_neg_i(i2));
  a[3] = sub(r2, mul_neg_i(i2));
}

// The 8-point DFT in place (decimation in frequency), natural order in and
// out; r = sqrt(1/2).
__device__ __forceinline__ void dft8(cf* z, float r) {
  cf u[4], v[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    u[n] = add(z[n], z[n + 4]);
    v[n] = sub(z[n], z[n + 4]);
  }
  v[1] = {r * (v[1].x + v[1].y), r * (v[1].y - v[1].x)};   // W8^1 = r (1 - i)
  v[2] = mul_neg_i(v[2]);                                  // W8^2 = -i
  v[3] = {r * (v[3].y - v[3].x), -r * (v[3].x + v[3].y)};  // W8^3 = -r (1 + i)
  const cf* in[2] = {u, v};
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // a 4-point DFT of u (even bins) and of v (odd)
    const cf* y = in[h];
    const cf p0 = add(y[0], y[2]), p1 = sub(y[0], y[2]);
    const cf p2 = add(y[1], y[3]), p3 = mul_neg_i(sub(y[1], y[3]));
    z[h] = add(p0, p2);
    z[h + 2] = add(p1, p3);
    z[h + 4] = sub(p0, p2);
    z[h + 6] = sub(p1, p3);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
log_mel_kernel(const float* __restrict__ audio, long long audio_stride, long long audio_len,
               int vec4, int n_frames, const float* __restrict__ table,
               const float4* __restrict__ fb_pack, const int* __restrict__ fb_range, int n_mels,
               float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* span = smem;                          // the frames' audio
  float* buf = span + kSpan;                   // (frame, k1, n2) y, then (frame, bin) power
  float* tab = buf + kTileT * kFrameFloats;    // twiddles, then the window
  const cf* tw = reinterpret_cast<const cf*>(tab);
  const float2* win2 = reinterpret_cast<const float2*>(tab + 2 * kTwiddles);
  const float2* span2 = reinterpret_cast<const float2*>(span);
  cf* buf2 = reinterpret_cast<cf*>(buf);

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTileT;
  const long long b = blockIdx.y;
  const long long first = static_cast<long long>(t0) * kHop;
  const float* x = audio + b * audio_stride + first;
  const long long left = audio_len - first;  // samples from `first` to the row's end
  if (vec4) {  // 16-byte aligned rows
#pragma unroll 2
    for (int i = tid; i < kSpan / 4; i += kThreads) {
      float4 v;
      if (4 * i + 3 < left) {
        v = __ldg(reinterpret_cast<const float4*>(x) + i);
      } else {
        v.x = 4 * i < left ? x[4 * i] : 0.f;
        v.y = 4 * i + 1 < left ? x[4 * i + 1] : 0.f;
        v.z = 4 * i + 2 < left ? x[4 * i + 2] : 0.f;
        v.w = 0.f;
      }
      reinterpret_cast<float4*>(span)[i] = v;
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < kSpan; i += kThreads) span[i] = i < left ? x[i] : 0.f;
  }
  for (int i = tid; i < kTableFloats; i += kThreads) tab[i] = table[i];
  __syncthreads();
  const float r2 = tw[kTwC + 50].x;  // sqrt(1/2)
  const float c1 = tw[kTwB + 5].x, s1 = -tw[kTwB + 5].y;
  const float c2 = tw[kTwB + 10].x, s2 = -tw[kTwB + 10].y;

  // A: 8-point DFTs over n1, a thread per (frame, n2)
  for (int task = tid; task < kTileT * 25; task += kThreads) {
    const int f = task / 25;
    const int n2 = task - 25 * f;
    cf z[8];
#pragma unroll
    for (int n1 = 0; n1 < 8; ++n1) {
      const int h = 25 * n1 + n2;  // z[h] = x[2h] + i x[2h + 1], windowed
      const float2 s = span2[f * (kHop / 2) + h];
      const float2 w = win2[h];
      z[n1] = {s.x * w.x, s.y * w.y};
    }
    dft8(z, r2);
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1) {
      buf2[f * (kFrameFloats / 2) + 25 * k1 + n2] = mul(z[k1], tw[kTwA + 25 * k1 + n2]);
    }
  }
  __syncthreads();

  // B: a 25-point DFT a thread, (frame, k1); C: the bins' power
  const int f = tid / 8;
  const int k1 = tid % 8;
  cf a[25];
#pragma unroll
  for (int n2 = 0; n2 < 25; ++n2) a[n2] = buf2[f * (kFrameFloats / 2) + 25 * k1 + n2];
  __syncthreads();  // every y is read: the power may overwrite them
  cf t[5][5];       // [j1][m2]
#pragma unroll
  for (int m2 = 0; m2 < 5; ++m2) {
    cf c[5];
#pragma unroll
    for (int m1 = 0; m1 < 5; ++m1) c[m1] = a[5 * m1 + m2];
    dft5(c, c1, s1, c2, s2);
#pragma unroll
    for (int j1 = 0; j1 < 5; ++j1) t[j1][m2] = mul(c[j1], tw[kTwB + m2 * j1]);
  }
#pragma unroll
  for (int j1 = 0; j1 < 5; ++j1) {
    dft5(t[j1], c1, s1, c2, s2);
#pragma unroll
    for (int j2 = 0; j2 < 5; ++j2) a[j1 + 5 * j2] = t[j1][j2];  // a[k2]: Z[k1 + 8 k2]
  }
  // Z[200 - k] for k = k1 + 8 k2: Z[k1' + 8 (24 - k2)] of lane k1' = 8 - k1
  // (k1 > 0), Z[8 ((25 - k2) % 25)] of this lane (k1 = 0)
  const int lane = tid & 31;
  const int partner = (lane & ~7) | ((8 - k1) & 7);
  float* power = buf + f * kFrameFloats;
#pragma unroll
  for (int k2 = 0; k2 < 25; ++k2) {
    cf c;
    c.x = __shfl_sync(0xffffffffu, a[24 - k2].x, partner);
    c.y = __shfl_sync(0xffffffffu, a[24 - k2].y, partner);
    if (k1 == 0) c = a[(25 - k2) % 25];
    const cf z = a[k2];
    const cf e = {z.x + c.x, z.y - c.y};                // 2 E: the even samples' DFT
    const cf o = {z.y + c.y, c.x - z.x};                // 2 O: the odd samples'
    const int k = k1 + 8 * k2;
    const cf xk = add(e, mul(o, tw[kTwC + k]));         // 2 X[k]
    power[k] = 0.25f * fmaf(xk.x, xk.x, xk.y * xk.y);
    if (k == 0) {                                       // X[200] = E - O
      const cf xn = sub(e, o);
      power[200] = 0.25f * fmaf(xn.x, xn.x, xn.y * xn.y);
    }
  }
  __syncthreads();

  // the mel product and the log, 4 frames x 4 mels a task
  const int mel_groups = n_mels / 4;
  for (int task = tid; task < (kTileT / 4) * mel_groups; task += kThreads) {
    const int tg = task / mel_groups;
    const int g = task % mel_groups;
    const int m0 = 4 * g;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    const int lo = fb_range[3 * g], hi = fb_range[3 * g + 1];
    const float4* wg = fb_pack + fb_range[3 * g + 2];
    for (int bin = lo; bin < hi; ++bin) {
      const float4 w = __ldg(wg + (bin - lo));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = buf[(4 * tg + i) * kFrameFloats + bin];
        acc[i][0] = fmaf(p, w.x, acc[i][0]);
        acc[i][1] = fmaf(p, w.y, acc[i][1]);
        acc[i][2] = fmaf(p, w.z, acc[i][2]);
        acc[i][3] = fmaf(p, w.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + 4 * tg + i;
      if (t < n_frames) {
        *reinterpret_cast<float4*>(out + (b * n_frames + t) * n_mels + m0) =
            make_float4(log10f(fmaxf(acc[i][0], 1e-10f)), log10f(fmaxf(acc[i][1], 1e-10f)),
                        log10f(fmaxf(acc[i][2], 1e-10f)), log10f(fmaxf(acc[i][3], 1e-10f)));
      }
    }
  }
}

}  // namespace

extern "C" {

// audio: (batch, audio_len) fp32 rows `audio_stride` floats apart, already
// reflect-padded (audio_len = 160 * n_frames + 400). table: table_floats
// fp32, the twiddles and the Hann window in the kernel's layout (kTwA,
// kTwB, kTwC above; ops/mel_kernel.py:_tables); table_floats must be
// kTableFloats (1250), or the call returns cudaErrorInvalidValue without
// launching. n_mels % 4 == 0. fb_range: (n_mels / 4, 3) int32, for each
// group of 4 filters the [lo, hi) bins where one is non-zero and the row of
// fb_pack where its weights start; fb_pack: (sum of hi - lo, 4) fp32, the
// group's 4 weights of each of those bins, 16-byte aligned. out: (batch,
// n_frames, n_mels) fp32, contiguous, 16-byte aligned. Launches on `stream`
// and returns the CUDA error (0 = cudaSuccess).
int whisper_log_mel_f32(const void* audio, long long audio_stride, long long audio_len,
                        int batch, int n_frames, const void* table, int table_floats,
                        const void* fb_pack, const void* fb_range, int n_mels, void* out,
                        void* stream) {
  if (table_floats != kTableFloats || n_mels < 4 || n_mels % 4 || batch < 1 || n_frames < 1 ||
      batch > 65535 || reinterpret_cast<uintptr_t>(fb_pack) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n_frames + kTileT - 1) / kTileT, batch);
  log_mel_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), audio_stride, audio_len,
      reinterpret_cast<uintptr_t>(audio) % 16 == 0 && audio_stride % 4 == 0, n_frames,
      static_cast<const float*>(table), static_cast<const float4*>(fb_pack),
      static_cast<const int*>(fb_range), n_mels, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
