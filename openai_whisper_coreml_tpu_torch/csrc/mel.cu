// Fused log-mel frontend for Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernel openai_whisper_coreml_tpu/ops/mel_kernel.py
// :_mel_kernel. It computes what that kernel computes, per frame t of the
// reflect-padded audio x (the wrapper pads; frame t is x[160 t, 160 t + 400)):
//
//   Re[t, f] = sum_k x[160 t + k] * hann[k] * cos(2 pi k f / 400)
//   Im[t, f] = sum_k x[160 t + k] * hann[k] * -sin(2 pi k f / 400)
//   mel[t, m] = sum_f (Re^2 + Im^2)[t, f] * fb[m, f]        f < 201
//   out[t, m] = log10(max(mel[t, m], 1e-10))                 (unclamped)
//
// The per-sample max - 8 floor, the (x + 4) / 4 rescale and the transpose
// to (B, n_mels, T) stay outside, in the wrapper, as in the JAX package.
//
// What bounds it on the H100: the fidelity gate (1e-3 against fp64; the TPU
// kernel runs at Precision.HIGHEST) rules out TF32 tensor cores, so every
// product is an fp32 FMA. A frame costs 2 * 400 * 201 * 2 + 2 * 201 * n_mels
// FLOPs (~373 k at 128 mels) against 640 bytes of new audio, so the kernel is
// bound by fp32 arithmetic, not by memory: a one-hour bucket (387 k frames)
// is ~144 GFLOP, ~2 ms at the card's ~67 TFLOP/s fp32 rate, and reads 248 MB.
//
// The design, and what it does about that:
//  * One CTA owns (sample, 32 consecutive frames). It stages the frames'
//    span of audio, 31 * 160 + 400 samples, in shared memory once, so
//    overlapping frames are read from shared memory, not gathered. (The TPU
//    kernel's five shifted 80-column products avoid a strided gather on the
//    TPU; a CTA needs no such trick.) One pad float follows every 160
//    samples, so frame f's sample k sits at 161 f + k + k / 160 and the
//    frames a warp reads at one k fall in different banks.
//  * The Hann-folded cos / -sin matrices (400 x 224, zero-padded from 201
//    bins) are 717 KB together, too large for shared memory; they stream
//    from L2 in 16-row k-slices.
//  * 224 threads = 7 warps; a warp covers all 32 frames (8 groups of 4) and
//    32 bins (4 groups of 8). A thread holds Re and Im of 4 frames x 8 bins
//    (64 accumulators) in registers. Per k it reads 4 audio values and 4
//    float4 of matrix rows from shared memory for 64 FMAs; within a warp
//    those are 8 distinct banks and 4 distinct float4, so each read is one
//    shared-memory wavefront and the FMA pipes, not shared memory, set the
//    pace.
//  * The power tile (32 x 224) then reuses the slice buffer, and the mel
//    product runs as 4 frames x 4 mels per thread against the transposed
//    filterbank (201, n_mels), read as float4 through the read-only cache,
//    over only the bins where one of the 4 filters is non-zero (the wrapper
//    passes each group's [lo, hi)): ~8-12 of 201 bins, and the skipped terms
//    are exact zeros.
//  * 50,256 bytes of dynamic shared memory (above the 48 KB default, so the
//    entry point opts in).
// Left for later: 3xTF32 split products on the tensor cores, TMA and a
// multi-stage ring for the slices, larger frame tiles to cut the L2 reads.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kNfft = 400;
constexpr int kHop = 160;
constexpr int kBinsPad = 224;  // 28 groups of 8 bins, 4 per warp
constexpr int kTileT = 32;     // frames per CTA
constexpr int kSpan = (kTileT - 1) * kHop + kNfft;
constexpr int kSpanPadded = (kSpan + kSpan / kHop + 4) / 4 * 4;  // 16-byte aligned
constexpr int kSliceK = 16;  // matrix rows per staged slice; 400 = 25 x 16
constexpr int kThreads = 224;
constexpr int kSliceFloats = kSliceK * kBinsPad;  // per matrix
constexpr int kSmemBytes = (kSpanPadded + 2 * kSliceFloats) * 4;

static_assert(kNfft % kSliceK == 0, "slices must tile the DFT length");
static_assert(kThreads / 32 * 4 * 8 == kBinsPad, "a warp covers 4 groups of 8 bins");
static_assert(kTileT == 8 * 4, "a warp covers 8 groups of 4 frames");
static_assert(kTileT * kBinsPad == 2 * kSliceFloats, "power tile reuses the slice buffer");

__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float* __restrict__ audio, long long audio_stride, long long audio_len,
               int n_frames, const float* __restrict__ cw, const float* __restrict__ sw,
               const float* __restrict__ fbt, const int* __restrict__ fb_range, int n_mels,
               float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* span = smem;                 // padded audio span
  float* mats = smem + kSpanPadded;   // cos | sin slice, then the power tile

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTileT;
  const long long b = blockIdx.y;
  const long long first = static_cast<long long>(t0) * kHop;
  const float* x = audio + b * audio_stride + first;
  for (int i = tid; i < kSpan; i += kThreads) {
    span[i + i / kHop] = first + i < audio_len ? x[i] : 0.f;
  }

  const int lane = tid % 32;
  const int fg = lane / 4;                    // frames 4 fg .. 4 fg + 3 of the tile
  const int bg = 4 * (tid / 32) + lane % 4;   // bins 8 bg .. 8 bg + 7
  float re[4][8], im[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) re[i][j] = im[i][j] = 0.f;
  }

  const float4* cw4 = reinterpret_cast<const float4*>(cw);
  const float4* sw4 = reinterpret_cast<const float4*>(sw);
  float4* mats4 = reinterpret_cast<float4*>(mats);
  constexpr int kRow4 = kBinsPad / 4;
  constexpr int kSlice4 = kSliceFloats / 4;
  for (int k0 = 0; k0 < kNfft; k0 += kSliceK) {
    __syncthreads();  // the previous slice is consumed (and the span is in)
    for (int i = tid; i < kSlice4; i += kThreads) {
      mats4[i] = __ldg(cw4 + k0 * kRow4 + i);
      mats4[kSlice4 + i] = __ldg(sw4 + k0 * kRow4 + i);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kSliceK; ++kk) {
      const int k = k0 + kk;
      const float* col = span + k + k / kHop;
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = col[(4 * fg + i) * (kHop + 1)];
      const float4* crow = mats4 + kk * kRow4 + 2 * bg;
      const float4* srow = crow + kSlice4;
      const float4 c0 = crow[0], c1 = crow[1], s0 = srow[0], s1 = srow[1];
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          re[i][j] = fmaf(a[i], c[j], re[i][j]);
          im[i][j] = fmaf(a[i], s[j], im[i][j]);
        }
      }
    }
  }

  __syncthreads();  // every thread is done with the last slice
  float* power = mats;  // (kTileT, kBinsPad)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      power[(4 * fg + i) * kBinsPad + 8 * bg + j] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
    }
  }
  __syncthreads();

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
    const int hi = fb_range[2 * g + 1];
    for (int f = fb_range[2 * g]; f < hi; ++f) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(fbt + f * n_mels + m0));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = power[(4 * tg + i) * kBinsPad + f];
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
        float* o = out + (b * n_frames + t) * n_mels + m0;
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = log10f(fmaxf(acc[i][j], 1e-10f));
      }
    }
  }
}

}  // namespace

extern "C" {

// audio: (batch, audio_len) fp32 rows `audio_stride` floats apart, already
// reflect-padded (audio_len = 160 * n_frames + 400). cw, sw: (400, bins_pad)
// fp32, Hann-folded, zero beyond bin 201; bins_pad must be kBinsPad (224), or
// the call returns cudaErrorInvalidValue without launching. fbt: (201, n_mels)
// fp32, n_mels % 4 == 0. fb_range: (n_mels / 4, 2) int32, the [lo, hi) bins
// where a group of 4 filters is non-zero. out: (batch, n_frames, n_mels) fp32,
// contiguous. Launches on `stream` and returns the CUDA error (0 = cudaSuccess).
int whisper_log_mel_f32(const void* audio, long long audio_stride, long long audio_len,
                        int batch, int n_frames, const void* cw, const void* sw,
                        int bins_pad, const void* fbt, const void* fb_range, int n_mels,
                        void* out, void* stream) {
  if (bins_pad != kBinsPad) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n_frames + kTileT - 1) / kTileT, batch);
  log_mel_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), audio_stride, audio_len, n_frames,
      static_cast<const float*>(cw), static_cast<const float*>(sw),
      static_cast<const float*>(fbt), static_cast<const int*>(fb_range), n_mels,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
