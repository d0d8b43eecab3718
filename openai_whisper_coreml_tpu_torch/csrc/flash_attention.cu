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
// block may use, so one CTA owns one (batch, head, query tile) and walks key
// tiles with the online softmax recurrence (running max, sum and
// accumulator in fp32): that is K5's recurrence, and it equals the plain
// softmax of K1 up to rounding, so keys beyond 1536 need no second kernel.
//
// What bounds it on the H100: QK^T and PV are 4 * B * H * Tq * Tk * D FLOPs
// per call (about half that when causal); at the encoder's T = 1500, H = 20,
// B = 4 that is 46 GFLOP against 46 MB of q/k/v/o (0.047 ms at the bf16
// tensor-core peak, 0.014 ms at the HBM rate): operations, not bytes. At
// D = 64 each score also costs one exp2 on the SFU (16 a clock per SM), and
// that takes as long as its 256 tensor-core FLOPs: so the kernel is bound by
// the tensor cores and the exponentials together, and can reach about half
// the tensor-core peak only where the two fully overlap. Measured, the
// softmax's instructions (an FFMA, exp2, max, sum and half a bf16 pack per
// score) take nearly all of the time and the products hide under them
// (PERF.md). The decoder's causal T <= 448 does ~13x fewer operations per
// byte; there latency (the first tile's load, the epilogue) dominates.
//
// The bf16 design (fa_fwd_bf16_kernel), one CTA per SM (its registers fill
// the SM):
//   * one producer warpgroup, of which one thread issues TMA loads
//     (cp.async.bulk.tensor) of Q once and of K/V tiles of kBlockN keys into
//     a ring of kStages shared-memory stages, each signalled on an mbarrier
//     with expect_tx; the consumers free a stage on a second mbarrier. The
//     tensor maps are 4-D over (D, H, T, B) with boxes of (64, 1, rows, 1),
//     so a ragged last tile is zero-filled inside its own batch and never
//     reads the next batch's rows or past the allocation; keys >= Tk are
//     still masked, because a zero K row scores 0, not -inf. The producer
//     gives up registers (setmaxnreg) to the consumers;
//   * three consumer warpgroups of 64 query rows each (a query tile of 192
//     rows, so each K/V tile read from L2 serves 192 queries). Each scales
//     its Q rows in shared memory (q * 2^-3, exact), then per tile issues
//     S = Q'K^T as wgmma.mma_async (both operands from shared memory with
//     the 128-byte swizzle: one bf16 row of D = 64 is 128 bytes) and O += P V
//     as wgmma.mma_async with P from registers (the S accumulator packed to
//     bf16 is the A fragment) and V read in place as an MN-major operand
//     (the transpose flag for 16-bit types), so V is never transposed by
//     hand. The warpgroups run unsynchronised, so one's
//     softmax overlaps another's products;
//   * the softmax uses exp2 with log2(e) folded into one FFMA, s*c - m*c, on
//     the fp32 S (not into q: q * 2^-3 is exact in bf16, q * log2(e) / 8 is
//     not); the non-causal bias is applied only on the tile that holds Tk,
//     the causal select only on tiles that cross a row of the warpgroup's
//     diagonal, and whole tiles past a warpgroup's last row are skipped.
//     A warpgroup whose rows all lie past Tq still waits for and frees every
//     stage, so the ring's phases stay in step.
// ptxas compiles the kernel within the 128 registers a thread has at launch
// (512 threads), and spills 16-24 bytes there.
// Tried and measured slower on the H100 (PERF.md): a 128-row query tile,
// issuing S of tile j+1 beside P V of tile j in one warpgroup, warpgroups
// taking turns on named barriers or starting staggered, a persistent grid
// walking tiles, and 64-key or three-stage rings.
//
// The fp32 instantiation (used for parity checks on the card) is a plain
// SIMT kernel with FMA, one query row per thread.
//
// There is no backward kernel: the TPU package has none either. Its custom
// VJP recomputes the plain attention and differentiates it, and so does the
// wrapper's autograd Function (ops/flash_attention.py).
//
// Layout: q (B, Tq, H, D), k and v (B, Tk, H, D), read through their batch,
// time and head strides (in elements; the D stride must be 1; for bf16 every
// stride a multiple of 8 elements and the bases 16-byte aligned, as TMA
// needs). The output is written with its own strides. Every entry point
// launches on the given stream and returns cudaGetLastError(), or an error
// without launching. The tensor maps are encoded per call by
// cuTensorMapEncodeTiled, looked up through the CUDA runtime
// (cudaGetDriverEntryPointByVersion), so the library links no libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;  // head dim (Whisper: all sizes)
constexpr float kMaskValue = -0.7f * FLT_MAX;

struct Strides {
  long long b, t, h;
};

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma + TMA.
// ---------------------------------------------------------------------------
constexpr int kBlockN = 128;       // keys per shared-memory stage
constexpr int kStages = 2;         // K/V ring depth
constexpr int kRowBytes = kD * 2;  // one bf16 row of D = 64: the 128-byte swizzle span
constexpr int kKVBytes = kBlockN * kRowBytes;
constexpr float kLog2e = 1.4426950408889634f;

// A CTA: kConsumers consumer warpgroups (64 query rows each) and one
// producer warpgroup.
constexpr int kConsumers = 3;
constexpr int kBlockM = 64 * kConsumers;  // query rows per CTA
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kQBytes = kBlockM * kRowBytes;
// + 1024: the dynamic base is rounded up to the 1024-byte swizzle period
constexpr int kSmemBytes = 1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 2 * kStages);
// setmaxnreg budgets: the producer keeps few registers, the consumers take
// the rest of the SM's 65,536 (one CTA per SM)
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536,
              "register budgets exceed the SM");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait that never ends
// (a broken ring) traps, so it surfaces as a launch error instead of a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a tile of 128-byte rows written by TMA
// with the 128-byte swizzle (1024-byte aligned): start address >> 4, leading
// byte offset 1 (unused: one swizzle atom spans all of D = 64), stride byte
// offset 1024 B between groups of 8 rows, layout type 1 = 128-byte swizzle.
// The same descriptor reads the tile K-major (Q, K: rows along M or N) and
// MN-major (V: rows along K, with the transpose flag).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until every committed wgmma group of this warpgroup is done.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins registers that a wgmma reads or writes, so the compiler moves no
// access to them across the fence, commit and wait that bracket the product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 128, fp32) = A (64 x 16) B (16 x 128), A and B K-major in shared memory,
// D's old value unused (scale-d 0): its registers are written, not read
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(0)
      : "memory");
}

// D (64 x 128, fp32) += A (64 x 16) B (16 x 128), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
}

// D (64 x 64, fp32) += A (64 x 16, registers) B (16 x 64), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

// wgmma m64nN accumulator map (warp w of the warpgroup, g = lane / 4,
// c = lane % 4): d[4j + e] is row 16w + g + 8 (e >> 1), column 8j + 2c + (e & 1).
// The register A fragment of m64k16 has the same rows: a[0] = row g, columns
// 2c..2c+1; a[1] = row g + 8; a[2], a[3] the same 8 columns on. So S's
// columns 16kk..16kk+15 (d[8kk .. 8kk+7]) packed to bf16 are P's fragment kk.

// Masks a tile of scores for this thread's two rows: non-causal adds the bias
// to keys >= tk; causal sets every key past tk or past the row to the mask.
template <bool kCausal>
__device__ __forceinline__ void mask_tile(float (&s)[kBlockN / 2], int key0, int row_a, int tk,
                                          int c) {
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 8 * j + 2 * c + (e & 1);
      if (kCausal) {
        const int row = row_a + 8 * (e >> 1);
        if (!(key < tk && key <= row)) s[4 * j + e] = kMaskValue;
      } else if (key >= tk) {
        s[4 * j + e] += kMaskValue;
      }
    }
  }
}

// The online-softmax step on one tile of (masked) scores for this thread's
// two rows (s[4j + e] is row e >> 1): updates the running max and sum,
// leaves P = exp2(s * log2e - m * log2e) (one FFMA a score) in s and the
// accumulator's rescale factor in alpha.
__device__ __forceinline__ void softmax_tile(float (&s)[kBlockN / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2]) {
  float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) {
    tile_max[(i >> 1) & 1] = fmaxf(tile_max[(i >> 1) & 1], s[i]);
  }
  float neg_mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
    const float m_new = fmaxf(m_run[r], tile_max[r]);
    neg_mc[r] = -m_new * kLog2e;
    alpha[r] = exp2f(fmaf(m_run[r], kLog2e, neg_mc[r]));
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) {
    const float x = exp2f(fmaf(s[i], kLog2e, neg_mc[(i >> 1) & 1]));
    l_run[(i >> 1) & 1] += x;
    s[i] = x;
  }
}

// P (fp32 in s) rounded to bf16 into the register A fragments of P V, as the
// plain version rounds it.
__device__ __forceinline__ void pack_p(const float (&s)[kBlockN / 2],
                                       uint32_t (&p)[kBlockN / 16][4]) {
#pragma unroll
  for (int jn = 0; jn < kBlockN / 8; ++jn) {
    p[jn / 2][(jn & 1) * 2 + 0] = pack_bf16(s[4 * jn + 0], s[4 * jn + 1]);
    p[jn / 2][(jn & 1) * 2 + 1] = pack_bf16(s[4 * jn + 2], s[4 * jn + 3]);
  }
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
                   int tq, int tk, Strides os, float sm_scale) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* const q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* const k_s = q_s + kQBytes;             // kStages tiles of kBlockN rows
  uint8_t* const v_s = k_s + kStages * kKVBytes;  // likewise
  uint64_t* const bars = reinterpret_cast<uint64_t*>(v_s + kStages * kKVBytes);
  const uint32_t q_full = smem_u32(bars);
  const uint32_t full0 = smem_u32(bars + 1);             // stage s: + 8 s
  const uint32_t empty0 = smem_u32(bars + 1 + kStages);  // stage s: + 8 s

  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // causal: no row of the CTA keeps a key past its last row
  const int key_end = kCausal ? min(tk, m0 + kBlockM) : tk;
  const int n_tiles = (key_end + kBlockN - 1) / kBlockN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kQBytes);
      tma_load_4d(smem_u32(q_s), &q_map, q_full, 0, h, m0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t full = full0 + 8 * s;
        // the first pass over the ring finds every stage free
        mbar_wait(empty0 + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * kKVBytes);
        tma_load_4d(smem_u32(k_s + s * kKVBytes), &k_map, full, 0, h, j * kBlockN, b);
        tma_load_4d(smem_u32(v_s + s * kKVBytes), &v_map, full, 0, h, j * kBlockN, b);
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns query rows wg_row0 .. wg_row0 + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int c = lane % 4;
  const int wg_row0 = m0 + 64 * cw;
  const int row_a = wg_row0 + 16 * (tid / 32) + lane / 4;  // and row_a + 8
  uint8_t* const my_q = q_s + cw * 64 * kRowBytes;

  // q' = bf16(float(q) * scale) in place: 64 rows of 128 B, 16 B a chunk.
  mbar_wait(q_full, 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint4* chunk = reinterpret_cast<uint4*>(my_q) + tid + 128 * i;
    uint4 x = *chunk;
    uint32_t* words = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&words[e]));
      words[e] = pack_bf16(f.x * sm_scale, f.y * sm_scale);
    }
    *chunk = x;
  }
  // the writes above are read next by wgmma, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  const uint64_t q_desc = desc_sw128(smem_u32(my_q));

  // Tiles this warpgroup computes: none if all its rows lie past tq; causal,
  // none past its last row. It still waits for and frees the others.
  int my_tiles = n_tiles;
  if (wg_row0 >= tq) {
    my_tiles = 0;
  } else if (kCausal) {
    my_tiles = (min(tk, wg_row0 + 64) + kBlockN - 1) / kBlockN;
  }

  float o_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
  float s_acc[kBlockN / 2];
  uint32_t p[kBlockN / 16][4];
  float m_run[2] = {-INFINITY, -INFINITY};  // rows row_a and row_a + 8
  float l_run[2] = {0.f, 0.f};               // this thread's partial row sums
  float alpha[2];

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(full0 + 8 * s, (j / kStages) & 1);
    if (j < my_tiles) {
      const int key0 = j * kBlockN;
      // S = q' K^T: 4 k-steps of 16 over D = 64, 32 B apart in the swizzled
      // rows. The first overwrites S, so S's registers are free between tiles.
      const uint64_t k_desc = desc_sw128(smem_u32(k_s + s * kKVBytes));
      wgmma_fence();
      wgmma_ss_n128_first(s_acc, q_desc, k_desc);
#pragma unroll
      for (int kk = 1; kk < kD / 16; ++kk) {
        wgmma_ss_n128(s_acc, q_desc + 2 * kk, k_desc + 2 * kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s_acc);

      const bool masked = kCausal ? (key0 + kBlockN - 1 > wg_row0 || key0 + kBlockN > tk)
                                  : key0 + kBlockN > tk;
      if (masked) mask_tile<kCausal>(s_acc, key0, row_a, tk, c);
      softmax_tile(s_acc, m_run, l_run, alpha);
      pack_p(s_acc, p);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        o_acc[4 * jn + 0] *= alpha[0];
        o_acc[4 * jn + 1] *= alpha[0];
        o_acc[4 * jn + 2] *= alpha[1];
        o_acc[4 * jn + 3] *= alpha[1];
      }

      // O += P V: V's rows are the k dimension, 16 keys (2048 B) a step.
      const uint64_t v_desc = desc_sw128(smem_u32(v_s + s * kKVBytes));
      fence_regs(o_acc);
      fence_regs(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_rs_n64_tb(o_acc, p[kk], v_desc + 128 * kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
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
    const int row = row_a + 8 * r;
    if (row >= tq) continue;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      *reinterpret_cast<uint32_t*>(ob + row * os.t + 8 * jn + 2 * c) =
          pack_bf16(o_acc[4 * jn + 2 * r] * inv[r], o_acc[4 * jn + 2 * r + 1] * inv[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: one query row per thread, 64 rows per CTA, keys in chunks of 16.
// ---------------------------------------------------------------------------
constexpr int kF32Rows = 64;  // query rows per CTA
constexpr int kF32Keys = 64;  // keys per shared-memory tile

template <bool kCausal>
__global__ void __launch_bounds__(kF32Rows)
fa_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int tq, int tk,
                  Strides qs, Strides ks, Strides vs, Strides os, float sm_scale) {
  __shared__ float k_s[kF32Keys][kD];
  __shared__ float v_s[kF32Keys][kD];
  constexpr int kChunk = 16;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kF32Rows + tid;
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
  const int key_end = kCausal ? min(tk, static_cast<int>(blockIdx.x + 1) * kF32Rows) : tk;

  for (int key0 = 0; key0 < key_end; key0 += kF32Keys) {
    __syncthreads();
    for (int e = tid; e < kF32Keys * kD; e += kF32Rows) {
      const int kr = e / kD, d = e % kD, key = key0 + kr;
      k_s[kr][d] = key < tk ? kb[key * ks.t + d] : 0.f;
      v_s[kr][d] = key < tk ? vb[key * vs.t + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kF32Keys; j0 += kChunk) {
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

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once through the runtime.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over (D, H, T, B) of a bf16 (B, T, H, D) tensor with the given
// element strides; its box is (64, 1, rows, 1) with the 128-byte swizzle.
// Rows past T are zero-filled.
bool make_map(CUtensorMap* map, const void* base, int batch, int t, int heads, long long sb,
              long long st, long long sh, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kD, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lets a bf16 instantiation use its dynamic shared memory; set once.
template <bool kCausal>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_bf16_kernel<kCausal>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  return err;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = cudaSuccess), or without
// launching: cudaErrorInvalidValue when causal is set and tq != tk (the mask
// aligns queries and keys at position 0) or a tensor map does not encode,
// or the error of the shared-memory attribute.
int whisper_fa_forward_bf16(const void* q, const void* k, const void* v, void* o, int batch,
                            int tq, int tk, int heads, long long q_sb, long long q_st,
                            long long q_sh, long long k_sb, long long k_st, long long k_sh,
                            long long v_sb, long long v_st, long long v_sh, long long o_sb,
                            long long o_st, long long o_sh, float sm_scale, int causal,
                            void* stream) {
  if (causal && tq != tk) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, batch, tq, heads, q_sb, q_st, q_sh, kBlockM) ||
      !make_map(&k_map, k, batch, tk, heads, k_sb, k_st, k_sh, kBlockN) ||
      !make_map(&v_map, v, batch, tk, heads, v_sb, v_st, v_sh, kBlockN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t attr = causal ? allow_smem<true>() : allow_smem<false>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((tq + kBlockM - 1) / kBlockM, heads, batch);
  auto kernel = causal ? fa_fwd_bf16_kernel<true> : fa_fwd_bf16_kernel<false>;
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), tq, tk, Strides{o_sb, o_st, o_sh},
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int whisper_fa_forward_f32(const void* q, const void* k, const void* v, void* o, int batch,
                           int tq, int tk, int heads, long long q_sb, long long q_st,
                           long long q_sh, long long k_sb, long long k_st, long long k_sh,
                           long long v_sb, long long v_st, long long v_sh, long long o_sb,
                           long long o_st, long long o_sh, float sm_scale, int causal,
                           void* stream) {
  if (causal && tq != tk) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((tq + kF32Rows - 1) / kF32Rows, heads, batch);
  auto kernel = causal ? fa_fwd_f32_kernel<true> : fa_fwd_f32_kernel<false>;
  kernel<<<grid, kF32Rows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), tq, tk, Strides{q_sb, q_st, q_sh}, Strides{k_sb, k_st, k_sh},
      Strides{v_sb, v_st, v_sh}, Strides{o_sb, o_st, o_sh}, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
