// The int8 (or bf16) linear of the encoder and the cross-attention K/V for
// Hopper (sm_90a): one GEMM whose epilogue applies the per-output-channel
// scale and the bias in fp32 and rounds to bf16 once,
//
//   y[m, n] = bf16( (sum_k x[m, k] * w[k, n]) * scale[n] + b[n] )
//
// with the sum in fp32 (the tensor cores' accumulators), then the product by
// the scale and the bias each rounded in fp32 (no fused multiply-add: the
// plain version rounds twice), then one cast. That is the JAX package's
// `linear`, `dot(preferred_element_type=float32) * scale + b` and one cast,
// which XLA fuses into the dot's output; only the order of the fp32 sum
// differs from the plain version's, as another GEMM's does. scale and b are
// each optional (bf16 weights have no scale; the k projection has no bias).
//
// It replaces no TPU kernel: on the TPU the epilogue is XLA's fusion. It was
// added because the port ran the linear as five kernels (the weight's cast,
// a GEMM writing the fp32 product to device memory, `* scale`, `+ b` and the
// cast to bf16), and the three elementwise passes over the fp32 product took
// more device time than the GEMM itself (PERF.md). Here the fp32 product
// never leaves the registers.
//
// What bounds it on the H100: at the encoder's shapes (M = 1500 rows a
// window, (K, N) = (1280, 1280), (1280, 5120), (5120, 1280)) a window's six
// linears a layer and the cross-attention's K and V do about 2.2 TFLOP
// against 1.35 GB of bf16 output (and less input): 2.2 ms at the dense
// bf16 peak against 0.5 ms at the HBM rate, so the tensor cores bound it.
// Each CTA's tile of 128 x 256 outputs reads (128 + 256) x 64 bf16 inputs a
// k-block for 2 x 128 x 256 x 64 FLOPs (85 FLOP a byte from L2).
//
// The design, one persistent CTA per SM (384 threads: its registers fill
// the SM):
//   * the CTA walks output tiles of kBM x kBN = 128 x 256 (tile t, t + grid,
//     ...; N fastest, so the CTAs running at once share the rows of x in L2,
//     and the weight, at most 13 MB, stays there);
//   * one producer warpgroup, of which one thread issues TMA loads of the
//     x tile (64 columns of 128 rows) and the w tile (64 rows of 256
//     columns, as four boxes of 64 columns) for each k-block into a ring of
//     kStages shared-memory stages, signalled on mbarriers with expect_tx;
//     the consumers free a stage on a second mbarrier. It walks the same
//     tiles as the consumers, so while they finish one tile's epilogue it is
//     already loading the next tile's first stages. Rows past M and columns
//     past N are zero-filled by TMA;
//   * two consumer warpgroups, 64 rows of the tile each, issue
//     wgmma.m64n256k16 with both operands from shared memory in the 128-byte
//     swizzle: x K-major, w N-major as the tree stores it (in, out), read
//     through the transpose flag, so w is never transposed. One k-block's
//     products stay in flight while the next stage is awaited;
//   * while a tile's first products run, each consumer warpgroup stages the
//     tile's 256 scales and biases in shared memory (read from L2 at the
//     epilogue instead, their latency cost 6-11 % of the kernel's time);
//   * the epilogue scales and biases the fp32 accumulators in registers,
//     packs them to bf16 into a staging buffer in shared memory (the
//     128-byte swizzle, so the writes meet no bank conflict), and one thread
//     of the warpgroup stores it with TMA (rows past M are clipped). The
//     store is asynchronous: the warpgroup goes on to the next tile and
//     waits for the store to have read the buffer only before it writes the
//     buffer again.
// Sums are taken in a fixed order, with no atomics: two launches give the
// same bits.
// Tried and measured slower on the H100 (PERF.md): two stages (-25 %),
// tiles walked with M fastest (-13 to -21 %), and bf16 stores straight from
// registers to device memory with a fourth stage in the staging buffers'
// place (-10 to -16 %).
//
// Layout: x (M, K) row-major, w (K, N) row-major, scale and b fp32 (N) (or
// null), y (M, N) bf16 row-major; K and N multiples of 8 and the bases
// 16-byte aligned (TMA's rule). Every entry point launches on the given
// stream and returns cudaGetLastError(), or an error without launching. The
// tensor maps are encoded per call by cuTensorMapEncodeTiled, looked up
// through the CUDA runtime, so the library links no libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output rows a tile (64 a consumer warpgroup)
constexpr int kBN = 256;       // output columns a tile
constexpr int kBK = 64;        // one 128-byte swizzle row of bf16 a k-block
constexpr int kStages = 3;     // ring depth
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBox = 64;                           // columns a TMA box of w or y (128 bytes)
constexpr int kBoxBytes = kBox * 2 * kBK;          // one 64 x 64 bf16 box: 8 KB
constexpr int kABytes = kBM * kBK * 2;             // 16 KB
constexpr int kBBytes = kBK * kBN * 2;             // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;     // 48 KB
constexpr int kCBytes = 64 * kBN * 2;              // a warpgroup's staging buffer: 32 KB
constexpr int kSBBytes = 2 * kBN * 4;              // a warpgroup's tile of scale and bias
// + 1024: the dynamic base is rounded up to the 1024-byte swizzle period
constexpr int kSmemBytes =
    1024 + kStages * kStageBytes + kConsumers * (kCBytes + kSBBytes) + 8 * 2 * kStages;
static_assert(kSmemBytes <= 232448, "shared memory exceeds the SM's 227 KB");
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until this thread's committed stores have read shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Waits until this thread's committed stores are complete.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void warpgroup_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
}

// wgmma shared-memory descriptors for tiles written by TMA with the 128-byte
// swizzle (1024-byte aligned): start address >> 4, the leading byte offset,
// the stride byte offset 1024 B between groups of 8 rows, layout type 1.
// x (K-major, 128-byte rows along M): one swizzle atom spans a k-step's 16
// columns, so the leading offset is unused (1). w (N-major, 128-byte rows
// along K, 64 columns a box): the leading offset is the distance from one
// 64-column box to the next.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_n_major(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kBoxBytes >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Pins registers that a wgmma reads or writes, so the compiler moves no
// access to them across the fence, commit and wait that bracket the product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 256, fp32) (+)= A (64 x 16) B (16 x 256): A K-major, B N-major (the
// transpose flag), both in shared memory with the 128-byte swizzle;
// `accumulate` 0 ignores D's old value (a tile's first k-step)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, "
      "%73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "
      "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "
      "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate)
      : "memory");
}

// wgmma m64nN accumulator map (warp w of the warpgroup, g = lane / 4,
// c = lane % 4): d[4j + e] is row 16w + g + 8 (e >> 1), column 8j + 2c + (e & 1).

__global__ void __launch_bounds__(kThreads, 1)
fused_linear_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap y_map, const float* __restrict__ scale,
                    const float* __restrict__ bias, int m, int n, int k) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* const ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* const stage_buf = ring + kStages * kStageBytes;  // kConsumers staging buffers
  float* const sb_buf = reinterpret_cast<float*>(stage_buf + kConsumers * kCBytes);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(stage_buf + kConsumers * (kCBytes + kSBBytes));
  const uint32_t full0 = smem_u32(bars);              // stage s: + 8 s
  const uint32_t empty0 = smem_u32(bars + kStages);   // stage s: + 8 s

  const int tiles_n = (n + kBN - 1) / kBN;
  const int tiles = ((m + kBM - 1) / kBM) * tiles_n;
  const int k_blocks = (k + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full, tile after tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kBM;
        const int n0 = (tile % tiles_n) * kBN;
        for (int kb = 0; kb < k_blocks; ++kb, ++it) {
          const int s = it % kStages;
          const uint32_t full = full0 + 8 * s;
          // the first pass over the ring finds every stage free
          mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full, kStageBytes);
          uint8_t* const a_s = ring + s * kStageBytes;
          tma_load_2d(smem_u32(a_s), &x_map, full, kb * kBK, m0);
#pragma unroll
          for (int i = 0; i < kBN / kBox; ++i) {
            tma_load_2d(smem_u32(a_s + kABytes + i * kBoxBytes), &w_map, full, n0 + i * kBox,
                        kb * kBK);
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of every tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int row_w = 16 * (tid / 32) + g;  // this thread's rows in the warpgroup's 64: and + 8
  uint8_t* const my_c = stage_buf + cw * kCBytes;
  const uint32_t my_c_u32 = smem_u32(my_c);
  float* const my_sb = sb_buf + cw * 2 * kBN;  // the tile's scale, then its bias

  float acc[128];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * kBM;
    const int n0 = (tile % tiles_n) * kBN;

    for (int kb = 0; kb < k_blocks; ++kb, ++it) {
      const int s = it % kStages;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      uint8_t* const a_s = ring + s * kStageBytes;
      const uint64_t a_desc = desc_k_major(smem_u32(a_s + cw * 64 * kBK * 2));
      const uint64_t b_desc = desc_n_major(smem_u32(a_s + kABytes));
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // x: 16 columns are 32 B along the swizzled row; w: 16 rows are 2048 B
        wgmma_m64n256k16(acc, a_desc + 2 * kk, b_desc + 128 * kk, (kb | kk) != 0);
      }
      wgmma_commit();
      if (kb == 0) {
        // while the first products run: the tile's scale and bias into
        // shared memory, two columns a thread
        const int col = n0 + 2 * tid;
        float2 sc = make_float2(1.f, 1.f), bi = make_float2(0.f, 0.f);
        if (col < n) {
          if (scale != nullptr) sc = __ldg(reinterpret_cast<const float2*>(scale + col));
          if (bias != nullptr) bi = __ldg(reinterpret_cast<const float2*>(bias + col));
        }
        reinterpret_cast<float2*>(my_sb)[tid] = sc;
        reinterpret_cast<float2*>(my_sb + kBN)[tid] = bi;
      }
      if (kb > 0) {
        // the previous k-block's products are done: free its stage
        wgmma_wait<1>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));

    // Epilogue: the staging buffer is free once the last store has read it.
    if (tid == 0) bulk_wait_read();
    warpgroup_sync(cw);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col_t = 8 * j + 2 * c;  // and + 1, in the tile
      const float2 sc = reinterpret_cast<const float2*>(my_sb)[col_t / 2];
      const float2 bi = reinterpret_cast<const float2*>(my_sb + kBN)[col_t / 2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (scale != nullptr) {
          v0 = __fmul_rn(v0, sc.x);
          v1 = __fmul_rn(v1, sc.y);
        }
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, bi.x);
          v1 = __fadd_rn(v1, bi.y);
        }
        // box j / 8, row row_w + 8 h, 16-byte chunk j % 8 swizzled by the
        // row's place in its group of 8 (g)
        const int row = row_w + 8 * h;
        const uint32_t addr = my_c_u32 + (j / 8) * kBoxBytes + row * 128 +
                              (((j % 8) ^ g) << 4) + 4 * c;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(pack_bf16(v0, v1))
                     : "memory");
      }
    }
    // the writes above are read next by the TMA store, through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(cw);
    const int row0 = m0 + 64 * cw;
    if (tid == 0 && row0 < m) {
#pragma unroll
      for (int i = 0; i < kBN / kBox; ++i) {
        if (n0 + i * kBox < n) tma_store_2d(&y_map, my_c_u32 + i * kBoxBytes, n0 + i * kBox, row0);
      }
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_all();
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

// A 2-D map over a row-major bf16 (rows, cols) matrix; its box is
// (64 columns, box_rows rows) with the 128-byte swizzle. Elements past the
// matrix read as zero and are not written.
bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBox, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// y = bf16(x @ w * scale + b) for bf16 x (m, k), w (k, n), fp32 scale and b
// (n, either may be null), bf16 y (m, n). Returns cudaGetLastError() after
// the launch (0 = cudaSuccess), or without launching:
// cudaErrorInvalidValue when a size is not positive, k or n is not a
// multiple of 8, or a tensor map does not encode; else the error of the
// shared-memory attribute or the device query.
int whisper_fused_linear_bf16(const void* x, const void* w, const void* scale, const void* bias,
                              void* y, int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 != 0 || k % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap x_map, w_map, y_map;
  if (!make_map(&x_map, x, m, k, kBM) || !make_map(&w_map, w, k, n, kBK) ||
      !make_map(&y_map, y, m, n, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  const int grid = tiles < sms ? tiles : sms;
  fused_linear_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, y_map, static_cast<const float*>(scale), static_cast<const float*>(bias), m,
      n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
