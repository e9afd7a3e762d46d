// The int8 ResBlock2 chain for Hopper (sm_90a): the port of the TPU kernel
// K1, vits_tpu/nn/pallas_rb.py:96 (_make_kernel, launched by
// resblock2_chain_q8 at :223). Per dilation d of a chain of kernel size k:
// lrelu(0.1), quantize (IEEE division, round half to even, clip +-127), int8
// conv1 (k taps at dilation d, C -> C, s8 x s8 -> s32), acc * deq1 + b1 +
// cond(g), tanh(a) * sigmoid(b), mask, quantize, int8 conv2 (k taps, C/2 ->
// C), acc * deq2 + b2 + residual, mask. The wrapper, vits_tpu_torch/nn/
// rb_chain.py, owns the plan (`plan`) that picks one of two forms per shape
// and computes every shared-memory offset given here.
//
// What bounds each shape. A chain does 9 k C^2 int8 ops per frame and must
// move 8 C bytes of f32 activations per frame: 9 k C / 8 ops per byte
// against the H100's ridge of ~590 (1,979 TOP/s over 3.35 TB/s). Bound by
// operations: C = 256 (every k), C = 128 at k = 7, 11 and C = 64 at k = 11;
// by bytes: C = 32 (every k), C = 64 at k = 3, 7 and C = 128 at k = 3. On
// the card neither bound is what sets the time: the per-element epilogues
// (the quotients of quantize_act, tanh and the sigmoid) and the latency of
// each phase of a block are (scripts/probe_k1_phases.py).
//
// 1. The whole-chain form (rb2_chain_kernel, one launch per chain). A block
//    takes T frames plus the chain's halo h = sum (d + 1)(k - 1)/2 per side
//    (12/36/60 at k = 3/7/11), keeps the f32 residual (R = T + 2h rows of
//    C + 8 floats), the int8 conv1 input and the int8 gate (R + 64 rows
//    each, the 64 being the reach of the last 64-row wgmma tile) in shared
//    memory, and runs every dilation on a valid region that shrinks by
//    d (k - 1)/2 + (k - 1)/2 per side; conv2's epilogue writes the next
//    input (f32 and int8) in place, and only the central T frames of the
//    last dilation go to device memory. The activation plane crosses device
//    memory once per chain instead of three times. Shared memory per block,
//    with the weights, at the base config's 256-frame shapes: C = 32: T =
//    192 at k = 3, 7 (69 / 104 KB), 384 at k = 11 (180 KB), weights
//    resident; C = 64: T = 192 (141 KB resident at k = 3; 147 / 189 KB with
//    a weight ring at k = 7, 11); C = 128, k = 3: T = 96 (170 KB, ring). The
//    plan picks T (a multiple of 32 up to 512) for the fewest 64-row wgmma
//    rounds on the busiest block slot. Where no 64-frame tile fits beside
//    one dilation's weights - C = 256, and C = 128 at k = 7, 11, the
//    operation-bound shapes whose halo would also cost the most recomputed
//    products - the split form runs instead.
// 2. Weights in shared memory by the TMA unit. The wrapper packs each conv
//    in the layout wgmma reads (pack_kmajor: per tap and 32-channel k-step,
//    a K-major N x 32 tile of 8 x 16-byte core matrices, no swizzle: each
//    core matrix is 128 contiguous bytes, one conflict-free wavefront), and
//    one thread copies it with cp.async.bulk, completion counted on an
//    mbarrier. Where a chain's weights fit beside the tile (C = 32, and
//    C = 64 at k = 3: 18-66 KB) they load once per block, and the blocks are
//    persistent (one per SM, two at C = 32, each walking tiles), so once per
//    SM. Else a two-stage ring holds one dilation's conv1 and conv2 (all
//    taps), and the next dilation's (or next tile's) conv1 streams in while
//    this conv2 runs. The split form streams tap by tap through a 4-stage
//    ring, each stage refilled as soon as the wgmma group reading it retires.
// 3. wgmma.m64nNk32.s32.s8.s8 for every product, frames on M, output
//    channels on N, input channels x taps on K, both operands in shared
//    memory (the SS form). A is the int8 activation tile shifted by tap * d
//    rows. A swizzled tile could not start at an arbitrary row, so the
//    tiles are "chunk-major" and unswizzled: 16 input channels of every row
//    together, 16 bytes a row, so the 8-row core matrix at any row is 128
//    contiguous bytes and a descriptor starts at the row a tap names (LBO =
//    rows x 16 between channel chunks, SBO = 128 between 8-row groups). No
//    register holds A, so every tap's wgmmas go out as one group. (An RS
//    form, A in registers, made ptxas serialize the wgmmas: the fragment
//    loads for a tap wrote registers while the previous group ran.) conv2 at
//    C = 32 has K = 16: its packed weights are zero-padded to 32, and the
//    gate tile's second chunk, whatever it holds, meets only those zeros.
//    conv1's a- and b-half of a gate channel fall in one thread (N = C,
//    chunks j and j + C/16). The split form (rb2_split_kernel, per dilation
//    a conv1 + gate launch writing an int8 gate (B, M, C/2) to global
//    scratch, about 1 MB at C = 256, kept in L2, then a conv2 + residual
//    launch that also writes the next dilation's quantized input, so later
//    conv1 launches read int8 instead of quantizing x in every column
//    group) splits the output channels in groups of 64 (conv1: 32 gate
//    channels, their a- and b-columns): at C = 256, B = 1, M = 2048 that is
//    32 frame tiles x 4 groups = 128 blocks per launch for 132 SMs, 6
//    launches per chain.
// 4. No host glue: the kernels add b1 to cond(g) themselves (gs (B, n, C)
//    and one (n, 4C + 4) vector of deq1, b1, deq2, b2, s_in1, s_in2 per
//    chain, packed at quantization), clamp valid to [0, M] themselves, and
//    the wrapper caches the SM count and the plan per shape and checks the
//    packed operands once per device.
//
// The quantize step's quotient comes from the scale's reciprocal with one
// fma correction (div_rn), the IEEE quotient without a division per element;
// the results equal the plain version's bit for bit at every base shape
// (chip_smoke.py).
//
// Two forms of I/O, a template parameter of every kernel: float32, and
// bfloat16 (the Pallas chain at dtype bfloat16, pallas_rb.py:119-137). In
// bfloat16 x and out are bf16 in device memory (half the activation bytes)
// and values round to bf16 (round to nearest even) where the Pallas chain
// rounds: the leaky ReLU (slope bf16(0.1) = 0.10009765625, the product
// rounded), the gate (computed in f32, rounded before the mask and the
// quantize), conv2's dequantized output plus b2, and the residual sum. The
// shared-memory residual stays f32 and holds bf16-exact values, so the
// layouts and the plan are those of the float32 form; the products, the
// dequantization and the gate's arithmetic are unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplitThreads = 128;        // split form: one warpgroup per block,
constexpr int kSplitRows = 64;            //   64 frames x
constexpr int kSplitNB = 64;              //   64 output columns
constexpr int kStages = 4;                // split form: taps in flight in the weight ring
constexpr int kLBO = 128;                 // packed weights: K-adjacent core matrices
constexpr int kSBO = 256;                 //   and N-adjacent 8-row groups, in bytes
constexpr int kChainLoads = 8;            // global loads in flight per thread
constexpr int kSplitLoads = 16;

// Global I/O of one element type: loads and stores of activations, and the
// rounding to that type (none in float32).
template <typename IO>
struct Io;

template <>
struct Io<float> {
  static constexpr float kSlope = 0.1f;
  __device__ static __forceinline__ float round(float v) { return v; }
  __device__ static __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static __forceinline__ void store2(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr float kSlope = 0.10009765625f;  // bf16(0.1), the JAX package's slope in bf16
  __device__ static __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  // a bf16 pair of a 32-bit word, the lower address in the low half
  __device__ static __forceinline__ float2 unpack(uint32_t w) {
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  }
  __device__ static __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = unpack(u.x), b = unpack(u.y);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ static __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return unpack(*reinterpret_cast<const uint32_t*>(p));
  }
  __device__ static __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
  }
};

template <typename IO>
__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : Io<IO>::round(__fmul_rn(v, Io<IO>::kSlope));
}

// An activation scale and its correctly rounded reciprocal.
struct Scale {
  float s, inv;
};
__device__ __forceinline__ Scale scale_of(float s) { return {s, __frcp_rn(s)}; }

// RN(v / s), the IEEE quotient, from the reciprocal: q = RN(v inv) is within
// an ulp of v / s, the remainder v - q s is exact in one fma, and RN(q + r
// inv) is then the correctly rounded quotient (Markstein's theorem for a
// reciprocal rounded to nearest) - three operations instead of a division
__device__ __forceinline__ float div_rn(float v, Scale sc) {
  const float q = __fmul_rn(v, sc.inv);
  return __fmaf_rn(__fmaf_rn(-q, sc.s, v), sc.inv, q);
}

// quantize_act: the IEEE quotient, round half to even, clip to +-127
__device__ __forceinline__ int quant(float v, Scale sc) {
  float q = rintf(div_rn(v, sc));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int>(q);
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return static_cast<int>((static_cast<unsigned>(a) & 0xffu) |
                          ((static_cast<unsigned>(b) & 0xffu) << 8) |
                          ((static_cast<unsigned>(c) & 0xffu) << 16) |
                          ((static_cast<unsigned>(d) & 0xffu) << 24));
}

__device__ __forceinline__ void store2(int8_t* p, int a, int b) {
  *reinterpret_cast<uint16_t*>(p) =
      static_cast<uint16_t>((static_cast<unsigned>(a) & 0xffu) |
                            ((static_cast<unsigned>(b) & 0xffu) << 8));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and bulk copies (the TMA unit) ----------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared, `bytes` (a multiple of 16) by the TMA unit; completion
// is counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // until at most N committed groups are still in flight
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory writes of this thread -> visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the accumulators in place across an asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(int (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// shared-memory matrix descriptor of a K-major operand without swizzle: 8-row
// x 16-byte core matrices, `lbo` bytes apart along K and `sbo` bytes apart
// along M or N
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 x N s32) += A (64 x 32 s8) * B (32 x N s8), both from shared memory.
// d[4j + 2h + e] of lane 4g + t in warp w is row 16w + g + 8h, column
// 8j + 2t + e.
template <int N>
__device__ __forceinline__ void wgmma(int (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma<32>(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Activation tiles are "chunk-major": input channel c of row r at byte
// (c / 16) * RA * 16 + r * 16 + c % 16, RA rows to a chunk. The 8 rows x 16
// bytes of a core matrix are then 128 contiguous bytes from any row on, so
// an A descriptor may start at the row a tap's shift names.
__device__ __forceinline__ int chunk_off(int r, int c, int RA) {
  return (c >> 4) * RA * 16 + r * 16 + (c & 15);
}

// acc += sum over taps of A rows [row0 + tap * step, + 64) x W[tap]; A: int8
// chunk-major tile of RA rows; W: packed (tap, kb, N x 32) int8. Every tap's
// wgmmas in one group.
template <int N, int KB>
__device__ __forceinline__ void conv_taps(int (&acc)[N / 2], const int8_t* A, int RA, int row0,
                                          int step, const int8_t* W, int K) {
  fence_regs(acc);
  wg_fence();
  for (int tap = 0; tap < K; ++tap) {
    const int8_t* a = A + (row0 + tap * step) * 16;
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
      wgmma<N>(acc, smem_desc(a + 2 * kb * RA * 16, RA * 16, 128),
               smem_desc(W + (tap * KB + kb) * N * 32, kLBO, kSBO));
  }
  wg_commit();
  wg_wait<0>();
  fence_regs(acc);
}

__device__ __forceinline__ float gate_value(int acc_a, int acc_b, const float* v, const float* gsb,
                                            int C, int h) {
  const int H = C / 2;  // v: deq1 [0, C), b1 [C, 2C)
  const float ya = __fadd_rn(__fadd_rn(__fmul_rn(static_cast<float>(acc_a), v[h]), v[C + h]),
                             gsb[h]);
  const float yb = __fadd_rn(
      __fadd_rn(__fmul_rn(static_cast<float>(acc_b), v[H + h]), v[C + H + h]), gsb[H + h]);
  return __fmul_rn(tanhf(ya), __frcp_rn(__fadd_rn(1.f, expf(-yb))));
}

template <typename IO>
__device__ __forceinline__ float out_value(int acc, const float* v, int C, int co, float res) {
  // v: deq2 [2C, 3C), b2 [3C, 4C)
  const float y =
      Io<IO>::round(__fadd_rn(__fmul_rn(static_cast<float>(acc), v[2 * C + co]), v[3 * C + co]));
  return Io<IO>::round(__fadd_rn(y, res));
}

template <typename IO>
__device__ __forceinline__ int quant4(float4 v, Scale s) {
  return pack4(quant(lrelu<IO>(v.x), s), quant(lrelu<IO>(v.y), s), quant(lrelu<IO>(v.z), s),
               quant(lrelu<IO>(v.w), s));
}

// ---- the whole-chain form -------------------------------------------------

template <typename IO, int C, int WG>  // IO: x and out; WG warpgroups per block
__global__ void __launch_bounds__(128 * WG, C == 32 ? 2 : 1)
rb2_chain_kernel(const IO* __restrict__ x, IO* __restrict__ out,
                 const int8_t* __restrict__ wq,   // per dilation: conv1, conv2 packed
                 const float* __restrict__ vec,   // (nd, 4C + 4)
                 const float* __restrict__ gs,    // (B, nd, C)
                 const int* __restrict__ valid, int B, int M, int K, int nd, int d0, int d1,
                 int d2, int T, int halo, int resident, int off_xs, int off_q, int off_g,
                 int off_bar) {
  constexpr int H = C / 2, K2 = H < 32 ? 32 : H, KB1 = C / 32, KB2 = K2 / 32;
  constexpr int XS = C + 8, VL = 4 * C + 4, NT = 128 * WG, C4 = C / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + off_xs);  // f32 residual rows
  int8_t* q = reinterpret_cast<int8_t*>(smem + off_q);  // int8 conv1 input, chunk-major
  int8_t* gt = reinterpret_cast<int8_t*>(smem + off_g); // int8 gate, chunk-major
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + off_bar);
  int8_t* wsm = reinterpret_cast<int8_t*>(smem);
  const int W1 = K * C * C, W2 = K * K2 * C, WD = W1 + W2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wrow = (warp & 3) * 16;  // warpgroup; the warp's rows in a tile
  const int tiles_b = (M + T - 1) / T, n_tiles = B * tiles_b;
  const int R = T + 2 * halo, RA = R + 64;  // rows used; rows allocated (the last tile's reach)

  // conv c (0: conv1, 1: conv2) of dilation i: all of its taps in one stage
  auto stage = [&](int i, int c) { return wsm + (resident ? i * WD : 0) + c * W1; };
  auto fetch = [&](int i, int c) {  // one thread: the weights of (i, c) into their stage
    uint64_t* b = bar + (resident ? 0 : c);
    const int bytes = c ? W2 : W1;
    if (!resident) mbar_expect(b, bytes);
    bulk_load(stage(i, c), wq + static_cast<size_t>(i) * WD + c * W1, bytes, b);
  };
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    if (resident) {
      mbar_expect(&bar[0], nd * WD);
      for (int i = 0; i < nd; ++i) {
        fetch(i, 0);
        fetch(i, 1);
      }
    } else {
      fetch(0, 0);
      fetch(0, 1);
    }
  }

  int uses = 0;  // ring fills consumed per stage
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_b, t0 = (tile - b * tiles_b) * T;
    const int f0 = t0 - halo;  // tile row r is frame f0 + r
    const int nv = min(max(valid[b], 0), M);
    const bool more = tile + static_cast<int>(gridDim.x) < n_tiles;
    const IO* xb = x + static_cast<size_t>(b) * M * C;

    // x rows -> f32 residual and int8 lrelu/quantized input; zero outside [0, M)
    {
      const Scale s1 = scale_of(vec[4 * C]);
      for (int base = tid; base < R * C4; base += kChainLoads * NT) {
        float4 v[kChainLoads];
#pragma unroll
        for (int u = 0; u < kChainLoads; ++u) {
          const int idx = base + u * NT, r = idx / C4, f = f0 + r;
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (idx < R * C4 && f >= 0 && f < M)
            v[u] = Io<IO>::load4(xb + static_cast<size_t>(f) * C + 4 * (idx - r * C4));
        }
#pragma unroll
        for (int u = 0; u < kChainLoads; ++u) {
          const int idx = base + u * NT, r = idx / C4, c4 = idx - r * C4;
          if (idx < R * C4) {
            *reinterpret_cast<float4*>(xs + r * XS + 4 * c4) = v[u];
            *reinterpret_cast<int*>(q + chunk_off(r, 4 * c4, RA)) = quant4<IO>(v[u], s1);
          }
        }
      }
    }
    fence_async();
    __syncthreads();

    int a = 0;  // the current input is right on rows [a, R - a)
    for (int i = 0; i < nd; ++i) {
      const int d = i == 0 ? d0 : (i == 1 ? d1 : d2);
      const int p1 = d * (K - 1) / 2, p2 = (K - 1) / 2;
      const float* v = vec + i * VL;
      const float* gsb = gs + (static_cast<size_t>(b) * nd + i) * C;
      const bool last = i + 1 == nd;

      // conv1 + gate on rows [s, e)
      mbar_wait(&bar[0], resident ? 0 : (uses & 1));
      {
        const Scale s2 = scale_of(v[4 * C + 1]);
        const int s = a + p1, e = R - a - p1;
        const int8_t* W = stage(i, 0);
        for (int r0 = s + wg * 64; r0 < e; r0 += WG * 64) {
          int acc[C / 2];
#pragma unroll
          for (int j = 0; j < C / 2; ++j) acc[j] = 0;
          conv_taps<C, KB1>(acc, q, RA, r0 - p1, d, W, K);
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int r = r0 + wrow + g + 8 * hi;
            const int f = f0 + r;
            const bool live = f >= 0 && f < nv;
            if (r < e) {
#pragma unroll
              for (int j = 0; j < H / 8; ++j) {
                const int h = 8 * j + 2 * t;
                int qq[2];
#pragma unroll
                for (int e2 = 0; e2 < 2; ++e2)
                  qq[e2] = live ? quant(Io<IO>::round(gate_value(
                                            acc[4 * j + 2 * hi + e2],
                                            acc[4 * (j + H / 8) + 2 * hi + e2], v, gsb, C, h + e2)),
                                        s2)
                                : 0;
                store2(gt + chunk_off(r, h, RA), qq[0], qq[1]);
              }
            }
          }
        }
      }
      fence_async();
      __syncthreads();
      if (!resident && tid == 0 && (!last || more)) fetch(last ? 0 : i + 1, 0);

      // conv2 + b2 + residual + mask on rows [s, e): the next input, or out
      mbar_wait(&bar[resident ? 0 : 1], resident ? 0 : (uses & 1));
      {
        const int s = a + p1 + p2, e = R - s;
        const Scale s1n = scale_of(last ? 1.f : vec[(i + 1) * VL + 4 * C]);
        const int8_t* W = stage(i, 1);
        for (int r0 = s + wg * 64; r0 < e; r0 += WG * 64) {
          int acc[C / 2];
#pragma unroll
          for (int j = 0; j < C / 2; ++j) acc[j] = 0;
          conv_taps<C, KB2>(acc, gt, RA, r0 - p2, 1, W, K);
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int r = r0 + wrow + g + 8 * hi;
            const int f = f0 + r;
            const bool live = f >= 0 && f < nv;
            if (r < e && (!last || f < M)) {
#pragma unroll
              for (int j = 0; j < C / 8; ++j) {
                const int co = 8 * j + 2 * t;
                const float2 res = *reinterpret_cast<const float2*>(xs + r * XS + co);
                float2 o;
                o.x = live ? out_value<IO>(acc[4 * j + 2 * hi], v, C, co, res.x) : 0.f;
                o.y = live ? out_value<IO>(acc[4 * j + 2 * hi + 1], v, C, co + 1, res.y) : 0.f;
                if (last) {
                  Io<IO>::store2(out + (static_cast<size_t>(b) * M + f) * C + co, o);
                } else {
                  *reinterpret_cast<float2*>(xs + r * XS + co) = o;
                  store2(q + chunk_off(r, co, RA), quant(lrelu<IO>(o.x), s1n),
                         quant(lrelu<IO>(o.y), s1n));
                }
              }
            }
          }
        }
      }
      fence_async();
      __syncthreads();
      if (!resident && tid == 0 && (!last || more)) fetch(last ? 0 : i + 1, 1);
      ++uses;
      a += p1 + p2;
    }
  }
}

// ---- the split form: per dilation, conv1 + gate, then conv2 + residual ------

// MODE 0: conv1 + gate -> int8 gate; 1: conv2 + residual -> out, and the next
// dilation's int8 input. Dilation i > 0 takes that int8 input (quantized
// once, by the block that computed it) instead of quantizing x again in
// every column group.
template <typename IO, int MODE, int C>
__global__ void __launch_bounds__(kSplitThreads)
rb2_split_kernel(const IO* __restrict__ x,       // the dilation's input (residual in MODE 1)
                 int8_t* __restrict__ gate,     // (B, M, C/2) int8 scratch
                 int8_t* __restrict__ xq,       // (B, M, C) int8 scratch: lrelu(x) quantized
                 IO* __restrict__ out,          // (B, M, C), MODE 1
                 const int8_t* __restrict__ wq, // (groups, K, KB, 64 x 32) packed
                 const float* __restrict__ vec, const float* __restrict__ gs,
                 const int* __restrict__ valid, int M, int K, int d, int i, int nd, int off_a,
                 int off_bar) {
  constexpr int H = C / 2, KIN = MODE == 0 ? C : H, KB = KIN / 32;
  constexpr int VL = 4 * C + 4, STAGE = KB * kSplitNB * 32, NT = kSplitThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* A = reinterpret_cast<int8_t*>(smem + off_a);  // chunk-major, RA rows
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + off_bar);
  int8_t* wsm = reinterpret_cast<int8_t*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, grp = blockIdx.y, t0 = blockIdx.x * kSplitRows;
  const int step = MODE == 0 ? d : 1, pad = step * (K - 1) / 2;
  const int RA = kSplitRows + (K - 1) * step;  // A row r is frame t0 - pad + r
  const int nv = min(max(valid[b], 0), M);
  const float* v = vec + i * VL;
  const int8_t* wgrp = wq + static_cast<size_t>(grp) * K * STAGE;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < kStages && s < K; ++s) {
      mbar_expect(&bar[s], STAGE);
      bulk_load(wsm + s * STAGE, wgrp + s * STAGE, STAGE, &bar[s]);
    }

  if (MODE == 0 && i == 0) {  // x -> lrelu -> int8, zero outside [0, M)
    constexpr int C4 = C / 4;
    const Scale s1 = scale_of(v[4 * C]);
    const IO* xb = x + static_cast<size_t>(b) * M * C;
    for (int base = tid; base < RA * C4; base += kSplitLoads * NT) {
      float4 u4[kSplitLoads];
#pragma unroll
      for (int u = 0; u < kSplitLoads; ++u) {
        const int idx = base + u * NT, r = idx / C4, f = t0 - pad + r;
        u4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (idx < RA * C4 && f >= 0 && f < M)
          u4[u] = Io<IO>::load4(xb + static_cast<size_t>(f) * C + 4 * (idx - r * C4));
      }
#pragma unroll
      for (int u = 0; u < kSplitLoads; ++u) {
        const int idx = base + u * NT, r = idx / C4, c4 = idx - r * C4;
        if (idx < RA * C4)
          *reinterpret_cast<int*>(A + chunk_off(r, 4 * c4, RA)) = quant4<IO>(u4[u], s1);
      }
    }
  } else {  // int8 rows (the quantized input, or the gate), zero outside [0, M)
    constexpr int K16 = KIN / 16;
    const int8_t* src = (MODE == 0 ? xq : gate) + static_cast<size_t>(b) * M * KIN;
    for (int base = tid; base < RA * K16; base += kSplitLoads * NT) {
      int4 w[kSplitLoads];
#pragma unroll
      for (int u = 0; u < kSplitLoads; ++u) {
        const int idx = base + u * NT, r = idx / K16, f = t0 - pad + r;
        w[u] = make_int4(0, 0, 0, 0);
        if (idx < RA * K16 && f >= 0 && f < M)
          w[u] = __ldg(reinterpret_cast<const int4*>(src + static_cast<size_t>(f) * KIN) +
                       (idx - r * K16));
      }
#pragma unroll
      for (int u = 0; u < kSplitLoads; ++u) {
        const int idx = base + u * NT, r = idx / K16;
        if (idx < RA * K16)
          *reinterpret_cast<int4*>(A + chunk_off(r, 16 * (idx - r * K16), RA)) = w[u];
      }
    }
  }
  fence_async();
  __syncthreads();

  // one wgmma group per tap as its weights land; a tap's stage is refilled
  // with tap + kStages once the group that read it has retired
  int acc[kSplitNB / 2];
#pragma unroll
  for (int j = 0; j < kSplitNB / 2; ++j) acc[j] = 0;
  fence_regs(acc);
  for (int tap = 0; tap < K; ++tap) {
    const int s = tap % kStages;
    mbar_wait(&bar[s], (tap / kStages) & 1);
    wg_fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)
      wgmma<kSplitNB>(acc, smem_desc(A + tap * step * 16 + 2 * kb * RA * 16, RA * 16, 128),
                      smem_desc(wsm + s * STAGE + kb * kSplitNB * 32, kLBO, kSBO));
    wg_commit();
    if (tap > 0) {
      wg_wait<1>();
      __syncthreads();  // tap - 1's group has retired in every warp
      const int tp = tap - 1;
      if (tid == 0 && tp + kStages < K) {
        const int sp = tp % kStages;
        mbar_expect(&bar[sp], STAGE);
        bulk_load(wsm + sp * STAGE, wgrp + static_cast<size_t>(tp + kStages) * STAGE, STAGE,
                  &bar[sp]);
      }
    }
  }
  wg_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int f = t0 + warp * 16 + g + 8 * hi;
    if (f >= M) continue;
    const bool live = f < nv;
    if (MODE == 0) {
      // columns 0-31: gate channels 32 grp + c of the a-half; 32-63: the b-half
      const float* gsb = gs + (static_cast<size_t>(b) * nd + i) * C;
      const Scale s2 = scale_of(v[4 * C + 1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = 32 * grp + 8 * j + 2 * t;
        int qq[2];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
          qq[e2] = live ? quant(Io<IO>::round(gate_value(acc[4 * j + 2 * hi + e2],
                                                        acc[4 * (j + 4) + 2 * hi + e2], v, gsb,
                                                        C, h + e2)),
                                s2)
                        : 0;
        store2(gate + (static_cast<size_t>(b) * M + f) * H + h, qq[0], qq[1]);
      }
    } else {
      const bool next = i + 1 < nd;
      const Scale s1n = scale_of(next ? vec[(i + 1) * VL + 4 * C] : 1.f);
#pragma unroll
      for (int j = 0; j < kSplitNB / 8; ++j) {
        const int co = kSplitNB * grp + 8 * j + 2 * t;
        const size_t off = (static_cast<size_t>(b) * M + f) * C + co;
        const float2 res = Io<IO>::load2(x + off);
        float2 o;
        o.x = live ? out_value<IO>(acc[4 * j + 2 * hi], v, C, co, res.x) : 0.f;
        o.y = live ? out_value<IO>(acc[4 * j + 2 * hi + 1], v, C, co + 1, res.y) : 0.f;
        Io<IO>::store2(out + off, o);
        if (next) store2(xq + off, quant(lrelu<IO>(o.x), s1n), quant(lrelu<IO>(o.y), s1n));
      }
    }
  }
}

// The plan's rules (vits_tpu_torch/nn/rb_chain.py: chain_halo, _k2,
// chain_layout, _chain_fit, chain_blocks_per_sm, split_layout, CHAIN_TILES),
// copied here so that a launch refuses a plan that does not fit its shape, as
// mas_forward does: a wrong offset or tile would compute a wrong chain with
// no error. Change both together.
constexpr int kSmemLimit = 232448;   // dynamic shared memory a block may use
constexpr int kSmShared = 233472;    // shared memory of one SM
constexpr int kChainSlack = 64;      // rows read past a tile by the last wgmma tile

int align_up(int n, int m) { return (n + m - 1) / m * m; }
int k2_of(int C) { return C / 2 > 32 ? C / 2 : 32; }

struct ChainLayout {
  int off_xs, off_q, off_g, off_bar, total;
};

ChainLayout chain_layout(int C, int K, int nd, int T, int halo, bool resident) {
  const int wbytes = (resident ? nd : 1) * K * C * (C + k2_of(C));
  const int R = T + 2 * halo;
  ChainLayout l;
  l.off_xs = align_up(wbytes, 16);
  l.off_q = l.off_xs + R * (C + 8) * 4;
  l.off_g = l.off_q + (R + kChainSlack) * C;
  l.off_bar = align_up(l.off_g + (R + kChainSlack) * k2_of(C), 8);
  l.total = l.off_bar + 16;
  return l;
}

// the whole-chain plan's numbers against those its rules give at this shape
// on this device: T a tile the plan weighs, the halo of the dilations, the
// residency _chain_fit picks, every offset, smem, and the persistent grid
bool chain_plan_ok(int B, int M, int C, int K, int nd, const int* dil, int T, int halo,
                   int resident, int off_xs, int off_q, int off_g, int off_bar, int smem,
                   int grid) {
  if (T < 64 || T > 512 || T % 32 || (resident != 0 && resident != 1)) return false;
  int h = 0;
  for (int i = 0; i < nd; ++i) {
    if (dil[i] < 1) return false;
    h += (dil[i] + 1) * (K - 1) / 2;
  }
  if (halo != h) return false;
  const bool fits_resident = chain_layout(C, K, nd, T, h, true).total <= kSmemLimit;
  const ChainLayout l = chain_layout(C, K, nd, T, h, fits_resident);
  if (resident != static_cast<int>(fits_resident) || l.total > kSmemLimit) return false;
  if (off_xs != l.off_xs || off_q != l.off_q || off_g != l.off_g || off_bar != l.off_bar ||
      smem != l.total)
    return false;
  int dev = 0, n_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return false;
  const long tiles = static_cast<long>(B) * ((M + T - 1) / T);
  const int per_sm = (C == 32 && 2 * (smem + 1024) <= kSmShared) ? 2 : 1;
  return grid == (tiles < per_sm * n_sm ? tiles : per_sm * n_sm);
}

// a split launch's layout (split_layout): the weight ring, the int8 input
// tile of 64 + (k - 1) step rows, one mbarrier per stage
bool split_plan_ok(int C, int K, int d, int mode, int off_a, int off_bar, int smem) {
  if (d < 1) return false;
  const int k_in = mode == 0 ? C : C / 2;
  const int rows = kSplitRows + (K - 1) * (mode == 0 ? d : 1);
  const int a = kStages * k_in * kSplitNB;
  const int bar = align_up(a + rows * k_in, 8);
  return off_a == a && off_bar == bar && smem == bar + 8 * kStages && smem <= kSmemLimit;
}

// sets a kernel's dynamic shared-memory limit once per size it has not seen
template <typename F>
cudaError_t allow_smem(F* kernel, int smem, int& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// 4 warpgroups where the accumulators leave room (C <= 64), else 2
template <typename IO, int C, int WG = (C <= 64 ? 4 : 2)>
cudaError_t launch_chain(const void* x, void* out, const int8_t* wq, const float* vec,
                         const float* gs, const int* valid, int B, int M, int K, int nd, int d0,
                         int d1, int d2, int T, int halo, int resident, int off_xs, int off_q,
                         int off_g, int off_bar, int smem, int grid, cudaStream_t st) {
  static int allowed = 48 * 1024;
  cudaError_t err = allow_smem(rb2_chain_kernel<IO, C, WG>, smem, allowed);
  if (err != cudaSuccess) return err;
  rb2_chain_kernel<IO, C, WG><<<grid, 128 * WG, smem, st>>>(
      static_cast<const IO*>(x), static_cast<IO*>(out), wq, vec, gs, valid, B, M, K, nd, d0, d1,
      d2, T, halo, resident, off_xs, off_q, off_g, off_bar);
  return cudaGetLastError();
}

template <typename IO, int MODE, int C>
cudaError_t launch_split(const void* x, int8_t* gate, int8_t* xq, void* out, const int8_t* wq,
                         const float* vec, const float* gs, const int* valid, int B, int M, int K,
                         int d, int i, int nd, int off_a, int off_bar, int smem, cudaStream_t st) {
  static int allowed = 48 * 1024;
  cudaError_t err = allow_smem(rb2_split_kernel<IO, MODE, C>, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kSplitRows - 1) / kSplitRows, MODE == 0 ? C / 64 : C / kSplitNB, B);
  rb2_split_kernel<IO, MODE, C><<<grid, kSplitThreads, smem, st>>>(
      static_cast<const IO*>(x), gate, xq, static_cast<IO*>(out), wq, vec, gs, valid, M, K, d, i,
      nd, off_a, off_bar);
  return cudaGetLastError();
}

template <typename IO>
cudaError_t launch_split_c(int mode, const void* x, int8_t* gate, int8_t* xq, void* out,
                           const int8_t* wq, const float* vec, const float* gs, const int* valid,
                           int B, int M, int C, int K, int d, int i, int nd, int off_a,
                           int off_bar, int smem, cudaStream_t st) {
#define RB2_SPLIT(MM, CC)                                                                   \
  if (mode == MM && C == CC)                                                               \
    return launch_split<IO, MM, CC>(x, gate, xq, out, wq, vec, gs, valid, B, M, K, d, i, nd, \
                                    off_a, off_bar, smem, st);
  RB2_SPLIT(0, 128)
  RB2_SPLIT(1, 128)
  RB2_SPLIT(0, 256)
  RB2_SPLIT(1, 256)
#undef RB2_SPLIT
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The whole chain (nd <= 3 dilations) in one launch; the tile geometry and
// the shared-memory offsets come from the wrapper's plan, and numbers that
// do not match the shape are refused (chain_plan_ok). x and out are float32,
// or bfloat16 where bf16 is 1. Returns the cudaError_t of the launch (0 on
// success).
int rb2_chain_q8(const void* x, void* out, const int8_t* wq, const float* vec, const float* gs,
                 const int* valid, int B, int M, int C, int K, int nd, int d0, int d1, int d2,
                 int T, int halo, int resident, int off_xs, int off_q, int off_g, int off_bar,
                 int smem, int grid, int bf16, void* stream) {
  const int dil[3] = {d0, d1, d2};
  if (B <= 0 || M <= 0 || K % 2 == 0 || nd < 1 || nd > 3 || (bf16 != 0 && bf16 != 1) ||
      !chain_plan_ok(B, M, C, K, nd, dil, T, halo, resident, off_xs, off_q, off_g, off_bar,
                     smem, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RB2_CHAIN(TT, CC)                                                                     \
  if (C == CC)                                                                                \
    return static_cast<int>(launch_chain<TT, CC>(x, out, wq, vec, gs, valid, B, M, K, nd, d0, \
                                                 d1, d2, T, halo, resident, off_xs, off_q,    \
                                                 off_g, off_bar, smem, grid, st));
  if (bf16) {
    RB2_CHAIN(__nv_bfloat16, 32)
    RB2_CHAIN(__nv_bfloat16, 64)
    RB2_CHAIN(__nv_bfloat16, 128)
  } else {
    RB2_CHAIN(float, 32)
    RB2_CHAIN(float, 64)
    RB2_CHAIN(float, 128)
  }
#undef RB2_CHAIN
  return static_cast<int>(cudaErrorInvalidValue);
}

// One half of dilation i of nd: mode 0 conv1 + gate (x, or xq past the
// first dilation -> gate), mode 1 conv2 + b2 + residual + mask (gate, x ->
// out, and xq for the next dilation). x and out as in rb2_chain_q8. A
// layout other than split_layout's for (C, K, d, mode) is refused.
int rb2_split_q8(int mode, const void* x, int8_t* gate, int8_t* xq, void* out, const int8_t* wq,
                 const float* vec, const float* gs, const int* valid, int B, int M, int C, int K,
                 int d, int i, int nd, int off_a, int off_bar, int smem, int bf16, void* stream) {
  if (B <= 0 || M <= 0 || K % 2 == 0 || (mode != 0 && mode != 1) || (bf16 != 0 && bf16 != 1) ||
      nd < 1 || i < 0 || i >= nd || !split_plan_ok(C, K, d, mode, off_a, off_bar, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_split_c<__nv_bfloat16>(mode, x, gate, xq, out, wq, vec, gs, valid, B, M, C,
                                           K, d, i, nd, off_a, off_bar, smem, st)
           : launch_split_c<float>(mode, x, gate, xq, out, wq, vec, gs, valid, B, M, C, K, d, i,
                                   nd, off_a, off_bar, smem, st);
  return static_cast<int>(err);
}

// Message of a cudaError_t returned above.
const char* rb2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
