// One dilation iteration of a ResBlock2 int8 chain, for Hopper (sm_90a).
//
// Replaces the TPU kernel K1, vits_tpu/nn/pallas_rb.py::_make_kernel
// (launched by resblock2_chain_q8, pallas_rb.py:223). The Pallas kernel keeps
// a whole 3-dilation chain resident in VMEM; here one launch runs one
// dilation, so a chain is 3 launches (vits_tpu_torch/nn/rb_chain.py drives
// them). A whole chain's halo is 6*(k-1) frames per side (60 at k = 11),
// which at C = 256 would leave a time tile of ~40 frames beside the f32
// residual in shared memory; one dilation's halo is (d+1)*(k-1)/2 frames and
// fits beside tiles of 16-128 frames.
//
// Per block (batch row b, time tile [t0, t0 + T)), 8 warps:
//   1. load the tile plus its halo once from x (B, M, C) f32, leaky-relu(0.1),
//      quantize to int8 (divide by s_in, round half to even, clip +-127) into
//      shared memory, 4 channels to a 32-bit word;
//   2. conv1 (k taps at dilation d, C -> C) on the int8 tensor cores
//      (mma.sync m16n8k32, s8 x s8 -> s32), dequantize (acc * s_in*s_w), add
//      the per-batch gate bias cond(g) + b1 (computed by the wrapper),
//      tanh(a) * sigmoid(b), zero the frames outside [0, valid), quantize
//      -> int8 gate in shared memory;
//   3. conv2 (k taps, C/2 -> C) the same way, dequantize, add b2 and the
//      residual x, zero the frames past valid, write out (B, M, C) f32.
// The gate never leaves the SM; each activation plane is read once and
// written once per dilation.
//
// The MMA fragments fall on the shared-memory layout as it is: an A fragment
// register holds 4 consecutive input channels of one frame (one word of a
// tile row), a B fragment register 4 consecutive input channels of one
// output channel (one word of the packed weights, (K, C_in/4, C_out)
// int32). A conv1 warp item is 16 frames x 8*NT1 channels of the GLU's
// a-half plus the same channels of its b-half, so the epilogue finds both
// halves of a gate value in one thread. Tile rows are padded to a word
// stride of 4 mod 8, which puts the 8 rows x 4 words of an A fragment load
// on 32 distinct banks.
//
// Bound. A whole chain (3 dilations) does 9*k*C^2 int8 ops per frame and must
// move 8*C bytes of f32 activations per frame (read x once, write out once):
// 9*k*C/8 ops per byte, 108 (C = 32, k = 3) to 3168 (C = 256, k = 11),
// against the H100's ridge of ~590 int8 ops per byte (1,979 TOP/s over
// 3.35 TB/s). So C = 256, and k = 7, 11 at C = 128 and k = 11 at C = 64,
// are bound by operations; the other five base shapes by bytes. Against the
// operations the products run on the int8 tensor cores, each A fragment
// feeding 2*NT1 (conv1) or 4 (conv2) MMAs; against the bytes the quantized
// tile and the gate stay on chip. What keeps it from both bounds: mma.sync
// reaches only part of the rate wgmma does, the weights stream from L1/L2
// into registers for every 16-frame row tile, and one launch per dilation
// moves the activation plane 3 times instead of once. wgmma/TMA, weights
// staged in shared memory and a whole-chain tile are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // frames per MMA row tile
constexpr int kNt2 = 4;    // conv2: 8-channel n-tiles per warp item (32 channels)

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// word stride of a tile row: at least `words`, and 4 mod 8
__host__ __device__ constexpr int row_stride(int words) { return words + (12 - words % 8) % 8; }

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : __fmul_rn(v, 0.1f); }

// quantize_act: IEEE division, round half to even, clip to +-127
__device__ __forceinline__ int quant(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return static_cast<int>(q);
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return static_cast<int>((static_cast<unsigned>(a) & 0xffu) |
                          ((static_cast<unsigned>(b) & 0xffu) << 8) |
                          ((static_cast<unsigned>(c) & 0xffu) << 16) |
                          ((static_cast<unsigned>(d) & 0xffu) << 24));
}

// D = A (16x32 s8, row) * B (32x8 s8, col) + D, s32
__device__ __forceinline__ void mma_k32(int (&c)[4], int a0, int a1, int a2, int a3,
                                        int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// D = A (16x16 s8, row) * B (16x8 s8, col) + D, s32
__device__ __forceinline__ void mma_k16(int (&c)[4], int a0, int a1, int b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// acc[j] = sum_tap sum_ci A[row0 + tap*step + r][ci] * W[tap][ci][n0[j] + n]
// over a 16-row tile (r) and NT n-tiles of 8 output channels (n). A: int8
// tile rows of `stride` words, `kw` words per row (kw % 4 == 0); W: (K, kw,
// C) words. lane = 4*g + t (the PTX fragment layout's groupID and
// threadID_in_group).
template <int NT>
__device__ __forceinline__ void conv_tile(int (&acc)[NT][4], const int* A, int stride,
                                          int row0, int step, const int* __restrict__ W,
                                          int K, int kw, int C, const int (&n0)[NT],
                                          int g, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  for (int tap = 0; tap < K; ++tap) {
    const int* ar = A + (row0 + tap * step + g) * stride + t;
    const int* wt = W + static_cast<size_t>(tap) * kw * C + t * C + g;
    int s = 0;
    for (; s + 8 <= kw; s += 8) {
      const int a0 = ar[s], a1 = ar[8 * stride + s];
      const int a2 = ar[s + 4], a3 = ar[8 * stride + s + 4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int b0 = __ldg(wt + s * C + n0[j]);
        const int b1 = __ldg(wt + (s + 4) * C + n0[j]);
        mma_k32(acc[j], a0, a1, a2, a3, b0, b1);
      }
    }
    if (s < kw) {  // a 16-channel tail (kw % 8 == 4)
      const int a0 = ar[s], a1 = ar[8 * stride + s];
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_k16(acc[j], a0, a1, __ldg(wt + s * C + n0[j]));
    }
  }
}

template <int NT1>
__global__ void __launch_bounds__(kThreads)
rb2_iter_q8_kernel(const float* __restrict__ x, float* __restrict__ out,
                   const int* __restrict__ w1p,   // (K, C/4, C): 4 int8 of C_in per word
                   const int* __restrict__ w2p,   // (K, C/8, C)
                   const float* __restrict__ deq1, const float* __restrict__ deq2,
                   const float* __restrict__ b2,
                   const float* __restrict__ ga, const float* __restrict__ gb,  // (B, C/2)
                   const int* __restrict__ valid, const float* __restrict__ s_in,
                   int M, int C, int K, int d, int T, int S1, int Sg) {
  extern __shared__ int smem[];
  const int H = C >> 1, C4 = C >> 2, H4 = H >> 2;
  const int s1w = row_stride(C4), sgw = row_stride(H4);
  int* q1 = smem;             // S1 rows of the quantized input tile
  int* q2 = smem + S1 * s1w;  // Sg rows of the quantized gate
  int8_t* q2b = reinterpret_cast<int8_t*>(q2);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * T;
  const int pad1 = d * (K - 1) / 2, pad2 = (K - 1) / 2;
  const int halo = pad1 + pad2;
  const int nvalid = valid[b];
  const float s1 = s_in[0], s2 = s_in[1];
  const float* xb = x + static_cast<size_t>(b) * M * C;
  float* ob = out + static_cast<size_t>(b) * M * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // 1. tile + halo -> leaky relu -> int8 (frames outside [0, M) are zero)
  for (int i = threadIdx.x; i < S1 * C4; i += kThreads) {
    const int r = i / C4, c4 = i - r * C4;
    const int f = t0 - halo + r;
    int word = 0;
    if (f >= 0 && f < M) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xb + static_cast<size_t>(f) * C) + c4);
      word = pack4(quant(lrelu(v.x), s1), quant(lrelu(v.y), s1),
                   quant(lrelu(v.z), s1), quant(lrelu(v.w), s1));
    }
    q1[r * s1w + c4] = word;
  }
  __syncthreads();

  // 2. conv1 + gate -> int8 gate rows; gate row r is frame t0 - pad2 + r.
  {
    const int n_groups = H / (8 * NT1);
    const int n_items = (Sg / kRows) * n_groups;
    for (int item = warp; item < n_items; item += kWarps) {
      const int rt = item / n_groups, grp = item - rt * n_groups;
      const int r0 = rt * kRows;
      int n0[2 * NT1];  // a-half n-tiles, then the matching b-half ones
#pragma unroll
      for (int j = 0; j < NT1; ++j) {
        n0[j] = grp * 8 * NT1 + j * 8;
        n0[NT1 + j] = n0[j] + H;
      }
      int acc[2 * NT1][4];
      conv_tile<2 * NT1>(acc, q1, s1w, r0, d, w1p, K, C4, C, n0, g, t);
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + (e >> 1) * 8;    // C fragment: rows g, g + 8,
          const int h = n0[j] + 2 * t + (e & 1);  // columns 2t, 2t + 1
          const int f = t0 - pad2 + r;
          float gate = 0.f;
          if (f >= 0 && f < nvalid) {
            const float ya = __fadd_rn(__fmul_rn(static_cast<float>(acc[j][e]), deq1[h]),
                                       ga[b * H + h]);
            const float yb = __fadd_rn(
                __fmul_rn(static_cast<float>(acc[NT1 + j][e]), deq1[h + H]), gb[b * H + h]);
            gate = __fmul_rn(tanhf(ya), __fdiv_rn(1.f, __fadd_rn(1.f, expf(-yb))));
          }
          q2b[r * sgw * 4 + h] = static_cast<int8_t>(quant(gate, s2));
        }
    }
  }
  __syncthreads();

  // 3. conv2 + b2 + residual + mask -> out; output row r is frame t0 + r.
  {
    const int Tt = min(T, M - t0);
    const int n_groups = C / (8 * kNt2);
    const int n_items = ((Tt + kRows - 1) / kRows) * n_groups;
    for (int item = warp; item < n_items; item += kWarps) {
      const int rt = item / n_groups, grp = item - rt * n_groups;
      const int r0 = rt * kRows;
      int n0[kNt2];
#pragma unroll
      for (int j = 0; j < kNt2; ++j) n0[j] = grp * 8 * kNt2 + j * 8;
      int acc[kNt2][4];
      conv_tile<kNt2>(acc, q2, sgw, r0, 1, w2p, K, H4, C, n0, g, t);
#pragma unroll
      for (int j = 0; j < kNt2; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int r = r0 + g + hi * 8;
          if (r < Tt) {
            const int co = n0[j] + 2 * t;
            const int f = t0 + r;
            const size_t off = static_cast<size_t>(f) * C + co;
            const float2 res = *reinterpret_cast<const float2*>(xb + off);
            float2 v;
            v.x = __fadd_rn(__fadd_rn(__fmul_rn(static_cast<float>(acc[j][2 * hi]), deq2[co]),
                                      b2[co]), res.x);
            v.y = __fadd_rn(__fadd_rn(__fmul_rn(static_cast<float>(acc[j][2 * hi + 1]),
                                                deq2[co + 1]), b2[co + 1]), res.y);
            if (f >= nvalid) v.x = v.y = 0.f;
            *reinterpret_cast<float2*>(ob + off) = v;
          }
        }
    }
  }
}

void tile_rows(int K, int d, int T, int* S1, int* Sg) {
  *Sg = round_up(round_up(T, kRows) + K - 1, kRows);
  *S1 = *Sg + (K - 1) * d;
}

template <int NT1>
cudaError_t launch(const float* x, float* out, const int* w1p, const int* w2p,
                   const float* deq1, const float* deq2, const float* b2, const float* ga,
                   const float* gb, const int* valid, const float* s_in, int B, int M, int C,
                   int K, int d, int T, int smem, cudaStream_t stream) {
  int S1, Sg;
  tile_rows(K, d, T, &S1, &Sg);
  cudaError_t err = cudaFuncSetAttribute(rb2_iter_q8_kernel<NT1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + T - 1) / T, B);
  rb2_iter_q8_kernel<NT1><<<grid, kThreads, smem, stream>>>(
      x, out, w1p, w2p, deq1, deq2, b2, ga, gb, valid, s_in, M, C, K, d, T, S1, Sg);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for a tile of T frames.
int rb2_iter_q8_smem_bytes(int C, int K, int d, int T) {
  int S1, Sg;
  tile_rows(K, d, T, &S1, &Sg);
  return (S1 * row_stride(C / 4) + Sg * row_stride(C / 8)) * static_cast<int>(sizeof(int));
}

// Launches one dilation iteration on `stream`; returns the cudaError_t of the
// launch (0 on success). Shapes: x, out (B, M, C) f32 contiguous,
// C % 32 == 0, K odd.
int rb2_iter_q8(const float* x, float* out, const int* w1p, const int* w2p,
                const float* deq1, const float* deq2, const float* b2,
                const float* ga, const float* gb, const int* valid, const float* s_in,
                int B, int M, int C, int K, int d, int T, void* stream) {
  if (B <= 0 || M <= 0 || T <= 0 || C % 32 != 0 || K % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = rb2_iter_q8_smem_bytes(C, K, d, T);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // conv1's a-half (C/2 channels) in warp groups of 32 channels when it
  // divides, else of 16 (C = 32, 96, ...)
  const cudaError_t err =
      (C / 2) % 32 == 0
          ? launch<4>(x, out, w1p, w2p, deq1, deq2, b2, ga, gb, valid, s_in, B, M, C, K, d, T,
                      smem, s)
          : launch<2>(x, out, w1p, w2p, deq1, deq2, b2, ga, gb, valid, s_in, B, M, C, K, d, T,
                      smem, s);
  return static_cast<int>(err);
}

// Message of a cudaError_t returned by rb2_iter_q8.
const char* rb2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
