// The float decoder's glue: the elementwise work around the cuDNN convs of
// `Generator.forward`'s packed body (vits_tpu_torch/nn/dec_glue.py), in two
// kernels. It replaces no TPU kernel: XLA fuses this glue into the convs'
// neighbours on the TPU, where PyTorch's eager ops make one pass each.
//
// Activations are (B, C, T) float32, T contiguous. A dilation step of a
// resblock runs conv1 -> dg_gate_kernel -> conv2 -> dg_epilogue_kernel:
//
//   gate      h = tanh(a[:half] + s[:half]) * sigmoid(a[half:] + s[half:])
//             (GLU, ResBlock2) or h = tanh(a + s) (ResBlock1), masked; s is
//             one float a (utterance, channel): conv1's bias plus the
//             speaker term.
//   epilogue  v = ((acc + ((c + bias) + x)) / div) * mask; it writes v,
//             act(v) or both, act a leaky ReLU or tanh. Every
//             input but c is optional: the same kernel is the residual add of
//             a dilation step (v and lrelu(v), the next conv1's input), the
//             resblocks' running sum and mean, and the stages' own glue
//             (conv_pre's and each upsample's bias, mask and leaky ReLU, and
//             the final tanh).
//
// The mask is a prefix: row b is valid for t < valid[b] * vmul (all of T
// where valid is null). Past it both kernels write zeros without reading.
//
// Bound: bytes. Each kernel reads its inputs once and writes its outputs
// once: 8-12 bytes an element against a handful of flops, far below the
// card's ~20 flops a byte. So: one block row a (b, c) row, its per-channel
// terms (bias, s, the valid length) loaded once; 128-bit loads and stores
// along T where T % 4 == 0 and the pointers are 16-byte aligned (scalar
// otherwise); a grid of about 8 blocks of 256 threads an SM over the 132 SMs,
// each block striding along its row. Accurate tanhf and expf (no fast math),
// as PyTorch's own tanh and sigmoid. Nothing is allocated here; the kernels
// launch on the caller's stream and each entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksTarget = 132 * 8;

enum Act { kNone = 0, kLrelu = 1, kTanh = 2 };

__device__ __forceinline__ float act_of(float v, int act, float slope) {
  if (act == kLrelu) return v > 0.f ? v : v * slope;
  if (act == kTanh) return tanhf(v);
  return v;
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ int row_valid(const int* valid, int b, int vmul, int T) {
  if (valid == nullptr) return T;
  long long n = (long long)valid[b] * vmul;
  return n < 0 ? 0 : (n > T ? T : (int)n);
}

__device__ __forceinline__ float gate_of(float a0, float a1, float s0, float s1, int glu) {
  return glu ? tanhf(a0 + s0) * sigmoidf(a1 + s1) : tanhf(a0 + s0);
}

// a (B, Ca, T), s rows of stride s_stride, out (B, Co, T); Co = Ca / 2 (GLU)
// or Ca. grid (x: blocks along T, y: B * Co rows).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dg_gate_kernel(const float* __restrict__ a, const float* __restrict__ s, int s_stride,
               const int* __restrict__ valid, int vmul, float* __restrict__ out,
               int Co, int Ca, int T, int glu) {
  const int row = blockIdx.y;
  const int b = row / Co, c = row % Co;
  const float s0 = s[(long long)b * s_stride + c];
  const float s1 = glu ? s[(long long)b * s_stride + c + Co] : 0.f;
  const int n = row_valid(valid, b, vmul, T);
  const float* a0 = a + ((long long)b * Ca + c) * T;
  const float* a1 = a0 + (long long)Co * T;
  float* o = out + (long long)row * T;
  const int stride = gridDim.x * kThreads;
  if (kVec) {
    const int T4 = T >> 2;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < T4; i += stride) {
      const int t = i << 2;
      float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < n) {
        const float4 x0 = reinterpret_cast<const float4*>(a0)[i];
        const float4 x1 = glu ? reinterpret_cast<const float4*>(a1)[i] : x0;
        r.x = gate_of(x0.x, x1.x, s0, s1, glu);
        r.y = t + 1 < n ? gate_of(x0.y, x1.y, s0, s1, glu) : 0.f;
        r.z = t + 2 < n ? gate_of(x0.z, x1.z, s0, s1, glu) : 0.f;
        r.w = t + 3 < n ? gate_of(x0.w, x1.w, s0, s1, glu) : 0.f;
      }
      reinterpret_cast<float4*>(o)[i] = r;
    }
  } else {
    for (int t = blockIdx.x * kThreads + threadIdx.x; t < T; t += stride)
      o[t] = t < n ? gate_of(a0[t], glu ? a1[t] : 0.f, s0, s1, glu) : 0.f;
  }
}

struct EpiArgs {
  const float* c;     // (B, C, T)
  const float* bias;  // (C,) or null
  const float* x;     // (B, C, T) or null
  const float* acc;   // (B, C, T) or null; may be out_v
  const int* valid;   // (B,) or null
  float* out_v;       // or null; may alias x or acc
  float* out_a;       // or null
  int C, T, vmul, act;
  float div, slope;
};

__device__ __forceinline__ void epi_one(const EpiArgs& p, float cv, float bias, float xv,
                                        float accv, bool in, float& v, float& av) {
  v = cv + bias;
  if (p.x) v = v + xv;
  if (p.acc) v = accv + v;
  if (p.div != 1.f) v = v / p.div;
  if (p.valid) v = v * (in ? 1.f : 0.f);
  av = act_of(v, p.act, p.slope);
}

// grid (x: blocks along T, y: B * C rows). No __restrict__ on x, acc and the
// outputs: out_v may be x or acc (each element is read, then written, by one
// thread).
template <bool kVec>
__global__ void __launch_bounds__(kThreads) dg_epilogue_kernel(EpiArgs p) {
  const int row = blockIdx.y;
  const int b = row / p.C, ch = row % p.C;
  const float bias = p.bias ? p.bias[ch] : 0.f;
  const int n = row_valid(p.valid, b, p.vmul, p.T);
  const long long base = (long long)row * p.T;
  const int stride = gridDim.x * kThreads;
  if (kVec) {
    const int T4 = p.T >> 2;
    const float4* c4 = reinterpret_cast<const float4*>(p.c + base);
    const float4* x4 = p.x ? reinterpret_cast<const float4*>(p.x + base) : nullptr;
    const float4* acc4 = p.acc ? reinterpret_cast<const float4*>(p.acc + base) : nullptr;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < T4; i += stride) {
      const int t = i << 2;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f), a = v;
      if (t < n) {
        const float4 cv = c4[i];
        const float4 xv = x4 ? x4[i] : v;
        const float4 av = acc4 ? acc4[i] : v;
        epi_one(p, cv.x, bias, xv.x, av.x, true, v.x, a.x);
        epi_one(p, cv.y, bias, xv.y, av.y, t + 1 < n, v.y, a.y);
        epi_one(p, cv.z, bias, xv.z, av.z, t + 2 < n, v.z, a.z);
        epi_one(p, cv.w, bias, xv.w, av.w, t + 3 < n, v.w, a.w);
      }
      if (p.out_v) reinterpret_cast<float4*>(p.out_v + base)[i] = v;
      if (p.out_a) reinterpret_cast<float4*>(p.out_a + base)[i] = a;
    }
  } else {
    for (int t = blockIdx.x * kThreads + threadIdx.x; t < p.T; t += stride) {
      float v = 0.f, a = 0.f;
      if (t < n)
        epi_one(p, p.c[base + t], bias, p.x ? p.x[base + t] : 0.f,
                p.acc ? p.acc[base + t] : 0.f, true, v, a);
      if (p.out_v) p.out_v[base + t] = v;
      if (p.out_a) p.out_a[base + t] = a;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

dim3 grid_of(int rows, int T, bool vec) {
  const int per_row = vec ? T >> 2 : T;
  int bx = (per_row + kThreads - 1) / kThreads;
  const int want = (kBlocksTarget + rows - 1) / rows;
  if (bx > want) bx = want;
  return dim3(bx < 1 ? 1 : bx, rows);
}

}  // namespace

extern "C" {

// dg_gate: out (B, Co, T) from conv1's a (B, Ca, T) and s (row b at s +
// b * s_stride, Ca floats). glu: Co = Ca / 2, else Co = Ca.
int dg_gate(const float* a, const float* s, int s_stride, const int* valid, int vmul, float* out,
            int B, int Co, int Ca, int T, int glu, void* stream) {
  if (B <= 0 || Co <= 0 || T <= 0 || B * Co > 65535 || Ca != (glu ? 2 * Co : Co))
    return (int)cudaErrorInvalidValue;
  const bool vec = T % 4 == 0 && aligned16(a) && aligned16(out) &&
                   (!glu || aligned16(a + (long long)Co * T));
  const dim3 grid = grid_of(B * Co, T, vec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    dg_gate_kernel<true><<<grid, kThreads, 0, st>>>(a, s, s_stride, valid, vmul, out, Co, Ca, T,
                                                    glu);
  else
    dg_gate_kernel<false><<<grid, kThreads, 0, st>>>(a, s, s_stride, valid, vmul, out, Co, Ca,
                                                     T, glu);
  return (int)cudaGetLastError();
}

// dg_epilogue: see the top of the file. act 0 none, 1 leaky ReLU (slope), 2
// tanh. At least one of out_v, out_a.
int dg_epilogue(const float* c, const float* bias, const float* x, const float* acc,
                const int* valid, int vmul, float* out_v, float* out_a, int B, int C, int T,
                float div, int act, float slope, void* stream) {
  if (B <= 0 || C <= 0 || T <= 0 || B * C > 65535 || act < 0 || act > 2 ||
      (out_v == nullptr && out_a == nullptr))
    return (int)cudaErrorInvalidValue;
  EpiArgs p{c, bias, x, acc, valid, out_v, out_a, C, T, vmul, act, div, slope};
  const bool vec = T % 4 == 0 && aligned16(c) && (!x || aligned16(x)) &&
                   (!acc || aligned16(acc)) && (!out_v || aligned16(out_v)) &&
                   (!out_a || aligned16(out_a));
  const dim3 grid = grid_of(B * C, T, vec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    dg_epilogue_kernel<true><<<grid, kThreads, 0, st>>>(p);
  else
    dg_epilogue_kernel<false><<<grid, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

const char* dg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
