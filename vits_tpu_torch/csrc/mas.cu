// Monotonic alignment search (MAS) for Hopper (sm_90a).
//
// Replaces the TPU kernel K2, vits_tpu/ops/mas.py::_mas_kernel (launched by
// maximum_path_pallas, mas.py:192). What it computes, per utterance b with
// lengths t_y, t_x: a Viterbi DP over rows y,
//   v[y, x] = neg[y, x] + max(v[y-1, x], v[y-1, x-1])          (f32 add)
// inside the band x <= y, x >= t_x - t_y + y, x < t_x, y < t_y (cells outside
// hold exactly -1e9; v[-1, .] = -1e9 and the left neighbour of x = 0 is 0 at
// y = 0, -1e9 after), then a backtrace from (t_y - 1, t_x - 1) that moves one
// column left when x == y or v[y-1, x] < v[y-1, x-1] (strict). The output is
// the 0/1 path (B, T_y, T_x) f32.
//
// Design. The Pallas kernel keeps the whole f32 value plane in VMEM; at the
// base config's longest utterance (1000 x 384) that is 1.5 MB, far past a
// block's 227 KB of shared memory. So one block runs one utterance with its
// threads over x (T_x rounded up to 32, XPT columns per thread when T_x >
// 1024) and a loop over y inside the block (the Pallas grid's sequential
// axis); only the previous DP row lives in shared memory, double-buffered,
// one __syncthreads() per row. Instead of the values, each row stores one
// move-left bit per cell, bit[y][x] = (x == y) || (v[y-1][x] < v[y-1][x-1]),
// which is exactly the backtrace's test on row y - 1 (the rows hold the same
// f32 values as the scan's, the exact -1e9 included), packed 32 to a word by
// __ballot_sync: T_y * ceil(T_x / 32) words, 48 KB at 1000 x 384. The bits
// and the backtrace's column per row stay in shared memory when they fit,
// else in a global scratch buffer the wrapper allocates. After the forward
// pass one thread walks y down from t_y - 1 reading one bit per row; then
// all threads write the zero-filled path rows, coalesced, with the single 1
// of each valid row.
//
// Bound. By bytes its least time is one read of neg and one write of the
// path, 8 * B * T_y * T_x bytes at 3.35 TB/s: about 1.5 us at 16 x 400 x 96.
// It is bound by latency instead: t_y dependent rows, each waiting on a block
// barrier, then a t_y-step serial backtrace, with one block per utterance
// (B of the 132 SMs busy). The next row of neg is loaded while the current
// row is computed, which hides the global read behind the barrier. No
// PyTorch call computes the same function.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use on sm_90

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

template <int XPT>
__global__ void __launch_bounds__(kMaxThreads)
mas_kernel(const float* __restrict__ neg, const int* __restrict__ t_ys,
           const int* __restrict__ t_xs, float* __restrict__ path, uint32_t* scratch,
           int T_y, int T_x, int W, int TXP, int bits_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* rows = reinterpret_cast<float*>(smem_raw);  // 2 x TXP: v[y-1], v[y]
  int* idx;                                          // T_y: the path's column per row
  uint32_t* bits;                                    // T_y x W move-left words
  const int b = blockIdx.x;
  if (bits_in_smem) {
    idx = reinterpret_cast<int*>(rows + 2 * TXP);
    bits = reinterpret_cast<uint32_t*>(idx + T_y);
  } else {
    bits = scratch + static_cast<size_t>(b) * (static_cast<size_t>(T_y) * W + T_y);
    idx = reinterpret_cast<int*>(bits + static_cast<size_t>(T_y) * W);
  }
  const int tid = threadIdx.x, nt = blockDim.x;
  const int t_y = min(max(t_ys[b], 0), T_y);
  const int t_x = min(max(t_xs[b], 0), T_x);
  const float* nb = neg + static_cast<size_t>(b) * T_y * T_x;
  float* pb = path + static_cast<size_t>(b) * T_y * T_x;

#pragma unroll
  for (int k = 0; k < XPT; ++k) rows[tid + k * nt] = kNegInf;  // v[-1, .]
  float cur[XPT];
#pragma unroll
  for (int k = 0; k < XPT; ++k) {
    const int x = tid + k * nt;
    cur[k] = (t_y > 0 && x < T_x) ? nb[x] : 0.f;
  }
  __syncthreads();

  for (int y = 0; y < t_y; ++y) {
    const float* prev = rows + (y & 1) * TXP;
    float* next = rows + ((y + 1) & 1) * TXP;
    float nxt[XPT];
#pragma unroll
    for (int k = 0; k < XPT; ++k) {  // prefetch row y + 1
      const int x = tid + k * nt;
      nxt[k] = (y + 1 < t_y && x < T_x) ? nb[static_cast<size_t>(y + 1) * T_x + x] : 0.f;
    }
    const int lo = t_x - t_y + y;
#pragma unroll
    for (int k = 0; k < XPT; ++k) {
      const int x = tid + k * nt;
      const float here = prev[x];
      const float left = x == 0 ? (y == 0 ? 0.f : kNegInf) : prev[x - 1];
      const float best = fmaxf(here, left);
      const bool feas = x <= y && x >= lo && x < t_x;
      next[x] = feas ? cur[k] + best : kNegInf;
      const bool move = x == y || (x > 0 && here < left);
      const uint32_t word = __ballot_sync(0xffffffffu, move);
      if ((tid & 31) == 0 && (x >> 5) < W) bits[static_cast<size_t>(y) * W + (x >> 5)] = word;
      cur[k] = nxt[k];
    }
    __syncthreads();
  }

  if (tid == 0) {
    int i = max(t_x - 1, 0);
    for (int y = t_y - 1; y >= 0; --y) {
      idx[y] = i;
      if (y > 0 && i != 0 && ((bits[static_cast<size_t>(y) * W + (i >> 5)] >> (i & 31)) & 1u))
        --i;
    }
  }
  __syncthreads();

  for (int y = 0; y < T_y; ++y) {
    const int iy = y < t_y ? idx[y] : -1;
    float* row = pb + static_cast<size_t>(y) * T_x;
    for (int x = tid; x < T_x; x += nt) row[x] = x == iy ? 1.f : 0.f;
  }
}

struct Geometry {
  int xpt, threads, txp, words, smem, bits_in_smem;
  int64_t scratch_words;  // per utterance, 0 when everything fits in shared memory
};

// Columns per thread (a power of two up to 32), threads (a multiple of 32),
// and where the bits and the backtrace columns live.
bool geometry(int T_y, int T_x, Geometry* g) {
  if (T_y <= 0 || T_x <= 0) return false;
  int xpt = 1;
  while (xpt <= 32 && round_up((T_x + xpt - 1) / xpt, 32) > kMaxThreads) xpt *= 2;
  if (xpt > 32) return false;
  g->xpt = xpt;
  g->threads = round_up((T_x + xpt - 1) / xpt, 32);
  g->txp = xpt * g->threads;
  g->words = (T_x + 31) / 32;
  const int64_t rows = 2LL * g->txp * 4;
  const int64_t all = rows + 4LL * T_y + 4LL * T_y * g->words;
  g->bits_in_smem = all <= kSmemLimit;
  g->smem = static_cast<int>(g->bits_in_smem ? all : rows);
  g->scratch_words = g->bits_in_smem ? 0 : static_cast<int64_t>(T_y) * g->words + T_y;
  return rows <= kSmemLimit;
}

template <int XPT>
cudaError_t launch(const float* neg, const int* t_ys, const int* t_xs, float* path,
                   uint32_t* scratch, int B, int T_y, int T_x, const Geometry& g,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mas_kernel<XPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return err;
  mas_kernel<XPT><<<B, g.threads, g.smem, stream>>>(neg, t_ys, t_xs, path, scratch, T_y, T_x,
                                                     g.words, g.txp, g.bits_in_smem);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 32-bit words of global scratch one utterance needs (0: none, the bits fit
// in shared memory); -1 for a shape the kernel does not take.
int64_t mas_scratch_words(int T_y, int T_x) {
  Geometry g;
  return geometry(T_y, T_x, &g) ? g.scratch_words : -1;
}

// Launches the search on `stream`; returns the cudaError_t of the launch (0 on
// success). neg (B, T_y, T_x) f32, path (B, T_y, T_x) f32, t_ys/t_xs (B,)
// int32, all contiguous on the device; scratch holds B * mas_scratch_words
// words (may be null when that is 0). Lengths are clamped to [0, T_y] and
// [0, T_x].
int mas_forward(const float* neg, const int* t_ys, const int* t_xs, float* path,
                uint32_t* scratch, int B, int T_y, int T_x, void* stream) {
  Geometry g;
  if (B <= 0 || !geometry(T_y, T_x, &g) || (g.scratch_words > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (g.xpt) {
    case 1: err = launch<1>(neg, t_ys, t_xs, path, scratch, B, T_y, T_x, g, s); break;
    case 2: err = launch<2>(neg, t_ys, t_xs, path, scratch, B, T_y, T_x, g, s); break;
    case 4: err = launch<4>(neg, t_ys, t_xs, path, scratch, B, T_y, T_x, g, s); break;
    case 8: err = launch<8>(neg, t_ys, t_xs, path, scratch, B, T_y, T_x, g, s); break;
    case 16: err = launch<16>(neg, t_ys, t_xs, path, scratch, B, T_y, T_x, g, s); break;
    default: err = launch<32>(neg, t_ys, t_xs, path, scratch, B, T_y, T_x, g, s); break;
  }
  return static_cast<int>(err);
}

// Message of a cudaError_t returned by mas_forward.
const char* mas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
