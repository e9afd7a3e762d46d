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
// Both forms keep the Pallas kernel's sequential grid axis as a loop over y
// inside one block per utterance, and neither keeps the f32 value plane (1.5
// MB at the base config's 1000 x 384, past a block's 227 KB): each row
// stores one move-left bit per cell instead,
//   bit[y][x] = (x == y) || (v[y-1][x] < v[y-1][x-1]),
// which is exactly the backtrace's test on row y - 1 (the rows hold the same
// f32 values as the scan's, the exact -1e9 included; the bit at x = 0 is
// never read), packed 32 to a word by __ballot_sync. The wrapper
// (vits_tpu_torch/ops/mas.py::plan) picks the form and passes its numbers;
// mas_forward checks them against the shape with its own copy of the plan's
// rules (kWarpRs, warp_smem, geometry: keep them equal to ops/mas.py's;
// tests/test_torch_cuda.py::test_mas_plan_agrees_with_the_kernel runs the
// two against each other on the card).
//
// Bound. By bytes its least time is one read of the t_y x t_x cells of neg
// and one write of the path, about 1.4 us at 16 x 400 x 96 at 3.35 TB/s. It
// is bound instead by the DP's t_y dependent rows (an fmax, an f32 add and a
// neighbour exchange each, plus the row's other columns on one SM
// sub-partition's issue slots), then the t_y-step walk back, with B of the
// 132 SMs busy.
//
// Form "warp" (T_x <= 992, ring and bits within shared memory), for the
// training step's shapes. A block of four warps per utterance, with roles:
//  - warp 0 runs the DP with no block barrier per row. Lane l holds the R
//    contiguous columns x = l * R + r in registers, R the first of kWarpRs
//    with 32 R >= T_x (odd, and at most 31); the left neighbour of its first
//    column is one __shfl_up_sync of lane l - 1's last. Per row, R full-warp
//    ballots give R words, word r holding column l * R + r at bit l, and
//    lane r stores word r (T_y * R words in shared memory).
//  - neg arrives ahead of the DP in a shared-memory ring of D rows (as many
//    as fit, up to 256), in four parts of D / 4 rows: warps 1-3 copy a part
//    with coalesced loads (float4 where T_x is a multiple of 4) and release
//    it by a named barrier, and warp 0 hands it back by another once its rows
//    are done. The ring keeps neg's row layout; an odd R puts lane l's read
//    of column l * R + r on its own bank.
//  - warps 1-3 zero-fill the utterance's whole path, a chunk per part.
//  - after the block's one __syncthreads(), warp 0 walks back 32 rows at a
//    time: lane k reads column i0 - k's bit in each of the 32 rows, a ballot
//    per row gathers those into one word per row, then every lane walks the
//    32 words in registers (a shift, an and, an add per row) and lane j
//    stores row y0 - j's one.
// Measured on an H100 (scripts/probe_k2_phases.py), the DP takes most of
// the time; per-thread 4-byte cp.async copies of neg, tried first, cost more
// than the DP itself.
// Form "block" (the shapes "warp" does not take: T_x > 992, or bits past
// shared memory): one block per utterance with its threads over x (XPT
// columns each when T_x > 1024), the previous DP row double-buffered in
// shared memory and one __syncthreads() per row; the bits and the path's
// column per row in shared memory where they fit, else in a global scratch
// the wrapper allocates; a one-thread backtrace, then coalesced writes of
// the zero-filled path rows with their ones.
// No PyTorch call computes the same function.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use on sm_90
constexpr int kWarpThreads = 128;   // form "warp": the DP warp and three fill warps
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// ---------------------------------------------------------------------------
// form "warp"
// ---------------------------------------------------------------------------

constexpr int kParts = 4;              // the ring's parts, each K = D / 4 rows of neg
constexpr int kFullBar = 1;            // named barriers kFullBar + part: a part has landed
constexpr int kEmptyBar = 1 + kParts;  // kEmptyBar + part: warp 0 is done with a part
constexpr int kBatch = 8;              // loads (of float4, else of float) a copying
                                       // thread keeps in flight

// Named barriers over the block's 128 threads: the copying warps arrive,
// warp 0 waits (and the other way round for a part's reuse).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kWarpThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kWarpThreads) : "memory");
}

// Zeroes p[0, n) with threads t of nt: float4 stores between unaligned ends.
__device__ __forceinline__ void zero_fill(float* p, size_t n, int t, int nt) {
  size_t head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4;
  if (head > n) head = n;
  const size_t n4 = (n - head) / 4;
  for (size_t i = t; i < head; i += nt) p[i] = 0.f;
  float4* p4 = reinterpret_cast<float4*>(p + head);
  for (size_t i = t; i < n4; i += nt) p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (size_t i = head + 4 * n4 + t; i < n; i += nt) p[i] = 0.f;
}

// Threads t of nt copy rows [0, n) of src (row stride T_x) into ring rows
// of W = T_x rounded up to 4 floats. Where T_x is a multiple of 4 (and src
// 16-byte aligned) the rows are one block of float4, copied whole; else the
// first t_x columns, element e = k * t_x + x by thread e % nt. Loads are
// coalesced, kBatch in flight per thread before their stores.
__device__ __forceinline__ void copy_rows(float* dst, const float* __restrict__ src, int n,
                                          int t_x, int T_x, int W, bool vec, int t, int nt) {
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const int n4 = n * (T_x / 4);
    for (int c0 = t; c0 < n4; c0 += kBatch * nt) {
      float4 val[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (c0 + u * nt < n4) val[u] = __ldg(s4 + c0 + u * nt);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (c0 + u * nt < n4) d4[c0 + u * nt] = val[u];
    }
    return;
  }
  if (t_x <= 0) return;
  const int dk = nt / t_x, dx = nt % t_x;  // one step of nt elements
  int k = t / t_x, x = t % t_x;            // this thread's next element
  while (k < n) {
    float val[kBatch];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      at[u] = -1;
      if (k < n) {
        val[u] = __ldg(src + static_cast<size_t>(k) * T_x + x);
        at[u] = k * W + x;
        k += dk;
        x += dx;
        if (x >= t_x) {
          x -= t_x;
          ++k;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (at[u] >= 0) dst[at[u]] = val[u];
  }
}

template <int R>
__global__ void __launch_bounds__(kWarpThreads)
mas_warp_kernel(const float* __restrict__ neg, const int* __restrict__ t_ys,
                const int* __restrict__ t_xs, float* __restrict__ path, int T_y, int T_x,
                int D) {
  static_assert(R % 2 == 1, "an odd R keeps warp 0's ring reads on 32 banks");
  static_assert(R <= 32, "lane r keeps and stores word r of a row");
  // The ring: D rows of W floats as in neg, then 32 R floats that the last
  // row's padded columns read; lane l reads row[l * R + r], 32 banks apart.
  const int W = (T_x + 3) / 4 * 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  uint32_t* bits = reinterpret_cast<uint32_t*>(ring + D * W + 32 * R);  // T_y rows of R words
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t_y = min(max(t_ys[b], 0), T_y);
  const int t_x = min(max(t_xs[b], 0), T_x);
  const float* nb = neg + static_cast<size_t>(b) * T_y * T_x;
  float* pb = path + static_cast<size_t>(b) * T_y * T_x;
  const int K = D / kParts;
  const int n_groups = (t_y + K - 1) / K;  // groups of K rows, one ring part each

  if (warp > 0) {
    // Warps 1-3: copy each group's t_x columns of neg into its ring part
    // and release it to warp 0, then zero-fill one chunk of the path.
    const int t = threadIdx.x - 32, nt = kWarpThreads - 32;
    const size_t n_path = static_cast<size_t>(T_y) * T_x;
    if (n_groups == 0) zero_fill(pb, n_path, t, nt);
    const size_t chunk = n_groups ? (n_path + n_groups - 1) / n_groups : 0;
    const bool vec = T_x % 4 == 0 && (reinterpret_cast<uintptr_t>(neg) & 15) == 0;
    for (int g = 0; g < n_groups; ++g) {
      const int part = g % kParts;
      if (g >= kParts) bar_sync(kEmptyBar + part);
      const int y0 = g * K;
      copy_rows(ring + part * K * W, nb + static_cast<size_t>(y0) * T_x, min(K, t_y - y0), t_x,
                T_x, W, vec, t, nt);
      bar_arrive(kFullBar + part);  // orders the stores before warp 0's bar.sync
      const size_t c0 = g * chunk;
      if (c0 < n_path) zero_fill(pb + c0, n_path - c0 < chunk ? n_path - c0 : chunk, t, nt);
    }
  } else {
    // Warp 0: the DP, lane l on columns l * R + r, no block barrier per row.
    // Cell (y, x) is in the band iff 0 <= y - x < lim and x < t_x; xo[r] is
    // the lane's column x, or far below 0 where x >= t_x so that y - xo[r]
    // fails the test. Move bits at x = 0 and x >= t_x are never read.
    const int lim = max(t_y - t_x + 1, 0);
    int xo[R];
    float v[R];  // v[y - 1][lane * R + r]
#pragma unroll
    for (int r = 0; r < R; ++r) {
      xo[r] = lane * R + r < t_x ? lane * R + r : -(1 << 30);
      v[r] = kNegInf;
    }
    for (int g = 0; g < n_groups; ++g) {
      const int part = g % kParts;
      bar_sync(kFullBar + part);
      const float* rows = ring + part * K * W + lane * R;
      const int y0 = g * K, n = min(K, t_y - y0);
      for (int k = 0; k < n; ++k) {
        const int y = y0 + k;
        float cur[R];  // neg[y][lane * R + r]
#pragma unroll
        for (int r = 0; r < R; ++r) cur[r] = rows[k * W + r];
        float left = __shfl_up_sync(kFull, v[R - 1], 1);  // v[y - 1][x - 1] of column r
        if (lane == 0) left = y == 0 ? 0.f : kNegInf;
        uint32_t mine = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int d = y - xo[r];
          const float here = v[r];
          const bool feas = static_cast<unsigned>(d) < static_cast<unsigned>(lim);
          const uint32_t word = __ballot_sync(kFull, d == 0 || here < left);
          if (lane == r) mine = word;
          v[r] = feas ? cur[r] + fmaxf(here, left) : kNegInf;
          left = here;
        }
        if (lane < R) bits[y * R + lane] = mine;
      }
      if (g + kParts < n_groups) bar_arrive(kEmptyBar + part);
    }
  }
  __syncthreads();  // the fill is done and the bits are visible
  if (warp > 0) return;

  // The walk back, 32 rows at a time from row y0 at column i0: lane k reads
  // column i0 - k's bit in each of the 32 rows, one ballot per row j gives
  // mask[j] (bit k: move left at (y0 - j, i0 - k); the `y > 0 && i != 0`
  // guard folded in), then every lane walks the masks in registers and lane
  // j stores row y0 - j's one.
  int i0 = max(t_x - 1, 0);
  for (int y0 = t_y - 1; y0 >= 0; y0 -= 32) {
    const int c = i0 - lane;
    const uint32_t* col = bits + (c > 0 ? c % R : 0);
    const int sh = c > 0 ? c / R : 0;
    uint32_t mask[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int y = y0 - j;
      mask[j] = __ballot_sync(kFull, c > 0 && y > 0 && ((col[y * R] >> sh) & 1u));
    }
    int off = 0, mine = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (lane == j) mine = off;
      off += (mask[j] >> off) & 1u;
    }
    if (y0 - lane >= 0) pb[static_cast<size_t>(y0 - lane) * T_x + (i0 - mine)] = 1.f;
    i0 -= off;
  }
}

// Form "warp": the ring (D rows of T_x rounded up to 4 floats, and 32 R
// floats that the last row's padded columns read) and the T_y x R words.
int warp_smem(int T_y, int T_x, int R, int D) {
  return 4 * (D * ((T_x + 3) / 4 * 4) + 32 * R + T_y * R);
}

template <int R>
cudaError_t launch_warp(const float* neg, const int* t_ys, const int* t_xs, float* path, int B,
                        int T_y, int T_x, int D, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mas_warp_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mas_warp_kernel<R><<<B, kWarpThreads, smem, stream>>>(neg, t_ys, t_xs, path, T_y, T_x, D);
  return cudaGetLastError();
}

// Columns per lane the form is built for (ops/mas.py::WARP_RS): R is the
// first that covers T_x over 32 lanes, so T_x <= 32 * 31 = 992.
constexpr int kWarpRs[] = {1, 3, 5, 7, 9, 13, 17, 25, 31};
constexpr int kWarpMaxTx = 32 * 31;

int warp_r(int T_x) {
  for (int r : kWarpRs)
    if (32 * r >= T_x) return r;
  return 0;
}

cudaError_t launch_warp_r(const float* neg, const int* t_ys, const int* t_xs, float* path,
                          int B, int T_y, int T_x, int R, int D, int smem, cudaStream_t s) {
  switch (R) {
    case 1: return launch_warp<1>(neg, t_ys, t_xs, path, B, T_y, T_x, D, smem, s);
    case 3: return launch_warp<3>(neg, t_ys, t_xs, path, B, T_y, T_x, D, smem, s);
    case 5: return launch_warp<5>(neg, t_ys, t_xs, path, B, T_y, T_x, D, smem, s);
    case 7: return launch_warp<7>(neg, t_ys, t_xs, path, B, T_y, T_x, D, smem, s);
    case 9: return launch_warp<9>(neg, t_ys, t_xs, path, B, T_y, T_x, D, smem, s);
    case 13: return launch_warp<13>(neg, t_ys, t_xs, path, B, T_y, T_x, D, smem, s);
    case 17: return launch_warp<17>(neg, t_ys, t_xs, path, B, T_y, T_x, D, smem, s);
    case 25: return launch_warp<25>(neg, t_ys, t_xs, path, B, T_y, T_x, D, smem, s);
    case 31: return launch_warp<31>(neg, t_ys, t_xs, path, B, T_y, T_x, D, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// form "block"
// ---------------------------------------------------------------------------

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

cudaError_t launch_block(const float* neg, const int* t_ys, const int* t_xs, float* path,
                         uint32_t* scratch, int B, int T_y, int T_x, const Geometry& g,
                         cudaStream_t s) {
  switch (g.xpt) {
    case 1: return launch<1>(neg, t_ys, t_xs, path, scratch, B, T_y, T_x, g, s);
    case 2: return launch<2>(neg, t_ys, t_xs, path, scratch, B, T_y, T_x, g, s);
    case 4: return launch<4>(neg, t_ys, t_xs, path, scratch, B, T_y, T_x, g, s);
    case 8: return launch<8>(neg, t_ys, t_xs, path, scratch, B, T_y, T_x, g, s);
    case 16: return launch<16>(neg, t_ys, t_xs, path, scratch, B, T_y, T_x, g, s);
    default: return launch<32>(neg, t_ys, t_xs, path, scratch, B, T_y, T_x, g, s);
  }
}

}  // namespace

extern "C" {

// Launches the search on `stream` in the form the wrapper's plan chose, and
// returns the cudaError_t of the launch (0 on success). neg (B, T_y, T_x)
// f32, path (B, T_y, T_x) f32, t_ys/t_xs (B,) int32, all contiguous on the
// device. form 0 ("warp", T_x <= 992): R = warp_r(T_x) columns per lane, a
// ring of D rows (a multiple of 4), smem = warp_smem bytes. form
// 1 ("block"): R is the columns per thread and smem the shared memory of
// `geometry`; scratch holds B * (T_y * ceil(T_x / 32) + T_y) words where the
// bits do not fit in shared memory (else it may be null). Plan numbers that
// do not match the shape are refused. Lengths are clamped to [0, T_y] and
// [0, T_x].
int mas_forward(const float* neg, const int* t_ys, const int* t_xs, float* path,
                uint32_t* scratch, int B, int T_y, int T_x, int form, int R, int D, int smem,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T_y <= 0 || T_x <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (form == 0) {
    if (T_x > kWarpMaxTx || R != warp_r(T_x) || D < kParts || D % kParts ||
        smem != warp_smem(T_y, T_x, R, D) || smem > kSmemLimit)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_warp_r(neg, t_ys, t_xs, path, B, T_y, T_x, R, D, smem, s));
  }
  Geometry g;
  if (form != 1 || !geometry(T_y, T_x, &g) || g.xpt != R || g.smem != smem ||
      (g.scratch_words > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_block(neg, t_ys, t_xs, path, scratch, B, T_y, T_x, g, s));
}

// Message of a cudaError_t returned by mas_forward.
const char* mas_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
