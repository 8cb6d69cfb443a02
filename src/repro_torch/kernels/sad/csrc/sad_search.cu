// Exhaustive block motion search by sum of absolute differences (SAD) for
// Hopper (sm_90a): the encoder-side motion estimation hot spot.
//
// Replaces the Pallas TPU kernel `sad_search` (src/repro/kernels/sad/sad.py:41).
// Same contract:
//   cur [N, B, B] f32, win [N, B+2R, B+2R] f32
//   dy, dx [N] int32 in [0, 2R], sad [N] f32: the candidate (dy, dx) whose
//   SAD sum |cur - win[dy:dy+B, dx:dx+B]| is least, the first one in
//   row-major (dy, dx) order on a tie (the TPU kernel's strict `<`, and
//   `argmin` in the plain versions).
//
// Bound: operations.  Each of the N (2R+1)^2 B^2 (pixel, candidate) pairs is
// a subtract and an add of the absolute value (|x| is a free operand
// modifier of the fp32 add): 2 fp32 adds.  The card issues fp32 adds at half
// its 67 TFLOP/s peak (which counts an FMA as two), 33.5 T adds/s.  The
// bytes are N * 4 (B^2 + (B+2R)^2) in and 12 N out.  At the 1080p motion
// shape (N = 32,400, B = 8, R = 8): 0.60 G pairs, 1.20 G adds, 35.8 us,
// against 83.3 MB, 24.9 us at 3.35 TB/s; at 720p (N = 3,600, B = 16,
// R = 8): 0.27 G pairs, 15.9 us, against 18.5 MB, 5.5 us.
//
// Design (simple first).  The TPU kernel takes 64 blocks per grid step,
// unrolls all (2R+1)^2 candidates statically and keeps the running argmin
// in VMEM vectors.  Here one thread block owns one current block:
//   - the B x B block and its (B+2R)^2 window are staged in shared memory
//     with coalesced loads (at B = 16, R = 8: 1 KB + 4 KB);
//   - one thread per candidate (289 at R = 8, rounded up to whole warps;
//     idle threads carry +inf), looping over candidates for a large R;
//     neighbouring threads take neighbouring dx, so window reads spread
//     over the banks and block reads are broadcasts;
//   - each thread sums each row of |cur - cand| in x order, then the rows
//     in y order, in separately rounded fp32 adds (exact for integer pixels
//     in any order; for float input the error grows with 2B, not B^2);
//   - a block-level argmin on (sad, candidate index): warp shuffles, then
//     shared memory; the smaller index wins a tie.
// Every pair costs two shared-memory loads beside its two adds, and an SM
// issues one shared load per clock against four fp32 adds, so this version
// is bound by shared-memory issue: on an NVIDIA H100 80GB HBM3 at 700 W it
// reaches 16-17 % of the operation bound at both shapes above
// (chip_smoke.py; PERF.md).  Keeping a window row in registers across
// several dx per thread would lift that; that is later work.
#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kScratchBytes = 32 * (sizeof(float) + sizeof(int));
// the two tiles share the 48 KB a block may take without an opt-in with the
// argmin scratch
constexpr long long kMaxTileBytes = 48 * 1024 - kScratchBytes;

__device__ __forceinline__ void take_better(float& s, int& i, float os,
                                            int oi) {
  if (os < s || (os == s && oi < i)) {
    s = os;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmin(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, s, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    take_better(s, i, os, oi);
  }
}

// BT > 0: the block side is known at compile time and a row's pixel loop
// unrolls; BT == 0: any block side, given at run time.  The row loop stays
// rolled: unrolled, the 8x8 body's registers hold an SM to two 320-thread
// blocks, too few to hide each block's staging loads (3x slower at the
// 1080p shape), and the 16x16 body's exceed what a 512-thread block may
// give a thread.
template <int BT>
__global__ void __launch_bounds__(kMaxThreads)
sad_search_kernel(const float* __restrict__ cur,
                  const float* __restrict__ win, int* __restrict__ out_dy,
                  int* __restrict__ out_dx, float* __restrict__ out_sad,
                  int b_rt, int r2) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float w_sad[32];
  __shared__ int w_idx[32];

  const int b = BT > 0 ? BT : b_rt;
  const int w = b + r2 - 1;
  const int bb = b * b;
  const int ww = w * w;
  float* s_cur = smem;
  float* s_win = smem + bb;
  const long long n = blockIdx.x;
  const float* g_cur = cur + n * bb;
  const float* g_win = win + n * ww;
  for (int i = threadIdx.x; i < bb; i += blockDim.x) s_cur[i] = g_cur[i];
  for (int i = threadIdx.x; i < ww; i += blockDim.x) s_win[i] = g_win[i];
  __syncthreads();

  float best = INFINITY;
  int best_idx = INT_MAX;
  const int n_cand = r2 * r2;
  // a thread's candidates ascend, so the strict < keeps its first minimum
  for (int c = threadIdx.x; c < n_cand; c += blockDim.x) {
    const int dy = c / r2;
    const int dx = c - dy * r2;
    const float* cand = s_win + dy * w + dx;
    float s = 0.0f;
#pragma unroll 1
    for (int y = 0; y < b; ++y) {
      float row = 0.0f;
#pragma unroll
      for (int x = 0; x < b; ++x)
        row = __fadd_rn(row, fabsf(__fsub_rn(s_cur[y * b + x],
                                             cand[y * w + x])));
      s = __fadd_rn(s, row);
    }
    if (s < best) {
      best = s;
      best_idx = c;
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmin(best, best_idx);
  if (lane == 0) {
    w_sad[warp] = best;
    w_idx[warp] = best_idx;
  }
  __syncthreads();
  if (warp != 0) return;
  const int n_warps = blockDim.x >> 5;
  best = lane < n_warps ? w_sad[lane] : INFINITY;
  best_idx = lane < n_warps ? w_idx[lane] : INT_MAX;
  warp_argmin(best, best_idx);
  if (lane == 0) {
    // no candidate taken (every SAD NaN): (0, 0), as the TPU kernel's < does
    if (best_idx == INT_MAX) best_idx = 0;
    out_dy[n] = best_idx / r2;
    out_dx[n] = best_idx % r2;
    out_sad[n] = best;
  }
}

template <int BT>
void launch(const float* cur, const float* win, int* dy, int* dx, float* sad,
            long long n, int b, int r2, int threads, size_t smem,
            cudaStream_t stream) {
  sad_search_kernel<BT><<<(unsigned int)n, threads, smem, stream>>>(
      cur, win, dy, dx, sad, b, r2);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises.
// cur [n, b, b] and win [n, b+2r, b+2r] f32, contiguous; dy, dx [n] int32,
// sad [n] f32.
extern "C" int sad_search(const void* cur, const void* win, void* dy,
                          void* dx, void* sad, long long n, int b, int r,
                          void* stream) {
  if (n < 1 || n > INT_MAX || b < 1 || r < 0 || b > 4096 || r > 4096)
    return (int)cudaErrorInvalidValue;
  const long long w = b + 2LL * r;
  const long long tile_bytes = ((long long)b * b + w * w) * sizeof(float);
  if (tile_bytes > kMaxTileBytes) return (int)cudaErrorInvalidValue;
  const int r2 = 2 * r + 1;
  const long long n_cand = (long long)r2 * r2;
  const int threads = (int)(n_cand >= kMaxThreads
                                ? kMaxThreads
                                : (n_cand + 31) / 32 * 32);
  const size_t smem = (size_t)tile_bytes;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cur);
  const float* wn = static_cast<const float*>(win);
  int* pdy = static_cast<int*>(dy);
  int* pdx = static_cast<int*>(dx);
  float* ps = static_cast<float*>(sad);
  switch (b) {
    case 4:
      launch<4>(c, wn, pdy, pdx, ps, n, b, r2, threads, smem, st);
      break;
    case 8:
      launch<8>(c, wn, pdy, pdx, ps, n, b, r2, threads, smem, st);
      break;
    case 16:
      launch<16>(c, wn, pdy, pdx, ps, n, b, r2, threads, smem, st);
      break;
    default:
      launch<0>(c, wn, pdy, pdx, ps, n, b, r2, threads, smem, st);
  }
  return (int)cudaGetLastError();
}
