// Exhaustive block motion search by sum of absolute differences (SAD) for
// Hopper (sm_90a): the encoder-side motion estimation hot spot.
//
// Replaces the Pallas TPU kernel `sad_search` (src/repro/kernels/sad/sad.py:41).
// Same contract:
//   cur [N, B, B] f32, win [N, B+2R, B+2R] f32
//   dy, dx [N] int32 in [0, 2R], sad [N] f32: the candidate (dy, dx) whose
//   SAD sum |cur - win[dy:dy+B, dx:dx+B]| is least, the first one in
//   row-major (dy, dx) order on a tie (the TPU kernel's strict `<`).  A
//   candidate whose SAD is NaN (or +inf) is never taken; if none is taken
//   the result is (0, 0, +inf).
// Each candidate sums a row of |cur - cand| in x order, then the rows in y
// order, every subtract and add rounded separately, so the outputs are the
// same bits as the first version of this kernel on any f32 input.
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
// What bounds it on this card: fp32 issue.  The first version gave one
// thread to each candidate and paid two shared loads per pair beside its
// two adds; an SM issues one warp-wide shared load per clock against four
// warp-wide fp32 adds, so it stopped at 16-17 % of the operation bound
// (0.223 / 0.093 ms at the two shapes above on an NVIDIA H100 80GB HBM3 at
// 700 W).  At 1080p the bytes come close behind the adds, so the loads must
// stay in flight while the adds run.  This design:
//   - moves the pairs into registers.  A work item is (current block, dy,
//     strip), a strip K consecutive dx.  Per block row y a thread loads the
//     current row (a broadcast within a block) and the window segment of
//     row dy+y, B+K-1 floats, with 16-byte shared loads, then runs the K*B
//     pairs from registers in fully unrolled loops (every register index a
//     compile-time constant; a row starts from its first term, since 0 +
//     |d| is |d| for every d).  At R = 8 one strip holds all 17 dx: 8
//     shared loads for 136 pairs at B = 8, where the first version made
//     272.  Two strips of 9 (at dx 0 and 8) left more time to the per-group
//     work below and were slower at B = 8 (PERF.md section 6);
//   - keeps the lanes busy: the items of 15 current blocks share one
//     256-thread block (255 lanes at R = 8);
//   - keeps the loads in flight: the grid is capped at the thread blocks the
//     card holds at once and loops over groups of current blocks; the next
//     group's blocks and windows arrive by bulk copies (TMA: cp.async.bulk,
//     one instruction for the blocks and one for the windows at B = 8, one
//     a window row at B = 16) on an mbarrier into a second shared buffer
//     while the current group adds, with one block barrier a group.  16-byte
//     cp.async issued by every thread was slower: the warps stalled issuing
//     it.  The 128-byte window rows of B = 16 are padded to 36 floats, so
//     the 8 lanes of a 16-byte load phase (consecutive dy) hit 8 distinct
//     bank groups; the 96-byte rows of B = 8 stay unpadded (2-way
//     conflicts, but the windows of a group move as one copy);
//   - reduces the argmin of a current block as one 64-bit key (sad bits,
//     candidate index): a SAD is never negative, so its bits order as the
//     floats do, and NaN and +inf never enter.  The lanes of one block
//     within a warp reduce it with shuffles, and one shared-memory atomicMin
//     per block and warp merges the warps: the smaller SAD wins, then the
//     smaller index, the first version's rule.  The keys are double
//     buffered and written out after the next group's barrier.
// B = 8 and 16 at R = 8 (the motion path's two shapes) with 16-byte aligned
// inputs take instantiations with B and R fixed at compile time.  Every
// other shape, and a contiguous view at an offset that breaks 16-byte
// alignment, takes the generic instantiation of the same design: the block
// side at run time, strips of 9 dx, a row in chunks of kChunk pixels,
// 4-byte cp.async (a warp a window row), rows at an odd stride, scalar
// shared loads.  Its results are the same bits.
// Registers, times and shares of the bound are in PERF.md section 6
// (chip_smoke.py, scripts/torch_kernel_probe.py).
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// candidates (consecutive dx) per work item: every dx of R = 8 on the
// fixed-shape path, 9 on the generic path
constexpr int kStripFixed = 17;
constexpr int kStripAny = 9;
constexpr int kChunk = 4;      // pixels of a row per step, generic path
constexpr int kThreads = 256;  // per thread block
// the block and its window within the 48 KB (less 256 B) the first version
// staged: the accepted shapes do not change
constexpr long long kMaxTileBytes = 48 * 1024 - 256;
// dynamic shared memory of the two staging buffers (the keys are static)
constexpr long long kMaxSmemBytes = 200 * 1024;
constexpr unsigned long long kNone = ~0ULL;  // no candidate taken

struct Params {
  const float* cur;
  const float* win;
  int* out_dy;
  int* out_dx;
  float* out_sad;
  long long n;         // current blocks
  long long n_groups;  // groups of `group` consecutive blocks
  int group;           // current blocks per group
  int b, r2, w, wp;    // block side, candidates per axis, window side, stride
  int items;           // work items per current block: r2 * strips
  int cur_floats;      // floats of a group's blocks in a staging buffer
  int buf_floats;      // floats of one staging buffer
};

template <int B>
__host__ __device__ constexpr int strip_width() {
  return B > 0 ? kStripFixed : kStripAny;
}

// window row stride in shared memory (see the note above)
__host__ __device__ constexpr int padded_stride(int w) {
  return w % 32 == 0 ? w + 4 : w;
}

// first dx of strip s of width k: the last strip ends at dx 2R
__host__ __device__ __forceinline__ int strip_start(int s, int r2, int k) {
  return r2 <= k ? 0 : (s * k < r2 - k ? s * k : r2 - k);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- the fixed-shape path: bulk copies (TMA) completing on an mbarrier
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the one arrival of a phase, which also expects `bytes` of copies
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- the generic path: 4-byte cp.async
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bytes of group `grp`'s blocks and windows (the last group may be short).
template <int B, int R>
__device__ __forceinline__ unsigned group_bytes(const Params& p,
                                                long long grp) {
  constexpr int kW = B + 2 * R;
  const long long nb = min((long long)p.group, p.n - grp * p.group);
  return (unsigned)(nb * (B * B + kW * kW) * sizeof(float));
}

// Copy group `grp`'s blocks and windows into `buf`: the blocks contiguous,
// then the windows' rows at stride wp.  B > 0: bulk copies that complete
// on `bar` (which expects group_bytes): one for the blocks and, where the
// rows are not padded, one for the windows, else one a window row.  The
// buffer's last reads ended before the block barrier that precedes this.
// B == 0: 4-byte cp.async, one commit group.
template <int B, int R>
__device__ void stage(const Params& p, long long grp, float* buf,
                      unsigned long long* bar) {
  const long long first = grp * p.group;
  const long long nb = min((long long)p.group, p.n - first);
  float* s_win = buf + p.cur_floats;
  if constexpr (B > 0) {
    constexpr int kW = B + 2 * R;
    constexpr int kWp = padded_stride(kW);
    if (threadIdx.x == blockDim.x - 1)
      bulk_copy(buf, p.cur + first * B * B,
                (unsigned)(nb * B * B * sizeof(float)), bar);
    const float* g_win = p.win + first * kW * kW;
    if constexpr (kWp == kW) {
      if (threadIdx.x == 0)
        bulk_copy(s_win, g_win, (unsigned)(nb * kW * kW * sizeof(float)),
                  bar);
    } else {
      for (int row = threadIdx.x; row < nb * kW; row += blockDim.x)
        bulk_copy(s_win + row * kWp, g_win + row * kW,
                  kW * sizeof(float), bar);
    }
  } else {
    const long long bb = (long long)p.b * p.b;
    const long long ww = (long long)p.w * p.w;
    const float* g_cur = p.cur + first * bb;
    const int n_cur = (int)(nb * bb);
    for (int i = threadIdx.x; i < n_cur; i += blockDim.x)
      cp_async4(buf + i, g_cur + i);
    // a warp a window row, so the loads coalesce and the rows take an odd
    // stride in shared memory
    const float* g_win = p.win + first * ww;
    const int n_rows = (int)nb * p.w;
    const int lane = threadIdx.x & 31;
    for (int row = threadIdx.x >> 5; row < n_rows; row += blockDim.x >> 5)
      for (int x = lane; x < p.w; x += 32)
        cp_async4(s_win + row * p.wp + x, g_win + (long long)row * p.w + x);
    cp_async_commit();
  }
}

// The first least SAD among this item's candidates (they ascend in dx, so
// the strict < keeps the first), merged into `key`.
template <int K>
__device__ __forceinline__ void take_first_min(const float (&tot)[K], int dy,
                                               int dx0, int r2,
                                               unsigned long long& key) {
  float best = INFINITY;
  int bk = -1;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (dx0 + k < r2 && tot[k] < best) {
      best = tot[k];
      bk = k;
    }
  }
  if (bk >= 0) {
    const unsigned long long cand =
        ((unsigned long long)__float_as_uint(best) << 32) |
        (unsigned)(dy * r2 + dx0 + bk);
    key = cand < key ? cand : key;
  }
}

// One work item with B and R known: the window segment of each row lives in
// registers, every register index is a compile-time constant.
template <int B, int R>
__device__ __forceinline__ void search_item(const float* cb, const float* wb,
                                            int dy, int dx0,
                                            unsigned long long& key) {
  constexpr int K = kStripFixed;
  constexpr int kWp = padded_stride(B + 2 * R);
  constexpr int kSeg = B + K - 1;
  static_assert(B % 4 == 0 && kSeg % 4 == 0 && (B + 2 * R) % 4 == 0,
                "16-byte shared loads");
  float tot[K];
#pragma unroll
  for (int k = 0; k < K; ++k) tot[k] = 0.0f;
  const float* wr = wb + dy * kWp + dx0;
#pragma unroll 1
  for (int y = 0; y < B; ++y) {
    float c[B], seg[kSeg];
#pragma unroll
    for (int q = 0; q < B / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(cb + y * B)[q];
      c[4 * q] = v.x;
      c[4 * q + 1] = v.y;
      c[4 * q + 2] = v.z;
      c[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < kSeg / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(wr + y * kWp)[q];
      seg[4 * q] = v.x;
      seg[4 * q + 1] = v.y;
      seg[4 * q + 2] = v.z;
      seg[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // 0 + |d| is |d| for every d (|d| is never -0), so a row starts from
      // its first term: the same bits as a sum from 0.0f
      float row = fabsf(__fsub_rn(c[0], seg[k]));
#pragma unroll
      for (int x = 1; x < B; ++x)
        row = __fadd_rn(row, fabsf(__fsub_rn(c[x], seg[k + x])));
      tot[k] = __fadd_rn(tot[k], row);
    }
  }
  take_first_min(tot, dy, dx0, 2 * R + 1, key);
}

// kChunk pixels of one row for every candidate of a generic item, x in
// order; a tail chunk adds only its pixels < b.
template <bool kTail>
__device__ __forceinline__ void add_chunk(const float* cr, const float* wr,
                                          int x0, int b,
                                          float (&row)[kStripAny]) {
  constexpr int K = kStripAny;
  float c[kChunk], seg[kChunk + K - 1];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) c[j] = cr[x0 + j];
#pragma unroll
  for (int j = 0; j < kChunk + K - 1; ++j) seg[j] = wr[x0 + j];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (!kTail || x0 + j < b) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        row[k] = __fadd_rn(row[k], fabsf(__fsub_rn(c[j], seg[k + j])));
    }
  }
}

// One work item of any shape: a row in chunks of kChunk pixels, x still in
// order for every candidate.  Reads past a row's end (the tail chunk, a
// masked strip) land in the row padding or the buffer's slack and are never
// added.
__device__ __forceinline__ void search_item_any(const float* cb,
                                                const float* wb, int b,
                                                int wp, int r2, int dy,
                                                int dx0,
                                                unsigned long long& key) {
  constexpr int K = kStripAny;
  float tot[K];
#pragma unroll
  for (int k = 0; k < K; ++k) tot[k] = 0.0f;
#pragma unroll 1
  for (int y = 0; y < b; ++y) {
    const float* cr = cb + y * b;
    const float* wr = wb + (dy + y) * wp + dx0;
    float row[K];
#pragma unroll
    for (int k = 0; k < K; ++k) row[k] = 0.0f;
    int x0 = 0;
#pragma unroll 1
    for (; x0 + kChunk <= b; x0 += kChunk) add_chunk<false>(cr, wr, x0, b, row);
    if (x0 < b) add_chunk<true>(cr, wr, x0, b, row);
#pragma unroll
    for (int k = 0; k < K; ++k) tot[k] = __fadd_rn(tot[k], row[k]);
  }
  take_first_min(tot, dy, dx0, r2, key);
}

// Least key over the lanes of one current block within this warp (the lanes
// of a block are consecutive), then one shared atomicMin per block and warp.
__device__ __forceinline__ void merge_key(unsigned long long key, int gl,
                                         int group,
                                         unsigned long long* keys) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long ok = __shfl_down_sync(0xffffffffu, key, off);
    const int og = __shfl_down_sync(0xffffffffu, gl, off);
    if (lane + off < 32 && og == gl && ok < key) key = ok;
  }
  const int pg = __shfl_up_sync(0xffffffffu, gl, 1);
  if ((lane == 0 || pg != gl) && gl < group && key != kNone)
    atomicMin(&keys[gl], key);
}

__device__ __forceinline__ void write_out(const Params& p, long long grp,
                                          unsigned long long* keys) {
  const int t = threadIdx.x;
  const long long n = grp * p.group + t;
  if (t >= p.group || n >= p.n) return;
  const unsigned long long key = keys[t];
  keys[t] = kNone;
  if (key == kNone) {  // every SAD NaN or +inf, as the TPU kernel's < does
    p.out_dy[n] = 0;
    p.out_dx[n] = 0;
    p.out_sad[n] = INFINITY;
    return;
  }
  const int idx = (int)(key & 0xffffffffu);
  p.out_dy[n] = idx / p.r2;
  p.out_dx[n] = idx % p.r2;
  p.out_sad[n] = __uint_as_float((unsigned)(key >> 32));
}

// B > 0: block side B and radius R fixed, 16-byte staging and shared loads;
// B == 0: any shape, given at run time.
template <int B, int R>
__global__ void __launch_bounds__(kThreads)
sad_search_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned long long s_key[2][kThreads];
  __shared__ unsigned long long s_bar[2];  // fixed-shape path: one a buffer

  const int t = threadIdx.x;
  const int b = B > 0 ? B : p.b;
  const int r2 = B > 0 ? 2 * R + 1 : p.r2;
  // this thread's current block within a group, and its items
  int gl, it0, step;
  if (p.items <= (int)blockDim.x) {
    gl = t / p.items;
    it0 = t - gl * p.items;
    step = p.items;
  } else {
    gl = 0;
    it0 = t;
    step = blockDim.x;
  }
  if (t < p.group) s_key[0][t] = s_key[1][t] = kNone;

  long long grp = blockIdx.x;
  if constexpr (B > 0) {
    if (t == 0) {
      mbar_init(&s_bar[0]);
      mbar_init(&s_bar[1]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect(&s_bar[0], group_bytes<B, R>(p, grp));
    }
    __syncthreads();  // the barriers exist and expect the first group
  }
  stage<B, R>(p, grp, smem, &s_bar[0]);
  int i = 0;
  for (; grp < p.n_groups; grp += gridDim.x, ++i) {
    const long long next = grp + gridDim.x;
    if constexpr (B > 0) {
      mbar_wait(&s_bar[i & 1], (i >> 1) & 1);
      // the next group's one arrival, ahead of its copies
      if (t == 0 && next < p.n_groups)
        mbar_expect(&s_bar[(i + 1) & 1], group_bytes<B, R>(p, next));
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // group grp staged; group grp - grid done with
    if (next < p.n_groups)
      stage<B, R>(p, next, smem + ((i + 1) & 1) * p.buf_floats,
                  &s_bar[(i + 1) & 1]);
    if (i > 0) write_out(p, grp - gridDim.x, s_key[(i - 1) & 1]);

    const float* buf = smem + (i & 1) * p.buf_floats;
    unsigned long long key = kNone;
    if (gl < p.group && grp * p.group + gl < p.n) {
      const float* cb = buf + gl * b * b;
      const float* wb = buf + p.cur_floats + gl * p.w * p.wp;
      for (int it = it0; it < p.items; it += step) {
        const int s = it / r2;
        const int dy = it - s * r2;
        const int dx0 = strip_start(s, r2, strip_width<B>());
        if constexpr (B > 0) {
          search_item<B, R>(cb, wb, dy, dx0, key);
        } else {
          search_item_any(cb, wb, b, p.wp, r2, dy, dx0, key);
        }
      }
    }
    merge_key(key, gl, p.group, s_key[i & 1]);
  }
  __syncthreads();
  if (i > 0) write_out(p, grp - gridDim.x, s_key[(i - 1) & 1]);
}

template <int B, int R>
int launch(Params p, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = sad_search_kernel<B, R>;
  // the static keys and the dynamic buffers together may pass 48 KB
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // any grid covers every group: the cap keeps it to the thread blocks the
  // card holds at once, whose loop keeps the next group's loads in flight
  long long grid = p.n_groups;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
          cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) == cudaSuccess &&
      per_sm > 0) {
    if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
  } else {
    cudaGetLastError();  // the query's error is not the launch's
  }
  kernel<<<(unsigned int)grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises.
// cur [n, b, b] and win [n, b+2r, b+2r] f32, contiguous; dy, dx [n] int32,
// sad [n] f32.  Inputs that are not 16-byte aligned take the generic path.
extern "C" int sad_search(const void* cur, const void* win, void* dy,
                          void* dx, void* sad, long long n, int b, int r,
                          void* stream) {
  if (n < 1 || n > INT_MAX || b < 1 || r < 0 || b > 4096 || r > 4096)
    return (int)cudaErrorInvalidValue;
  const long long w = b + 2LL * r;
  if (((long long)b * b + w * w) * (long long)sizeof(float) > kMaxTileBytes)
    return (int)cudaErrorInvalidValue;
  const int r2 = 2 * r + 1;
  const bool fast =
      (b == 8 || b == 16) && r == 8 && aligned16(cur) && aligned16(win);
  const int k = fast ? kStripFixed : kStripAny;
  const int strips = (r2 + k - 1) / k;

  Params p;
  p.cur = static_cast<const float*>(cur);
  p.win = static_cast<const float*>(win);
  p.out_dy = static_cast<int*>(dy);
  p.out_dx = static_cast<int*>(dx);
  p.out_sad = static_cast<float*>(sad);
  p.n = n;
  p.b = b;
  p.r2 = r2;
  p.w = (int)w;
  // generic rows at an odd stride: the lanes of a block read consecutive
  // dy, so their scalar loads fall in distinct banks
  p.wp = fast ? padded_stride((int)w) : (int)w | 1;
  p.items = r2 * strips;
  // the generic path reads up to a chunk and a strip past a window's rows
  const long long slack = fast ? 0 : (kChunk + kStripAny + 3) / 4 * 4;
  const long long per_block = (long long)b * b + w * p.wp;
  long long group = p.items >= kThreads ? 1 : kThreads / p.items;
  if (group > n) group = n;
  while (group > 1 &&
         2 * (group * per_block + slack) * (long long)sizeof(float) >
             kMaxSmemBytes)
    --group;
  p.group = (int)group;
  p.n_groups = (n + group - 1) / group;
  p.cur_floats = (int)(group * b * b);
  p.buf_floats = (int)((group * per_block + slack + 3) / 4 * 4);
  const int threads =
      p.items >= kThreads ? kThreads : (p.group * p.items + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)p.buf_floats * sizeof(float);

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast) {
    return b == 8 ? launch<8, 8>(p, threads, smem, st)
                  : launch<16, 8>(p, threads, smem, st);
  }
  return launch<0, 0>(p, threads, smem, st);
}
