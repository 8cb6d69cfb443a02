// Blockwise 8x8 DCT-II + quantization for Hopper (sm_90a): the encode hot
// loop of the closed-loop tile encoder.
//
// Replaces the Pallas TPU kernel `dct_quant` (src/repro/kernels/dct/dct.py).
// Same contract:
//   x   [N, 8, 8] f32    pixel blocks (keyframes) or residual blocks
//   out [N, 8, 8] int16  out[n] = round_half_even((D x[n] D^T) / M)
// with D the orthonormal DCT-II basis and M the quant matrix of (qp, intra).
//
// Bound: memory.  A block reads 256 B (f32 in) and writes 128 B (int16 out)
// for about 2 kFLOP (per coefficient two 8-point products of 8 multiplies
// and 7 adds, plus the divide), ~5.2 FLOP/B against the card's ~20 fp32
// FLOP/B balance point, so the floor is N*384 B over HBM bandwidth.  The
// separately rounded multiplies and adds and the IEEE divide still take
// most of that floor in fp32 issue slots, so the loads of one round must
// overlap the arithmetic of another.
//
// Design: warp-level, as decode_gop_blocks.cu.  A group of 8 lanes owns one
// 8x8 block and lane i of the group owns row i, so a warp owns 4
// neighbouring blocks (1 KiB of contiguous input) and nothing waits on
// another warp:
//   - a lane reads its f32 row as two 16-byte loads and, before it computes
//     a round, issues the loads of its row of the next round (the grid is
//     capped at the thread blocks the card holds at once, and loops);
//   - the first product mixes rows (t[i][l] = sum_j D[i][j] x[j][l]): each
//     lane writes its row to a warp-private shared tile, one __syncwarp,
//     and every lane reads the whole block back as 16 float4 broadcasts (the
//     block tiles are padded by 16 bytes, so a warp's 4 blocks read 4
//     distinct bank groups; a __syncwarp before the write keeps the previous
//     round's reads ahead of it);
//   - the second product (c[i][l] = sum_k t[i][k] D[l][k]) stays in the
//     lane's registers, with D[l][k] read from the kernel's parameter bank;
//   - the lane writes its 8 int16 as one 16-byte store.
// Lanes of a group past N neither load nor store; offsets are 64-bit.
//
// Arithmetic is pinned so the kernel equals its plain PyTorch version
// (ref.py) bit for bit: every product and sum is a separately rounded
// __fmul_rn / __fadd_rn (nvcc would otherwise contract them into FMAs),
// summed over j, then k, in ascending order starting from the first product;
// the quotient is an IEEE division (__fdiv_rn, never a multiplication by a
// reciprocal); rounding is rintf (half to even, like np.round / jnp.round,
// unlike roundf), clamped to the int16 range.  A lane's arithmetic depends
// only on its own block, so a block quantizes identically in any batch and
// in any round of any warp.
//
// D and M (512 B) travel by value as a kernel parameter, not through a
// __constant__ symbol set by a copy: encodes of different qp run
// concurrently from the tuner thread and the ingest caller, and a kernel
// argument is private to its launch.  Each lane picks its row of D and of M
// into registers with an unrolled selection, and every other read of the
// tables has a compile-time index, so they stay in the parameter bank.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                          // per thread block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerWarp = 4;                  // 8 lanes per 8x8 block
constexpr int kBlocks = kWarps * kBlocksPerWarp;   // per thread block, round
constexpr int kTileStride = 64 + 4;                // floats per block tile

struct Tables {
  float d[64];  // DCT-II basis, row-major D[k][i]
  float m[64];  // quant matrix
};

__device__ __forceinline__ void load_row(const float* p, float4& lo,
                                         float4& hi) {
  lo = __ldg(reinterpret_cast<const float4*>(p));
  hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
}

__global__ void __launch_bounds__(kThreads)
dct_quant_kernel(const float* __restrict__ x, int16_t* __restrict__ out,
                 const Tables tables, long long n) {
  // per warp: the tiles of its 4 blocks
  __shared__ __align__(16) float s_x[kWarps][kBlocksPerWarp][kTileStride];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 3;  // block within the warp
  const int i = lane & 7;     // this lane's row of the 8x8 block

  // this lane's rows of D and of the quant matrix
  float d_row[8], m_row[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (i == r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        d_row[j] = tables.d[r * 8 + j];
        m_row[j] = tables.m[r * 8 + j];
      }
    }
  }

  float* tile = &s_x[warp][grp][0];
  const long long stride = (long long)gridDim.x * kBlocks;  // per round
  // first block of this warp's round, the same for all its lanes
  long long base = ((long long)blockIdx.x * kWarps + warp) * kBlocksPerWarp;
  float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
  if (base + grp < n) load_row(x + (base + grp) * 64 + i * 8, lo, hi);
  for (; base < n; base += stride) {
    const long long blk = base + grp;
    const float xr[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    if (blk + stride < n) load_row(x + (blk + stride) * 64 + i * 8, lo, hi);

    __syncwarp();
    reinterpret_cast<float4*>(tile + i * 8)[0] =
        make_float4(xr[0], xr[1], xr[2], xr[3]);
    reinterpret_cast<float4*>(tile + i * 8)[1] =
        make_float4(xr[4], xr[5], xr[6], xr[7]);
    __syncwarp();

    // t[i][l] = sum_j D[i][j] * x[j][l], j ascending from the first product
    float t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 a = reinterpret_cast<const float4*>(tile + j * 8)[0];
      const float4 b = reinterpret_cast<const float4*>(tile + j * 8)[1];
      const float xj[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const float p = __fmul_rn(d_row[j], xj[l]);
        t[l] = j == 0 ? p : __fadd_rn(t[l], p);
      }
    }
    // c[i][l] = sum_k t[i][k] * D[l][k], k ascending; quantize, pack
    unsigned w[4];
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      float c = __fmul_rn(t[0], tables.d[l * 8]);
#pragma unroll
      for (int k = 1; k < 8; ++k)
        c = __fadd_rn(c, __fmul_rn(t[k], tables.d[l * 8 + k]));
      const float r = fminf(fmaxf(rintf(__fdiv_rn(c, m_row[l])), -32768.0f),
                            32767.0f);
      const unsigned v = (unsigned)(int)r & 0xffffu;
      if (l & 1) {
        w[l >> 1] |= v << 16;
      } else {
        w[l >> 1] = v;
      }
    }
    if (blk < n)
      *reinterpret_cast<uint4*>(out + blk * 64 + i * 8) =
          make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Thread blocks of dct_quant_kernel the current device keeps resident at
// once, or 0 if the runtime cannot say (then the grid is not capped).
int resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dct_quant_kernel,
                                                    kThreads, 0) !=
          cudaSuccess) {
    cudaGetLastError();  // the query's error is not the launch's
    return 0;
  }
  return sms * per_sm;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises.
// `tables` is a host pointer to 128 floats: D, then the quant matrix.  `x`
// and `out` are contiguous and 16-byte aligned (the wrapper checks).
extern "C" int dct_quant(const void* x, void* out, const void* tables,
                         long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  Tables t;
  const float* src = static_cast<const float*>(tables);
  for (int k = 0; k < 64; ++k) {
    t.d[k] = src[k];
    t.m[k] = src[64 + k];
  }
  // any grid covers all N: the cap, taken once on the first launch's
  // device, only keeps the grid to one resident wave whose warps loop over
  // rounds with the next round's loads in flight (one round of 4 blocks a
  // warp, the grid covering N, was slower)
  static const int cap = resident_blocks();
  long long grid = (n + kBlocks - 1) / kBlocks;
  if (cap > 0 && grid > cap) grid = cap;
  dct_quant_kernel<<<(unsigned int)grid, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int16_t*>(out), t, n);
  return (int)cudaGetLastError();
}
