// Blockwise dequantization + 8x8 IDCT for Hopper (sm_90a): the
// reconstruction step inside the closed-loop tile encoder.
//
// Replaces the Pallas TPU kernel `idct_dequant`
// (src/repro/kernels/idct/idct.py).  Same contract:
//   q   [N, 8, 8] int16  quantized coefficients
//   out [N, 8, 8] f32    out[n] = D^T (q[n] * M) D
// with D the orthonormal DCT-II basis and M the quant matrix of (qp, intra).
//
// Bound: memory.  A block reads 128 B (int16 in) and writes 256 B (f32 out)
// for about 2 kFLOP (per pixel the dequant multiply and two 8-point
// products of 8 multiplies and 7 adds), ~5.2 FLOP/B against the card's ~20
// fp32 FLOP/B balance point, so the floor is N*384 B over HBM bandwidth.
//
// Design: warp-level, as dct_quant.cu.  Lane i of a group of 8 lanes owns
// row i of one block, so a warp owns 4 neighbouring blocks (512 B of
// contiguous input):
//   - a lane reads its int16 row as one 16-byte load, the next round's
//     issued before the current one is computed (the grid is capped at the
//     thread blocks the card holds at once, and loops);
//   - it dequantizes its row (C[i][l] = (float)q * M[i][l]) and writes it to
//     a warp-private shared tile, one __syncwarp, and every lane reads the
//     whole block back as 16 float4 broadcasts for the product that mixes
//     rows (t[i][l] = sum_j D[j][i] C[j][l]); tiles are padded by 16 bytes
//     and a __syncwarp before the write keeps the previous round's reads
//     ahead of it;
//   - the second product (x[i][l] = sum_k t[i][k] D[k][l]) stays in the
//     lane's registers, with D[k][l] read from the kernel's parameter bank;
//   - the lane writes its f32 row as two float4 stores.
// Lanes of a group past N neither load nor store; offsets are 64-bit.
//
// Arithmetic is pinned so the kernel equals its plain PyTorch version
// (ref.py) bit for bit: the dequant is __fmul_rn((float)q, m), then
// separately rounded __fmul_rn / __fadd_rn (no FMA contraction), sums over
// j, then k, ascending from the first product.  A lane's arithmetic depends
// only on its own block, so a block reconstructs identically in any batch.
// D and M travel by value as a kernel parameter (see dct_quant.cu for why
// not __constant__); each lane picks its column of D and its row of M into
// registers, and every other table read has a compile-time index.
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

__device__ __forceinline__ uint4 load_row(const int16_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__global__ void __launch_bounds__(kThreads)
idct_dequant_kernel(const int16_t* __restrict__ q, float* __restrict__ out,
                    const Tables tables, long long n) {
  // per warp: the tiles of its 4 dequantized blocks
  __shared__ __align__(16) float s_c[kWarps][kBlocksPerWarp][kTileStride];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 3;  // block within the warp
  const int i = lane & 7;     // this lane's row of the 8x8 block

  // this lane's column of D and row of the quant matrix
  float d_col[8], m_row[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (i == r) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        d_col[j] = tables.d[j * 8 + r];
        m_row[j] = tables.m[r * 8 + j];
      }
    }
  }

  float* tile = &s_c[warp][grp][0];
  const long long stride = (long long)gridDim.x * kBlocks;  // per round
  // first block of this warp's round, the same for all its lanes
  long long base = ((long long)blockIdx.x * kWarps + warp) * kBlocksPerWarp;
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (base + grp < n) u = load_row(q + (base + grp) * 64 + i * 8);
  for (; base < n; base += stride) {
    const long long blk = base + grp;
    const unsigned wr[4] = {u.x, u.y, u.z, u.w};
    if (blk + stride < n) u = load_row(q + (blk + stride) * 64 + i * 8);

    // C[i][l] = (float)q * M[i][l], written to the warp's tile
    float c[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c[2 * e] = __fmul_rn((float)(int16_t)(wr[e] & 0xffffu), m_row[2 * e]);
      c[2 * e + 1] = __fmul_rn((float)(int16_t)(wr[e] >> 16),
                               m_row[2 * e + 1]);
    }
    __syncwarp();
    reinterpret_cast<float4*>(tile + i * 8)[0] =
        make_float4(c[0], c[1], c[2], c[3]);
    reinterpret_cast<float4*>(tile + i * 8)[1] =
        make_float4(c[4], c[5], c[6], c[7]);
    __syncwarp();

    // t[i][l] = sum_j D[j][i] * C[j][l], j ascending from the first product
    float t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 a = reinterpret_cast<const float4*>(tile + j * 8)[0];
      const float4 b = reinterpret_cast<const float4*>(tile + j * 8)[1];
      const float cj[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const float p = __fmul_rn(d_col[j], cj[l]);
        t[l] = j == 0 ? p : __fadd_rn(t[l], p);
      }
    }
    // x[i][l] = sum_k t[i][k] * D[k][l], k ascending
    float xr[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      float v = __fmul_rn(t[0], tables.d[l]);
#pragma unroll
      for (int k = 1; k < 8; ++k)
        v = __fadd_rn(v, __fmul_rn(t[k], tables.d[k * 8 + l]));
      xr[l] = v;
    }
    if (blk < n) {
      float4* o = reinterpret_cast<float4*>(out + blk * 64 + i * 8);
      o[0] = make_float4(xr[0], xr[1], xr[2], xr[3]);
      o[1] = make_float4(xr[4], xr[5], xr[6], xr[7]);
    }
  }
}

// Thread blocks of idct_dequant_kernel the current device keeps resident at
// once, or 0 if the runtime cannot say (then the grid is not capped).
int resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, idct_dequant_kernel, kThreads, 0) != cudaSuccess) {
    cudaGetLastError();  // the query's error is not the launch's
    return 0;
  }
  return sms * per_sm;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises.
// `tables` is a host pointer to 128 floats: D, then the quant matrix.  `q`
// and `out` are contiguous and 16-byte aligned (the wrapper checks).
extern "C" int idct_dequant(const void* q, void* out, const void* tables,
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
  idct_dequant_kernel<<<(unsigned int)grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(q), static_cast<float*>(out), t, n);
  return (int)cudaGetLastError();
}
