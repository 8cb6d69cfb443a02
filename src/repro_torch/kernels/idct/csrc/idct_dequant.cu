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
// Design (simple first), as dct_quant.cu: 256 threads own 4 blocks, one
// thread per pixel (i, l); the dequantized block goes through shared memory
// for the two separable 8-point products t = D^T c and x = t D.
//
// Arithmetic is pinned so the kernel equals its plain PyTorch version
// (ref.py) bit for bit: separately rounded __fmul_rn / __fadd_rn (no FMA
// contraction), sums over j, then k, ascending from the first product.  A
// thread's arithmetic depends only on its own block, so a block
// reconstructs identically in any batch.  D and M travel by value as a
// kernel parameter (see dct_quant.cu for why not __constant__).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlocks = 4;               // 8x8 blocks per thread block
constexpr int kThreads = kBlocks * 64;   // one thread per pixel

struct Tables {
  float d[64];  // DCT-II basis, row-major D[k][i]
  float m[64];  // quant matrix
};

__global__ void __launch_bounds__(kThreads)
idct_dequant_kernel(const int16_t* __restrict__ q, float* __restrict__ out,
                    const Tables tables, long long n) {
  __shared__ float s_d[64];
  __shared__ float s_c[kBlocks][64];
  __shared__ float s_t[kBlocks][64];

  const int tid = threadIdx.x;
  const int lb = tid >> 6;  // local block
  const int p = tid & 63;   // pixel (row-major)
  const int i = p >> 3;
  const int l = p & 7;
  const long long blk = (long long)blockIdx.x * kBlocks + lb;
  const bool valid = blk < n;
  const long long off = blk * 64 + p;

  if (tid < 64) s_d[tid] = tables.d[tid];
  s_c[lb][p] = valid ? __fmul_rn((float)q[off], tables.m[p]) : 0.0f;
  __syncthreads();
  // t[i][l] = sum_j D[j][i] * c[j][l], j ascending
  float t = __fmul_rn(s_d[i], s_c[lb][l]);
  for (int j = 1; j < 8; ++j)
    t = __fadd_rn(t, __fmul_rn(s_d[j * 8 + i], s_c[lb][j * 8 + l]));
  s_t[lb][p] = t;
  __syncthreads();
  // x[i][l] = sum_k t[i][k] * D[k][l], k ascending
  float x = __fmul_rn(s_t[lb][i * 8], s_d[l]);
  for (int k = 1; k < 8; ++k)
    x = __fadd_rn(x, __fmul_rn(s_t[lb][i * 8 + k], s_d[k * 8 + l]));
  if (valid) out[off] = x;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises.
// `tables` is a host pointer to 128 floats: D, then the quant matrix.
extern "C" int idct_dequant(const void* q, void* out, const void* tables,
                            long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  Tables t;
  const float* src = static_cast<const float*>(tables);
  for (int k = 0; k < 64; ++k) {
    t.d[k] = src[k];
    t.m[k] = src[64 + k];
  }
  const long long grid = (n + kBlocks - 1) / kBlocks;
  idct_dequant_kernel<<<(unsigned int)grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(q), static_cast<float*>(out), t, n);
  return (int)cudaGetLastError();
}
