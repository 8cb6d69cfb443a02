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
// FLOP/B balance point, so the floor is N*384 B over HBM bandwidth.
//
// Design (simple first): a thread block of 256 threads owns 4 blocks; each
// thread owns one coefficient (i, l) of one block.  The 4 blocks (1 KiB) are
// read with one coalesced 4-byte load per thread into shared memory, then
// the two separable 8-point products t = D x and c = t D^T run from shared
// memory, and each thread writes its int16 (the block's 128 B coalesced).
//
// Arithmetic is pinned so the kernel equals its plain PyTorch version
// (ref.py) bit for bit: every product and sum is a separately rounded
// __fmul_rn / __fadd_rn (nvcc would otherwise contract them into FMAs),
// summed over j, then k, in ascending order starting from the first product;
// the quotient is an IEEE division (__fdiv_rn, never a multiplication by a
// reciprocal); rounding is rintf (half to even, like np.round / jnp.round,
// unlike roundf), clamped to the int16 range.  A thread's arithmetic depends
// only on its own block, so a block quantizes identically in any batch.
//
// D and M (512 B) travel by value as a kernel parameter, not through a
// __constant__ symbol set by a copy: encodes of different qp run
// concurrently from the tuner thread and the ingest caller, and a kernel
// argument is private to its launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlocks = 4;               // 8x8 blocks per thread block
constexpr int kThreads = kBlocks * 64;   // one thread per coefficient

struct Tables {
  float d[64];  // DCT-II basis, row-major D[k][i]
  float m[64];  // quant matrix
};

__global__ void __launch_bounds__(kThreads)
dct_quant_kernel(const float* __restrict__ x, int16_t* __restrict__ out,
                 const Tables tables, long long n) {
  __shared__ float s_d[64];
  __shared__ float s_x[kBlocks][64];
  __shared__ float s_t[kBlocks][64];

  const int tid = threadIdx.x;
  const int lb = tid >> 6;  // local block
  const int p = tid & 63;   // coefficient (row-major)
  const int i = p >> 3;
  const int l = p & 7;
  const long long blk = (long long)blockIdx.x * kBlocks + lb;
  const bool valid = blk < n;
  const long long off = blk * 64 + p;

  if (tid < 64) s_d[tid] = tables.d[tid];
  s_x[lb][p] = valid ? x[off] : 0.0f;
  __syncthreads();
  // t[i][l] = sum_j D[i][j] * x[j][l], j ascending
  float t = __fmul_rn(s_d[i * 8], s_x[lb][l]);
  for (int j = 1; j < 8; ++j)
    t = __fadd_rn(t, __fmul_rn(s_d[i * 8 + j], s_x[lb][j * 8 + l]));
  s_t[lb][p] = t;
  __syncthreads();
  // c[i][l] = sum_k t[i][k] * D[l][k], k ascending
  float c = __fmul_rn(s_t[lb][i * 8], s_d[l * 8]);
  for (int k = 1; k < 8; ++k)
    c = __fadd_rn(c, __fmul_rn(s_t[lb][i * 8 + k], s_d[l * 8 + k]));
  const float r = fminf(fmaxf(rintf(__fdiv_rn(c, tables.m[p])), -32768.0f),
                        32767.0f);
  if (valid) out[off] = (int16_t)r;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises.
// `tables` is a host pointer to 128 floats: D, then the quant matrix.
extern "C" int dct_quant(const void* x, void* out, const void* tables,
                         long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  Tables t;
  const float* src = static_cast<const float*>(tables);
  for (int k = 0; k < 64; ++k) {
    t.d[k] = src[k];
    t.m[k] = src[64 + k];
  }
  const long long grid = (n + kBlocks - 1) / kBlocks;
  dct_quant_kernel<<<(unsigned int)grid, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int16_t*>(out), t, n);
  return (int)cudaGetLastError();
}
