// Batched GOP decode for Hopper (sm_90a): fused dequant + 8x8 IDCT + the
// closed-loop prefix sum over a GOP's frames.
//
// Replaces the Pallas TPU kernel `decode_gop_blocks`
// (src/repro/kernels/decode/decode.py).  Same contract:
//   q   [F, M, 8, 8] int16  row 0 intra keyframe coefficients, rows 1..F-1
//                           inter residual coefficients, M block columns
//   out [F, M, 8, 8] f32    out[f] = sum_{g <= f} D^T (q[g] * Q_g) D,
//                           Q_0 = intra matrix, Q_g = inter matrix (g >= 1)
//
// Bound: memory.  One block-frame reads 128 B (int16 in) and writes 256 B
// (f32 out) for about 2 kFLOP (16 FMAs per pixel plus the dequant and the
// running sum), ~5.7 FLOP/B against the card's ~20 fp32 FLOP/B balance
// point, so the floor is F*M*384 B over HBM bandwidth.
//
// Design (simple first): a thread block of 256 threads owns 4 columns; each
// thread owns one output pixel (i, l) of one column.  Per frame the column's
// dequantized coefficients go through shared memory for the two separable
// 8-point products (t = D^T C, then x = t D), and each thread keeps the
// running GOP sum for its pixel in a register while it walks F in order, so
// nothing but the input and the final per-frame output touches HBM.  All
// arithmetic is fp32 FMA on the CUDA cores: TF32 tensor cores would break the
// 1e-3 tolerance against the numpy oracle.  A thread's arithmetic depends
// only on its own column, never on M or on the column's position, so a
// column decodes bit-identically in any batch.
//
// The tables (D and both quant matrices) are passed by value as a kernel
// parameter, not through a __constant__ symbol: concurrent host threads
// decode groups of different qp, and a kernel argument is private to its
// launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 4;              // columns per thread block
constexpr int kThreads = kCols * 64;  // one thread per pixel of each column

struct Tables {
  float d[64];      // DCT-II basis, row-major D[k][i]
  float intra[64];  // keyframe quant matrix
  float inter[64];  // residual quant matrix
};

__global__ void __launch_bounds__(kThreads)
decode_gop_blocks_kernel(const int16_t* __restrict__ q,
                         float* __restrict__ out, const Tables tables,
                         int n_frames, long long n_cols) {
  __shared__ float s_d[64];
  __shared__ float s_intra[64];
  __shared__ float s_inter[64];
  __shared__ float s_c[kCols][64];  // dequantized coefficients C
  __shared__ float s_t[kCols][64];  // D^T C

  const int tid = threadIdx.x;
  const int lc = tid >> 6;  // local column
  const int p = tid & 63;   // pixel (row-major)
  const int i = p >> 3;
  const int l = p & 7;
  const long long col = (long long)blockIdx.x * kCols + lc;
  const bool valid = col < n_cols;

  if (tid < 64) {
    s_d[tid] = tables.d[tid];
    s_intra[tid] = tables.intra[tid];
    s_inter[tid] = tables.inter[tid];
  }
  __syncthreads();

  float acc = 0.0f;
  for (int f = 0; f < n_frames; ++f) {
    const long long off = ((long long)f * n_cols + col) * 64 + p;
    if (valid) {
      const float m = f == 0 ? s_intra[p] : s_inter[p];
      s_c[lc][p] = (float)q[off] * m;
    }
    __syncthreads();
    // t[i][l] = sum_j D[j][i] * C[j][l], j ascending
    float t = 0.0f;
    for (int j = 0; j < 8; ++j) t = fmaf(s_d[j * 8 + i], s_c[lc][j * 8 + l], t);
    s_t[lc][p] = t;
    __syncthreads();
    // x[i][l] = sum_k t[i][k] * D[k][l], k ascending
    float x = 0.0f;
    for (int k = 0; k < 8; ++k) x = fmaf(s_t[lc][i * 8 + k], s_d[k * 8 + l], x);
    acc += x;
    if (valid) out[off] = acc;
    // s_c of frame f+1 is written after the second barrier of frame f, and
    // s_t of frame f+1 after the first barrier of frame f+1, so two
    // barriers per frame keep every read ahead of the next write.
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises.
// `tables` is a host pointer to 192 floats: D, the intra and the inter matrix.
extern "C" int decode_gop_blocks(const void* q, void* out, const void* tables,
                                 int n_frames, long long n_cols,
                                 void* stream) {
  if (n_frames < 1 || n_cols < 1) return (int)cudaErrorInvalidValue;
  Tables t;
  const float* src = static_cast<const float*>(tables);
  for (int k = 0; k < 64; ++k) {
    t.d[k] = src[k];
    t.intra[k] = src[64 + k];
    t.inter[k] = src[128 + k];
  }
  const long long blocks = (n_cols + kCols - 1) / kCols;
  decode_gop_blocks_kernel<<<(unsigned int)blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(q), static_cast<float*>(out), t, n_frames,
      n_cols);
  return (int)cudaGetLastError();
}
