// The gradient of GQA attention for Hopper (sm_90a): the attention backward
// of every layer of the port's training step.
//
// Replaces: no Pallas kernel.  The reference has no backward kernel
// (src/repro/kernels/flash_attention/ holds no custom_vjp); it trains
// through its chunked jnp attention (src/repro/models/attention.py,
// `_chunked_attention`) by autodiff under `jax.value_and_grad`.  The port's
// forward runs `flash_attention.cu`, so this kernel is the counterpart of
// the gradient JAX takes of the same function.  Contract:
//   q, o, dO [B, H, S, D]; k, v [B, KV, S, D]; H % KV == 0; f32 or bf16
//   lse [B, H, S] f32: each row's logsumexp of its scaled, masked scores in
//       the natural log domain, as the forward kernel writes it
//   dq [B, H, S, D], dk and dv [B, KV, S, D], in q's type, with
//     P  = exp(scale q k^T - lse), masked (key > row when causal) to 0
//     dv = sum over the G query heads of P^T dO
//     dP = dO v^T, delta = rowsum(dO * o), dS = P (dP - delta)
//     dq = scale dS k,  dk = scale sum over the G heads of dS^T q
//   accumulated in f32.
//
// Bound: operations.  The gradient needs five products of S^2 D
// multiply-adds per head (the recomputed scores, dP, dv, dk, dq), halved
// when causal: at B=8, S=2048, 9 heads and D=64, 4.8e10 multiply-adds,
// 0.098 ms at the bf16 tensor-core rate; its bytes (q, k, v, o, dO, lse
// read once, dq, dk, dv written once, 101 MB) take 0.030 ms at 3.35 TB/s.
//
// Design (FlashAttention-2's backward, first version, on the CUDA cores):
// three kernels, launched in order on one stream, no atomics, so a result
// is the same bit for bit from run to run.
//   1. delta: one warp per query row, rowsum(dO * o) in f32.
//   2. dk/dv: one block per (batch, KV head, 64-key tile).  The tile's K and
//      V stay in shared memory; the block walks the G query heads of its KV
//      head and, for each, the 64-row query tiles that can see the keys
//      (from the diagonal on when causal), and adds into dk and dv held in
//      registers: the GQA sum happens here, in a fixed order.  The blocks
//      of the first key tiles, which see the most query tiles, are
//      scheduled first.
//   3. dq: one block per (batch, head, 64-row query tile), walking the key
//      tiles up to the diagonal; it recomputes S and dP rather than taking
//      dq by atomics from kernel 2 (seven products in all, not five).
// Each tile step computes S and dP on a 64 x 64 tile, a thread owning a
// 4 x 4 register tile of rows ti + 16 a and keys tj + 16 b, so a shared
// row stride of D + 1 floats keeps a warp's 16 key rows in 16 banks; P and
// dS go through shared memory (stride 65) into the second products, where
// a thread owns 4 keys (or rows) by D / 16 dims.  All inputs are staged as
// f32 and every product is an f32 FMA on the CUDA cores: 8 shared loads
// feed 16 FMAs, so the kernel runs far from the tensor-core bound it is
// held to.  The tensor cores (mma.sync or wgmma on bf16, TMA staging) are
// the redesign (ROADMAP, queue 2).
//
// The build uses no --use_fast_math; exp is expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kB = 64;           // query rows and keys per tile
constexpr int kThreads = 256;    // a 16 x 16 grid of 4 x 4 register tiles
constexpr int kPadS = kB + 1;    // shared row stride of P and dS (floats)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
struct Bwd {
  static constexpr int kRow = D + 1;            // shared row stride (f32)
  static constexpr int kTile = kB * kRow;       // one 64-row tile
  static constexpr int kDPer = D / 16;          // dims per thread
  // dk/dv: K, V, Q, dO tiles, P and dS, lse and delta of the query tile
  static constexpr size_t kSmemKV =
      (4 * kTile + 2 * kB * kPadS + 2 * kB) * sizeof(float);
  // dq: Q, dO, K, V tiles, dS, lse and delta
  static constexpr size_t kSmemQ =
      (4 * kTile + kB * kPadS + 2 * kB) * sizeof(float);
};

// rows [row0, row0 + 64) of a [s, D] matrix into an f32 shared tile of row
// stride D + 1, zero past s
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int s) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    const int row = row0 + r;
    dst[r * Bwd<D>::kRow + c] =
        row < s ? to_f(src[(long long)row * D + c]) : 0.f;
  }
}

// lse and delta of the rows [row0, row0 + 64), zero past s
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, int row0,
                                          int s) {
  if (threadIdx.x < kB) {
    const int row = row0 + threadIdx.x;
    lse_s[threadIdx.x] = row < s ? lse[row] : 0.f;
    delta_s[threadIdx.x] = row < s ? delta[row] : 0.f;
  }
}

// On the tile of query rows [q0, q0 + 64) and keys [k0, k0 + 64): S = Q K^T
// and dP = dO V^T, then P = exp(scale S - lse) (0 where masked or past s)
// into `ps` (unless null) and dS = P (dP - delta) into `dss`, both [row][key]
// with stride kPadS.  Thread (ti, tj) owns rows ti + 16 a and keys
// tj + 16 b.
template <int D>
__device__ __forceinline__ void score_tile(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* delta_s, int q0, int k0, int s,
    int causal, float scale, float* ps, float* dss) {
  constexpr int R = Bwd<D>::kRow;
  const int ti = threadIdx.x / 16;
  const int tj = threadIdx.x % 16;
  float sa[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) sa[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = qs[(ti + 16 * a) * R + d];
      oa[a] = dos[(ti + 16 * a) * R + d];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kb[b] = ks[(tj + 16 * b) * R + d];
      vb[b] = vs[(tj + 16 * b) * R + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        sa[a][b] = fmaf(qa[a], kb[b], sa[a][b]);
        dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ti + 16 * a;
    const int row = q0 + i;
    const float lse_i = lse_s[i];
    const float delta_i = delta_s[i];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tj + 16 * b;
      const int key = k0 + j;
      const bool live = row < s && key < s && !(causal && key > row);
      const float p = live ? expf(sa[a][b] * scale - lse_i) : 0.f;
      if (ps != nullptr) ps[i * kPadS + j] = p;
      dss[i * kPadS + j] = p * (dp[a][b] - delta_i);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_delta_kernel(const T* __restrict__ o,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, long long rows) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f(dout[row * D + d]), to_f(o[row * D + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int h,
                          int kvh, int s, float scale, int causal) {
  using Sh = Bwd<D>;
  constexpr int R = Sh::kRow;
  constexpr int kDPer = Sh::kDPer;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + Sh::kTile;
  float* qs = vs + Sh::kTile;
  float* dos = qs + Sh::kTile;
  float* ps = dos + Sh::kTile;
  float* dss = ps + kB * kPadS;
  float* lse_s = dss + kB * kPadS;
  float* delta_s = lse_s + kB;

  const int bk = blockIdx.x;  // b * kvh + kv head
  const int b = bk / kvh;
  const int kv_head = bk % kvh;
  const int G = h / kvh;
  const int kt = blockIdx.y;  // the first key tiles see the most queries
  const int k0 = kt * kB;
  const long long kv_base = (long long)bk * s * D;
  load_tile<T, D>(ks, k + kv_base, k0, s);
  load_tile<T, D>(vs, v + kv_base, k0, s);

  // thread (tj, td) owns keys tj + 16 c and dims td + 16 e
  const int tj = threadIdx.x % 16;
  const int td = threadIdx.x / 16;
  float dk_acc[4][kDPer], dv_acc[4][kDPer];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < kDPer; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;

  const int n_qt = (s + kB - 1) / kB;
  for (int g = 0; g < G; ++g) {
    const long long bh = (long long)b * h + kv_head * G + g;
    const T* qg = q + bh * s * D;
    const T* dog = dout + bh * s * D;
    for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // every thread is done with the previous tile
      load_tile<T, D>(qs, qg, q0, s);
      load_tile<T, D>(dos, dog, q0, s);
      load_rows(lse_s, delta_s, lse + bh * s, delta + bh * s, q0, s);
      __syncthreads();
      score_tile<D>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, s, causal,
                    scale, ps, dss);
      __syncthreads();
      // dv += P^T dO, dk += dS^T Q
      for (int i = 0; i < kB; ++i) {
        float pc[4], sc[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pc[c] = ps[i * kPadS + tj + 16 * c];
          sc[c] = dss[i * kPadS + tj + 16 * c];
        }
#pragma unroll
        for (int e = 0; e < kDPer; ++e) {
          const float o_ie = dos[i * R + td + 16 * e];
          const float q_ie = qs[i * R + td + 16 * e];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dv_acc[c][e] = fmaf(pc[c], o_ie, dv_acc[c][e]);
            dk_acc[c][e] = fmaf(sc[c], q_ie, dk_acc[c][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int key = k0 + tj + 16 * c;
    if (key >= s) continue;
#pragma unroll
    for (int e = 0; e < kDPer; ++e) {
      const long long at = kv_base + (long long)key * D + td + 16 * e;
      store_f(dk + at, dk_acc[c][e] * scale);
      store_f(dv + at, dv_acc[c][e]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int h, int kvh, int s, float scale, int causal) {
  using Sh = Bwd<D>;
  constexpr int R = Sh::kRow;
  constexpr int kDPer = Sh::kDPer;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + Sh::kTile;
  float* ks = dos + Sh::kTile;
  float* vs = ks + Sh::kTile;
  float* dss = vs + Sh::kTile;
  float* lse_s = dss + kB * kPadS;
  float* delta_s = lse_s + kB;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kB;
  const int b = bh / h;
  const int kv_head = (bh % h) / (h / kvh);
  const long long q_base = (long long)bh * s * D;
  const long long kv_base = ((long long)b * kvh + kv_head) * s * D;
  load_tile<T, D>(qs, q + q_base, q0, s);
  load_tile<T, D>(dos, dout + q_base, q0, s);
  load_rows(lse_s, delta_s, lse + (long long)bh * s,
            delta + (long long)bh * s, q0, s);

  // thread (ti, td) owns rows ti + 16 a and dims td + 16 e
  const int ti = threadIdx.x % 16;
  const int td = threadIdx.x / 16;
  float dq_acc[4][kDPer];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kDPer; ++e) dq_acc[a][e] = 0.f;

  const int n_kt = causal ? qt + 1 : (s + kB - 1) / kB;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // every thread is done with the previous tile
    load_tile<T, D>(ks, k + kv_base, k0, s);
    load_tile<T, D>(vs, v + kv_base, k0, s);
    __syncthreads();
    score_tile<D>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, s, causal, scale,
                  nullptr, dss);
    __syncthreads();
    // dq += dS K
    for (int j = 0; j < kB; ++j) {
      float sa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = dss[(ti + 16 * a) * kPadS + j];
#pragma unroll
      for (int e = 0; e < kDPer; ++e) {
        const float k_je = ks[j * R + td + 16 * e];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          dq_acc[a][e] = fmaf(sa[a], k_je, dq_acc[a][e]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ti + 16 * a;
    if (row >= s) continue;
#pragma unroll
    for (int e = 0; e < kDPer; ++e)
      store_f(dq + q_base + (long long)row * D + td + 16 * e,
              dq_acc[a][e] * scale);
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int b, int h, int kvh, int s, float scale,
           int causal, cudaStream_t stream) {
  using Sh = Bwd<D>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long rows = (long long)b * h * s;
  const int per_block = kThreads / 32;
  attention_bwd_delta_kernel<T, D>
      <<<(unsigned int)((rows + per_block - 1) / per_block), kThreads, 0,
         stream>>>(static_cast<const T*>(o), dot, delta, rows);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  const unsigned int n_tiles = (unsigned int)((s + kB - 1) / kB);
  auto dkdv = attention_bwd_dkdv_kernel<T, D>;
  if ((err = allow_smem(dkdv, Sh::kSmemKV)) != 0) return err;
  dkdv<<<dim3((unsigned int)(b * kvh), n_tiles), kThreads, Sh::kSmemKV,
         stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
                   static_cast<T*>(dv), h, kvh, s, scale, causal);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  auto dqk = attention_bwd_dq_kernel<T, D>;
  if ((err = allow_smem(dqk, Sh::kSmemQ)) != 0) return err;
  dqk<<<dim3((unsigned int)(b * h), n_tiles), kThreads, Sh::kSmemQ,
        stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), h, kvh,
                  s, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int b, int h, int kvh, int s, int d,
               float scale, int causal, cudaStream_t st) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h,
                           kvh, s, scale, causal, st);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h,
                           kvh, s, scale, causal, st);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h,
                            kvh, s, scale, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the three kernels on `stream` and returns cudaGetLastError();
// never synchronises.  dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO and
// the three gradients).  `delta` is f32 scratch of B * H * S floats.  Every
// tensor is contiguous (the wrapper checks).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int b, int h, int kvh, int s, int d,
                                   int dtype, int causal, float scale,
                                   void* stream) {
  if (b < 1 || h < 1 || kvh < 1 || s < 1 || h % kvh != 0 ||
      (long long)b * h > 0x7fffffffLL || (s + kB - 1) / kB > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, dout, l, dl, dq, dk, dv, b, h, kvh,
                             s, d, scale, causal, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, dout, l, dl, dq, dk, dv, b,
                                     h, kvh, s, d, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
