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
// Design (FlashAttention-2's backward): three kernels, launched in order on
// one stream, no atomics, so a result is the same bit for bit from run to
// run.
//   1. delta: one warp per query row, rowsum(dO * o) in f32.
//   2. dk/dv: one block per (batch, KV head, 64-key tile).  The block walks
//      the G query heads of its KV head and, for each, the query tiles that
//      can see the keys (from the diagonal on when causal), and adds into
//      dk and dv held in registers: the GQA sum happens here, in a fixed
//      order.  The blocks of the first key tiles, which see the most query
//      tiles, are scheduled first.
//   3. dq: one block per (batch, head, 64-row query tile), the heaviest
//      first, walking the key tiles up to the diagonal; it recomputes S and
//      dP rather than taking dq by atomics from kernel 2.
//
// bf16 (the training path): tensor cores.  A block is 4 warps issuing
// mma.sync.m16n8k16 on bf16 with f32 accumulators, for every product:
//   - dk/dv: each warp owns 16 keys.  K and V are copied once into padded
//     bf16 shared tiles (a 16-byte pad per row puts the 8 rows of every
//     ldmatrix in 8 bank groups) and, at D <= 64, their A fragments are held
//     in registers.  Q, dO and the query rows' lse and delta come through a
//     2-stage cp.async ring (zero-filled past S), so step i+1 loads while
//     step i is multiplied.  S^T = K Q^T and dP^T = V dO^T take their B
//     fragments from the Q and dO tiles by ldmatrix; P^T = exp2(S^T scale
//     log2(e) - lse log2(e)) and dS^T = P^T (dP^T - delta) are computed on
//     the accumulator fragments and masked there; dv += P^T dO and
//     dk += dS^T Q take their B fragments from the same tiles by
//     ldmatrix.trans.
//   - dq: each warp owns 16 query rows; Q's and dO's A fragments are held
//     in registers at D <= 64, the rows' lse and delta too; K and V come
//     through the 2-stage ring; S = Q K^T and dP = dO V^T by ldmatrix,
//     dq += dS K with K by ldmatrix.trans.
//   - P and dS go from the accumulators straight into the A fragments of
//     the second products, each split into two bf16 parts hi + lo (hi the
//     value rounded to bf16, lo the remainder rounded) that take one
//     product each, as the forward kernel splits P.  The gradients are held
//     to one bf16 ulp of each row's largest (1e-2), which the final
//     rounding alone nearly fills (7.35e-3 to 7.69e-3 on the card with f32
//     second products); rounded once to bf16 before those products, P and
//     dS alone err by 3.8e-3 to 4.9e-3 of the row's largest, split by
//     5.9e-6 to 8.1e-6 (the plain emulation `attention_bwd_bf16_mma_ref`
//     at (1, 9, 3, 2048, 64), as scripts/torch_kernel_probe.py reads it).
//   - So the design runs 10 product units where the bound counts 5: S and
//     dP, two for dv and two for dk in kernel 2; S and dP again and two for
//     dq in kernel 3.
//   - At D=128 the dk and dv accumulators take 128 registers a thread, so
//     the A fragments are read from shared memory at each use and a dk/dv
//     step takes 32 query rows, not 64.
//   - dk, dv and dq stay in f32 registers and are scaled and rounded to
//     bf16 once, at the end.
//
// f32 (the 2e-4 check; TF32 would break it): the CUDA-core design of the
// first version.  Each tile step computes S and dP on a 64 x 64 tile, a
// thread owning a 4 x 4 register tile of rows ti + 16 a and keys tj + 16 b,
// so a shared row stride of D + 1 floats keeps a warp's 16 key rows in 16
// banks; P and dS go through shared memory (stride 65) into the second
// products, where a thread owns 4 keys (or rows) by D / 16 dims.  Every
// product is an f32 FMA on the CUDA cores, and tiles load synchronously.
//
// The build uses no --use_fast_math; exp is expf (f32) and exp2f (bf16).
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
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int s) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    const int row = row0 + r;
    dst[r * Bwd<D>::kRow + c] =
        row < s ? src[(long long)row * D + c] : 0.f;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int h,
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
  load_tile<D>(ks, k + kv_base, k0, s);
  load_tile<D>(vs, v + kv_base, k0, s);

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
    const float* qg = q + bh * s * D;
    const float* dog = dout + bh * s * D;
    for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // every thread is done with the previous tile
      load_tile<D>(qs, qg, q0, s);
      load_tile<D>(dos, dog, q0, s);
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
      dk[at] = dk_acc[c][e] * scale;
      dv[at] = dv_acc[c][e];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq,
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
  load_tile<D>(qs, q + q_base, q0, s);
  load_tile<D>(dos, dout + q_base, q0, s);
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
    load_tile<D>(ks, k + kv_base, k0, s);
    load_tile<D>(vs, v + kv_base, k0, s);
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
      dq[q_base + (long long)row * D + td + 16 * e] = dq_acc[a][e] * scale;
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
int launch_delta(const void* o, const void* dout, float* delta, int b,
                 int h, int s, cudaStream_t stream) {
  const long long rows = (long long)b * h * s;
  const int per_block = kThreads / 32;
  attention_bwd_delta_kernel<T, D>
      <<<(unsigned int)((rows + per_block - 1) / per_block), kThreads, 0,
         stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                   delta, rows);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int b, int h, int kvh, int s, float scale,
               int causal, cudaStream_t stream) {
  using Sh = Bwd<D>;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  int err = launch_delta<float, D>(o, dout, delta, b, h, s, stream);
  if (err != 0) return err;

  const unsigned int n_tiles = (unsigned int)((s + kB - 1) / kB);
  auto dkdv = attention_bwd_dkdv_kernel<D>;
  if ((err = allow_smem(dkdv, Sh::kSmemKV)) != 0) return err;
  dkdv<<<dim3((unsigned int)(b * kvh), n_tiles), kThreads, Sh::kSmemKV,
         stream>>>(qt, kt, vt, dot, lse, delta, static_cast<float*>(dk),
                   static_cast<float*>(dv), h, kvh, s, scale, causal);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  auto dqk = attention_bwd_dq_kernel<D>;
  if ((err = allow_smem(dqk, Sh::kSmemQ)) != 0) return err;
  dqk<<<dim3((unsigned int)(b * h), n_tiles), kThreads, Sh::kSmemQ,
        stream>>>(qt, kt, vt, dot, lse, delta, static_cast<float*>(dq), h,
                  kvh, s, scale, causal);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bf16: tensor-core path
using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;                 // 16 keys (dk/dv) or rows (dq) each
constexpr int kMmaThreads = kWarps * 32;
constexpr int kPad = 8;                   // bf16 of padding per shared row
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kB == kWarps * 16, "a warp per 16 rows of a tile");

template <int D>
struct MmaBwd {
  static constexpr int kRow = D + kPad;           // shared row stride (bf16)
  static constexpr int kTile = kB * kRow;         // one 64-row tile (bf16)
  static constexpr bool kHold = D <= 64;          // A fragments in registers
  static constexpr int kQRows = D <= 64 ? kB : kB / 2;  // rows of a dk/dv step
  static constexpr int kQTile = kQRows * kRow;
  // dk/dv: K, V, then two stages of Q and dO, two of lse and delta
  static constexpr size_t kSmemKV =
      (2 * kTile + 4 * kQTile) * sizeof(bf16) + 4 * kQRows * sizeof(float);
  // dq: Q, dO, then two stages of K and two of V
  static constexpr size_t kSmemQ = 6 * kTile * sizeof(bf16);
};

// mma / ldmatrix / cp.async helpers, as in flash_attention.cu (copied, so
// that this source's digest covers all the code it builds)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr,
                                                  unsigned r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for a 16x16 bf16 A (row), a 16x8 bf16 B (col), f32 C
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// (a, b) = hi + lo: `hi` the pair rounded to bf16, `lo` the remainders
// rounded to bf16, so hi + lo keeps about 16 bits of each value
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// rows [row0, row0 + ROWS) of a [s, D] matrix into a padded shared tile,
// asynchronously, zero past s
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int row0, int s) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * kChunks % kMmaThreads == 0, "whole rounds");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kMmaThreads; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool ok = row0 + r < s;
    cp_async16(smem_addr(dst + r * MmaBwd<D>::kRow + c * 8),
               src + (long long)(ok ? row0 + r : 0) * D + c * 8, ok);
  }
}

// lse and delta of the rows [row0, row0 + ROWS), asynchronously, zero past s
template <int ROWS>
__device__ __forceinline__ void load_rows_async(float* lse_s, float* delta_s,
                                                const float* lse,
                                                const float* delta, int row0,
                                                int s) {
  static_assert(2 * ROWS <= kMmaThreads, "one value per thread");
  const int t = threadIdx.x;
  if (t < 2 * ROWS) {
    const int r = t % ROWS;
    const bool ok = row0 + r < s;
    cp_async4(smem_addr((t < ROWS ? lse_s : delta_s) + r),
              (t < ROWS ? lse : delta) + (ok ? row0 + r : 0), ok);
  }
}

// The A fragment of rows [row0, row0 + 16) and dims [16 ks, 16 ks + 16) of
// a padded tile.
template <int D>
__device__ __forceinline__ void load_a(const bf16* tile, int row0, int ks,
                                       unsigned a[4]) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(smem_addr(tile + (row0 + (lane & 15)) * MmaBwd<D>::kRow +
                        ks * 16 + (lane >> 4) * 8),
              a);
}

// B fragments of two n-tiles, the tile's rows [n0, n0 + 8) and
// [n0 + 8, n0 + 16) as n and dims [16 ks, 16 ks + 16) as k: b[0..1], b[2..3]
template <int D>
__device__ __forceinline__ void load_b(const bf16* tile, int n0, int ks,
                                       unsigned b[4]) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(smem_addr(tile +
                        (n0 + (lane & 7) + (lane >> 4) * 8) * MmaBwd<D>::kRow +
                        ks * 16 + ((lane >> 3) & 1) * 8),
              b);
}

// B fragments of two n-tiles, the tile's rows [k0, k0 + 16) as k and dims
// [16 dp, 16 dp + 8) and [16 dp + 8, 16 dp + 16) as n: b[0..1], b[2..3]
template <int D>
__device__ __forceinline__ void load_bt(const bf16* tile, int k0, int dp,
                                        unsigned b[4]) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(
      smem_addr(tile +
                (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * MmaBwd<D>::kRow +
                dp * 16 + (lane >> 4) * 8),
      b);
}

// An accumulator as the A operand of a second product: k-step j / 2 takes
// n-tiles j = 2 kk and 2 kk + 1, and the pair of n-tile j in fragment row
// g + 8 r (elements 2 r, 2 r + 1) is its register a_reg(j, r).
__device__ __forceinline__ int a_reg(int j, int r) { return 2 * (j & 1) + r; }

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int h, int kvh, int s, float scale,
                              float scale_log2, int causal) {
  using Sh = MmaBwd<D>;
  constexpr int kQRows = Sh::kQRows;
  constexpr int kKSteps = D / 16;        // k-steps of S^T and dP^T
  constexpr int kNTiles = kQRows / 8;    // n-tiles of S^T (query rows)
  constexpr int kRSteps = kQRows / 16;   // k-steps of dv and dk
  constexpr int kDTiles = D / 8;         // n-tiles of dv and dk
  constexpr int kHeld = Sh::kHold ? kKSteps : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + Sh::kTile;
  bf16* sq = sv + Sh::kTile;               // stages 0, 1
  bf16* sdo = sq + 2 * Sh::kQTile;         // stages 0, 1
  float* slse = reinterpret_cast<float*>(sdo + 2 * Sh::kQTile);
  float* sdelta = slse + 2 * kQRows;

  const int bk = blockIdx.x;  // b * kvh + kv head
  const int b = bk / kvh;
  const int kv_head = bk % kvh;
  const int G = h / kvh;
  const int k0 = blockIdx.y * kB;  // the first key tiles see the most rows
  const long long kv_base = (long long)bk * s * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row (and row + 8): this warp's keys
  const int tig = lane & 3;  // fragment column pair: query rows
  const int wkey = warp * 16;

  // step i: query head kv_head * G + i / per_head, query rows from
  // (qt0 + i % per_head) * kQRows
  const int qt0 = causal ? k0 / kQRows : 0;
  const int per_head = (s + kQRows - 1) / kQRows - qt0;
  const int n_steps = G * per_head;
  auto load_step = [&](int i, int stage) {
    const long long bh = (long long)b * h + kv_head * G + i / per_head;
    const int q0 = (qt0 + i % per_head) * kQRows;
    load_tile_async<D, kQRows>(sq + stage * Sh::kQTile, q + bh * s * D, q0,
                               s);
    load_tile_async<D, kQRows>(sdo + stage * Sh::kQTile, dout + bh * s * D,
                               q0, s);
    load_rows_async<kQRows>(slse + stage * kQRows, sdelta + stage * kQRows,
                            lse + bh * s, delta + bh * s, q0, s);
  };
  load_tile_async<D, kB>(sk, k + kv_base, k0, s);
  load_tile_async<D, kB>(sv, v + kv_base, k0, s);
  load_step(0, 0);
  cp_async_commit();

  unsigned kf[kHeld][4], vf[kHeld][4];
  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_steps) {
      load_step(i + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step i (and at i == 0 the K and V tiles) has landed
    if (Sh::kHold && i == 0) {
#pragma unroll
      for (int ks = 0; ks < kHeld; ++ks) {
        load_a<D>(sk, wkey, ks, kf[ks]);
        load_a<D>(sv, wkey, ks, vf[ks]);
      }
    }
    const bf16* q_s = sq + stage * Sh::kQTile;
    const bf16* do_s = sdo + stage * Sh::kQTile;
    const float* lse_s = slse + stage * kQRows;
    const float* delta_s = sdelta + stage * kQRows;
    const int q0 = (qt0 + i % per_head) * kQRows;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys
    float sacc[kNTiles][4], dpacc[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = dpacc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      unsigned ka[4], va[4];
      if constexpr (Sh::kHold) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ka[r] = kf[ks][r];
          va[r] = vf[ks][r];
        }
      } else {
        load_a<D>(sk, wkey, ks, ka);
        load_a<D>(sv, wkey, ks, va);
      }
#pragma unroll
      for (int jp = 0; jp < kNTiles / 2; ++jp) {
        unsigned bf[4];
        load_b<D>(q_s, jp * 16, ks, bf);
        mma_bf16(sacc[2 * jp], ka, bf[0], bf[1]);
        mma_bf16(sacc[2 * jp + 1], ka, bf[2], bf[3]);
        load_b<D>(do_s, jp * 16, ks, bf);
        mma_bf16(dpacc[2 * jp], va, bf[0], bf[1]);
        mma_bf16(dpacc[2 * jp + 1], va, bf[2], bf[3]);
      }
    }

    // P^T and dS^T on the fragments: element e of n-tile j is key
    // k0 + wkey + g + 8 (e >> 1), query row q0 + 8 j + 2 tig + (e & 1)
    const bool masked = q0 + kQRows > s || k0 + kB > s ||
                        (causal && k0 + wkey + 15 > q0);
    unsigned p_hi[kRSteps][4], p_lo[kRSteps][4];
    unsigned ds_hi[kRSteps][4], ds_lo[kRSteps][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const int c = 8 * j + 2 * tig;
      const float l2[2] = {lse_s[c] * kLog2e, lse_s[c + 1] * kLog2e};
      const float dl[2] = {delta_s[c], delta_s[c + 1]};
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // key g, then key g + 8
        float p[2], ds[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 2 * r + x;
          float pe = exp2f(fmaf(sacc[j][e], scale_log2, -l2[x]));
          if (masked) {
            const int key = k0 + wkey + g + 8 * r;
            const int row = q0 + c + x;
            if (row >= s || key >= s || (causal && key > row)) pe = 0.f;
          }
          p[x] = pe;
          ds[x] = pe * (dpacc[j][e] - dl[x]);
        }
        split_bf16(p[0], p[1], p_hi[j >> 1][a_reg(j, r)],
                   p_lo[j >> 1][a_reg(j, r)]);
        split_bf16(ds[0], ds[1], ds_hi[j >> 1][a_reg(j, r)],
                   ds_lo[j >> 1][a_reg(j, r)]);
      }
    }

    // dv += P^T dO, dk += dS^T Q, each in two parts
#pragma unroll
    for (int kk = 0; kk < kRSteps; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        unsigned bf[4];
        load_bt<D>(do_s, kk * 16, dp, bf);
        mma_bf16(dv_acc[2 * dp], p_hi[kk], bf[0], bf[1]);
        mma_bf16(dv_acc[2 * dp], p_lo[kk], bf[0], bf[1]);
        mma_bf16(dv_acc[2 * dp + 1], p_hi[kk], bf[2], bf[3]);
        mma_bf16(dv_acc[2 * dp + 1], p_lo[kk], bf[2], bf[3]);
        load_bt<D>(q_s, kk * 16, dp, bf);
        mma_bf16(dk_acc[2 * dp], ds_hi[kk], bf[0], bf[1]);
        mma_bf16(dk_acc[2 * dp], ds_lo[kk], bf[0], bf[1]);
        mma_bf16(dk_acc[2 * dp + 1], ds_hi[kk], bf[2], bf[3]);
        mma_bf16(dk_acc[2 * dp + 1], ds_lo[kk], bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // element e of n-tile n: key k0 + wkey + g + 8 (e >> 1), dims
  // 8 n + 2 tig + (e & 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wkey + g + 8 * r;
    if (key >= s) continue;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      const long long at = kv_base + (long long)key * D + n * 8 + 2 * tig;
      *reinterpret_cast<unsigned*>(dk + at) =
          pack_bf16(dk_acc[n][2 * r] * scale, dk_acc[n][2 * r + 1] * scale);
      *reinterpret_cast<unsigned*>(dv + at) =
          pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dq, int h, int kvh, int s,
                            float scale, float scale_log2, int causal) {
  using Sh = MmaBwd<D>;
  constexpr int kKSteps = D / 16;   // k-steps of S and dP
  constexpr int kNTiles = kB / 8;   // n-tiles of S (keys)
  constexpr int kDTiles = D / 8;    // n-tiles of dq
  constexpr int kHeld = Sh::kHold ? kKSteps : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + Sh::kTile;
  bf16* sk = sdo + Sh::kTile;       // stages 0, 1
  bf16* sv = sk + 2 * Sh::kTile;    // stages 0, 1

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;  // heaviest first
  const int b = bh / h;
  const int kv_head = (bh % h) / (h / kvh);
  const long long q_base = (long long)bh * s * D;
  const long long kv_base = ((long long)b * kvh + kv_head) * s * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tig = lane & 3;  // fragment column pair: keys
  const int wrow = warp * 16;

  const int q_last = min(q0 + kB, s) - 1;
  const int n_kt = causal ? q_last / kB + 1 : (s + kB - 1) / kB;

  load_tile_async<D, kB>(sq, q + q_base, q0, s);
  load_tile_async<D, kB>(sdo, dout + q_base, q0, s);
  load_tile_async<D, kB>(sk, k + kv_base, 0, s);
  load_tile_async<D, kB>(sv, v + kv_base, 0, s);
  cp_async_commit();

  float l2[2], dl[2];  // rows g, g + 8 of the warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    l2[r] = row < s ? lse[(long long)bh * s + row] * kLog2e : 0.f;
    dl[r] = row < s ? delta[(long long)bh * s + row] : 0.f;
  }
  unsigned qf[kHeld][4], of[kHeld][4];
  float dq_acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile_async<D, kB>(sk + (stage ^ 1) * Sh::kTile, k + kv_base,
                             (kt + 1) * kB, s);
      load_tile_async<D, kB>(sv + (stage ^ 1) * Sh::kTile, v + kv_base,
                             (kt + 1) * kB, s);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and at kt == 0 the Q and dO tiles) landed
    if (Sh::kHold && kt == 0) {
#pragma unroll
      for (int ks = 0; ks < kHeld; ++ks) {
        load_a<D>(sq, wrow, ks, qf[ks]);
        load_a<D>(sdo, wrow, ks, of[ks]);
      }
    }
    const bf16* k_s = sk + stage * Sh::kTile;
    const bf16* v_s = sv + stage * Sh::kTile;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows
    float sacc[kNTiles][4], dpacc[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = dpacc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      unsigned qa[4], oa[4];
      if constexpr (Sh::kHold) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qa[r] = qf[ks][r];
          oa[r] = of[ks][r];
        }
      } else {
        load_a<D>(sq, wrow, ks, qa);
        load_a<D>(sdo, wrow, ks, oa);
      }
#pragma unroll
      for (int jp = 0; jp < kNTiles / 2; ++jp) {
        unsigned bf[4];
        load_b<D>(k_s, jp * 16, ks, bf);
        mma_bf16(sacc[2 * jp], qa, bf[0], bf[1]);
        mma_bf16(sacc[2 * jp + 1], qa, bf[2], bf[3]);
        load_b<D>(v_s, jp * 16, ks, bf);
        mma_bf16(dpacc[2 * jp], oa, bf[0], bf[1]);
        mma_bf16(dpacc[2 * jp + 1], oa, bf[2], bf[3]);
      }
    }

    // dS on the fragments: element e of n-tile j is row
    // q0 + wrow + g + 8 (e >> 1), key k0 + 8 j + 2 tig + (e & 1)
    const int k0 = kt * kB;
    const bool masked = q0 + kB > s || k0 + kB > s ||
                        (causal && k0 + kB - 1 > q0 + wrow);
    unsigned ds_hi[kB / 16][4], ds_lo[kB / 16][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // row g, then row g + 8
        float ds[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 2 * r + x;
          float pe = exp2f(fmaf(sacc[j][e], scale_log2, -l2[r]));
          if (masked) {
            const int row = q0 + wrow + g + 8 * r;
            const int key = k0 + 8 * j + 2 * tig + x;
            if (row >= s || key >= s || (causal && key > row)) pe = 0.f;
          }
          ds[x] = pe * (dpacc[j][e] - dl[r]);
        }
        split_bf16(ds[0], ds[1], ds_hi[j >> 1][a_reg(j, r)],
                   ds_lo[j >> 1][a_reg(j, r)]);
      }
    }

    // dq += dS K, in two parts
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        unsigned bf[4];
        load_bt<D>(k_s, kk * 16, dp, bf);
        mma_bf16(dq_acc[2 * dp], ds_hi[kk], bf[0], bf[1]);
        mma_bf16(dq_acc[2 * dp], ds_lo[kk], bf[0], bf[1]);
        mma_bf16(dq_acc[2 * dp + 1], ds_hi[kk], bf[2], bf[3]);
        mma_bf16(dq_acc[2 * dp + 1], ds_lo[kk], bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    if (row >= s) continue;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      *reinterpret_cast<unsigned*>(dq + q_base + (long long)row * D + n * 8 +
                                   2 * tig) =
          pack_bf16(dq_acc[n][2 * r] * scale, dq_acc[n][2 * r + 1] * scale);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int b, int h, int kvh, int s, float scale,
               int causal, cudaStream_t stream) {
  using Sh = MmaBwd<D>;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float scale_log2 = scale * kLog2e;
  int err = launch_delta<bf16, D>(o, dout, delta, b, h, s, stream);
  if (err != 0) return err;

  const unsigned int n_tiles = (unsigned int)((s + kB - 1) / kB);
  auto dkdv = attention_bwd_dkdv_mma_kernel<D>;
  if ((err = allow_smem(dkdv, Sh::kSmemKV)) != 0) return err;
  dkdv<<<dim3((unsigned int)(b * kvh), n_tiles), kMmaThreads, Sh::kSmemKV,
         stream>>>(qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), h, kvh, s, scale, scale_log2,
                   causal);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  auto dqk = attention_bwd_dq_mma_kernel<D>;
  if ((err = allow_smem(dqk, Sh::kSmemQ)) != 0) return err;
  dqk<<<dim3((unsigned int)(b * h), n_tiles), kMmaThreads, Sh::kSmemQ,
        stream>>>(qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), h,
                  kvh, s, scale, scale_log2, causal);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int b, int h, int kvh, int s, int d,
             int dtype, float scale, int causal, cudaStream_t st) {
#define REPRO_BWD_CASE(D)                                                   \
  case D:                                                                   \
    return dtype == 0 ? launch_f32<D>(q, k, v, o, dout, lse, delta, dq, dk,  \
                                      dv, b, h, kvh, s, scale, causal, st)   \
                      : launch_mma<D>(q, k, v, o, dout, lse, delta, dq, dk,  \
                                      dv, b, h, kvh, s, scale, causal, st);
  switch (d) {
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_BWD_CASE
}

}  // namespace

// Launches the three kernels on `stream` and returns cudaGetLastError();
// never synchronises.  dtype: 0 = float32 (CUDA-core kernels), 1 = bfloat16
// (tensor-core kernels) for q, k, v, o, dO and the three gradients.
// `delta` is f32 scratch of B * H * S floats.  Every tensor is contiguous,
// and q, k, v and dO are 16-byte aligned (the wrapper checks).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int b, int h, int kvh, int s, int d,
                                   int dtype, int causal, float scale,
                                   void* stream) {
  if (b < 1 || h < 1 || kvh < 1 || s < 1 || h % kvh != 0 ||
      (long long)b * h > 0x7fffffffLL || (s + kB - 1) / kB > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return dispatch(q, k, v, o, dout, static_cast<const float*>(lse),
                  static_cast<float*>(delta), dq, dk, dv, b, h, kvh, s, d,
                  dtype, scale, causal, static_cast<cudaStream_t>(stream));
}
