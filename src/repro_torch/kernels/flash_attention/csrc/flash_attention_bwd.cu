// The gradient of GQA attention for Hopper (sm_90a): the attention backward
// of every layer of the port's training step.
//
// Replaces: no Pallas kernel.  The reference has no backward kernel
// (src/repro/kernels/flash_attention/ holds no custom_vjp); it trains
// through its chunked jnp attention (src/repro/models/attention.py,
// `_chunked_attention`) by autodiff under `jax.value_and_grad`.  The port's
// forward runs `flash_attention.cu`, so this kernel is the counterpart of
// the gradient JAX takes of the same function, at the forward's widths and
// lengths.  Contract:
//   q [B, H, S, DQK]; k [B, KV, SKV, DQK]; v [B, KV, SKV, DV];
//   o, dO [B, H, S, DV]; H % KV == 0; f32 or bf16; (DQK, DV) one of the
//   forward's pairs (32, 32), (64, 64), (128, 128), (192, 128) (MLA);
//   SKV == S when causal (the entry refuses causal with two lengths, as
//   the forward does), any SKV otherwise (cross-attention)
//   lse [B, H, S] f32: each row's logsumexp of its scaled, masked scores in
//       the natural log domain, as the forward kernel writes it
//   dq [B, H, S, DQK], dk [B, KV, SKV, DQK], dv [B, KV, SKV, DV], in q's
//   type, with
//     P  = exp(scale q k^T - lse), masked (key > row when causal, and
//          key >= SKV) to 0
//     dv = sum over the G query heads of P^T dO
//     dP = dO v^T, delta = rowsum(dO * o), dS = P (dP - delta)
//     dq = scale dS k,  dk = scale sum over the G heads of dS^T q
//   accumulated in f32, scale = 1 / sqrt(DQK).
//
// Bound: operations at training lengths, bytes at prefill lengths.  The
// gradient needs five products per (row, key) pair: the recomputed scores
// and dq, dk over DQK, dP and dv over DV; causal halves the pairs.  At
// B=8, S=2048, 9 heads and D=64, 4.8e10 multiply-adds, 0.098 ms at the
// bf16 tensor-core rate, and its bytes (q, k, v, o, dO, lse read once, dq,
// dk, dv written once, 101 MB) 0.030 ms at 3.35 TB/s.  At MLA's (8, 16,
// 16, 512, 192 / 128) the bytes (168 MB) take 0.050 ms and the operations
// 0.028 ms; at seamless-m4t-medium's cross-attention (512 queries over 128
// keys, 16 heads of 64) the bytes take 0.013 ms.
//
// Design (FlashAttention-2's backward): three kernels, launched in order on
// one stream, no atomics, so a result is the same bit for bit from run to
// run.
//   1. delta: one warp per query row, rowsum(dO * o) over DV in f32.
//   2. dk/dv: one block per (batch, KV head, 64-key tile of SKV).  The block
//      walks the G query heads of its KV head and, for each, the query tiles
//      of S that can see the keys (from the diagonal on when causal), and
//      adds into dk and dv held in registers: the GQA sum happens here, in a
//      fixed order.  The blocks of the first key tiles, which see the most
//      query tiles, are scheduled first.
//   3. dq: one block per (batch, head, 64-row query tile of S), the heaviest
//      first, walking SKV's key tiles up to the diagonal; it recomputes S
//      and dP rather than taking dq by atomics from kernel 2.
// Zero-filled rows past S or SKV do not give P = 0 (a zero key gives
// P = exp(-lse)), so every tile with such rows masks P by index before it
// reaches a product that is written back.
//
// bf16 (the training path): tensor cores.  A block is 4 warps issuing
// mma.sync.m16n8k16 on bf16 with f32 accumulators, for every product:
//   - dk/dv: each warp owns 16 keys.  K and V are copied once into padded
//     bf16 shared tiles (a 16-byte pad per row puts the 8 rows of every
//     ldmatrix in 8 bank groups, at row strides DQK + 8 and DV + 8) and, at
//     D <= 64, their A fragments are held in registers.  Q, dO and the query
//     rows' lse and delta come through a 2-stage cp.async ring (zero-filled
//     past S), so step i+1 loads while step i is multiplied.  S^T = K Q^T
//     and dP^T = V dO^T take their B fragments from the Q and dO tiles by
//     ldmatrix; P^T = exp2(S^T scale log2(e) - lse log2(e)) and
//     dS^T = P^T (dP^T - delta) are computed on the accumulator fragments
//     and masked there; dv += P^T dO and dk += dS^T Q take their B fragments
//     from the same tiles by ldmatrix.trans.
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
//   - At (DQK, DV) = (192, 128) a warp's 16 keys would hold 96 registers of
//     dk and 64 of dv, 160 before the S^T and dP^T fragments, where the
//     D=128 kernel already sits at the 255 cap.  So kernel 2 runs as two
//     launches of one template, each over every key tile: a dv pass (S^T
//     and P^T, dv += P^T dO: no V, no dP) and a dk pass (S^T, dP^T, dS^T,
//     dk += dS^T Q), which recomputes S^T: one more product of the DQK
//     width, 11 units where the bound counts 5.  Each pass holds one
//     accumulator and takes 32 query rows a step.  Kernel 3 at 192 holds 96
//     registers of dq, so it takes a 64-key tile in two halves of 32 keys
//     (S, dP, dS and dq += dS K for each half), keeping 16 registers each of
//     S and dP fragments where 64 keys would take 32 (the dk pass holds 246
//     registers, the dv pass 168, kernel 3 255, none spilling).  Shared
//     memory: each pass of kernel 2 takes 87 KB a block (the dv pass leaves
//     V's tile empty), kernel 3 129 KB; past the 48 KB default, they opt
//     in.
//   - dk, dv and dq stay in f32 registers and are scaled and rounded to
//     bf16 once, at the end.
//
// f32 (the 2e-4 check; TF32 would break it): the CUDA-core design of the
// first version.  Each tile step computes S and dP on a 64 x 64 tile, a
// thread owning a 4 x 4 register tile of rows ti + 16 a and keys tj + 16 b,
// so a shared row stride of D + 1 floats keeps a warp's 16 key rows in 16
// banks; P and dS go through shared memory (stride 65) into the second
// products, where a thread owns 4 keys (or rows) by D / 16 dims (DQK / 16
// of dk and dq, DV / 16 of dv).  Every product is an f32 FMA on the CUDA
// cores, and tiles load synchronously; at 192 / 128 a block's tiles take
// 194 KB (dk/dv) and 177 KB (dq) of shared memory, one block an SM.
//
// Every (D, D) pair is the same arithmetic, and so the same bits, as
// before DV and SKV were parameters: the widths and the keys' length enter
// only the row strides, offsets, loop bounds and masks.
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

// a 64-row f32 tile of D-wide rows in shared memory, row stride D + 1
template <int D>
struct Row {
  static constexpr int kRow = D + 1;
  static constexpr int kTile = kB * kRow;
};

template <int DQK, int DV>
struct Bwd {
  // dk/dv: K, V, Q, dO tiles, P and dS, lse and delta of the query tile
  static constexpr size_t kSmemKV =
      (2 * Row<DQK>::kTile + 2 * Row<DV>::kTile + 2 * kB * kPadS + 2 * kB) *
      sizeof(float);
  // dq: Q, dO, K, V tiles, dS, lse and delta
  static constexpr size_t kSmemQ =
      (2 * Row<DQK>::kTile + 2 * Row<DV>::kTile + kB * kPadS + 2 * kB) *
      sizeof(float);
};

// rows [row0, row0 + 64) of an [n, D] matrix into an f32 shared tile of
// row stride D + 1, zero past n
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int n) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    const int row = row0 + r;
    dst[r * Row<D>::kRow + c] =
        row < n ? src[(long long)row * D + c] : 0.f;
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
// and dP = dO V^T, then P = exp(scale S - lse) (0 where masked, past s or
// past skv) into `ps` (unless null) and dS = P (dP - delta) into `dss`, both
// [row][key] with stride kPadS.  Thread (ti, tj) owns rows ti + 16 a and
// keys tj + 16 b.
template <int DQK, int DV>
__device__ __forceinline__ void score_tile(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* delta_s, int q0, int k0, int s,
    int skv, int causal, float scale, float* ps, float* dss) {
  constexpr int RQ = Row<DQK>::kRow;
  constexpr int RV = Row<DV>::kRow;
  const int ti = threadIdx.x / 16;
  const int tj = threadIdx.x % 16;
  float sa[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) sa[a][b] = dp[a][b] = 0.f;
  if constexpr (DQK == DV) {
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qa[a] = qs[(ti + 16 * a) * RQ + d];
        oa[a] = dos[(ti + 16 * a) * RV + d];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        kb[b] = ks[(tj + 16 * b) * RQ + d];
        vb[b] = vs[(tj + 16 * b) * RV + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          sa[a][b] = fmaf(qa[a], kb[b], sa[a][b]);
          dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
        }
    }
  } else {
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qs[(ti + 16 * a) * RQ + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = ks[(tj + 16 * b) * RQ + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) sa[a][b] = fmaf(qa[a], kb[b], sa[a][b]);
    }
#pragma unroll 4
    for (int d = 0; d < DV; ++d) {
      float oa[4], vb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) oa[a] = dos[(ti + 16 * a) * RV + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) vb[b] = vs[(tj + 16 * b) * RV + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
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
      const bool live = row < s && key < skv && !(causal && key > row);
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

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int h,
                          int kvh, int s, int skv, float scale, int causal) {
  constexpr int RQ = Row<DQK>::kRow;
  constexpr int RV = Row<DV>::kRow;
  constexpr int kDPerQK = DQK / 16;  // dims of dk per thread
  constexpr int kDPerV = DV / 16;    // dims of dv per thread (<= kDPerQK)
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + Row<DQK>::kTile;
  float* qs = vs + Row<DV>::kTile;
  float* dos = qs + Row<DQK>::kTile;
  float* ps = dos + Row<DV>::kTile;
  float* dss = ps + kB * kPadS;
  float* lse_s = dss + kB * kPadS;
  float* delta_s = lse_s + kB;

  const int bk = blockIdx.x;  // b * kvh + kv head
  const int b = bk / kvh;
  const int kv_head = bk % kvh;
  const int G = h / kvh;
  const int kt = blockIdx.y;  // the first key tiles see the most queries
  const int k0 = kt * kB;
  const long long k_base = (long long)bk * skv * DQK;
  const long long v_base = (long long)bk * skv * DV;
  load_tile<DQK>(ks, k + k_base, k0, skv);
  load_tile<DV>(vs, v + v_base, k0, skv);

  // thread (tj, td) owns keys tj + 16 c and dims td + 16 e
  const int tj = threadIdx.x % 16;
  const int td = threadIdx.x / 16;
  float dk_acc[4][kDPerQK], dv_acc[4][kDPerQK];  // dv: e < kDPerV
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int e = 0; e < kDPerQK; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;

  const int n_qt = (s + kB - 1) / kB;
  for (int g = 0; g < G; ++g) {
    const long long bh = (long long)b * h + kv_head * G + g;
    const float* qg = q + bh * s * DQK;
    const float* dog = dout + bh * s * DV;
    for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // every thread is done with the previous tile
      load_tile<DQK>(qs, qg, q0, s);
      load_tile<DV>(dos, dog, q0, s);
      load_rows(lse_s, delta_s, lse + bh * s, delta + bh * s, q0, s);
      __syncthreads();
      score_tile<DQK, DV>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, s, skv,
                          causal, scale, ps, dss);
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
        for (int e = 0; e < kDPerQK; ++e) {
          const bool with_v = e < kDPerV;
          const float o_ie = with_v ? dos[i * RV + td + 16 * e] : 0.f;
          const float q_ie = qs[i * RQ + td + 16 * e];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (with_v) dv_acc[c][e] = fmaf(pc[c], o_ie, dv_acc[c][e]);
            dk_acc[c][e] = fmaf(sc[c], q_ie, dk_acc[c][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int key = k0 + tj + 16 * c;
    if (key >= skv) continue;
#pragma unroll
    for (int e = 0; e < kDPerQK; ++e) {
      dk[k_base + (long long)key * DQK + td + 16 * e] = dk_acc[c][e] * scale;
      if (e < kDPerV)
        dv[v_base + (long long)key * DV + td + 16 * e] = dv_acc[c][e];
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int h, int kvh, int s,
                        int skv, float scale, int causal) {
  constexpr int RQ = Row<DQK>::kRow;
  constexpr int kDPer = DQK / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + Row<DQK>::kTile;
  float* ks = dos + Row<DV>::kTile;
  float* vs = ks + Row<DQK>::kTile;
  float* dss = vs + Row<DV>::kTile;
  float* lse_s = dss + kB * kPadS;
  float* delta_s = lse_s + kB;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = qt * kB;
  const int b = bh / h;
  const int kv_head = (bh % h) / (h / kvh);
  const long long q_base = (long long)bh * s * DQK;
  const long long o_base = (long long)bh * s * DV;
  const long long kv_row0 = ((long long)b * kvh + kv_head) * skv;
  load_tile<DQK>(qs, q + q_base, q0, s);
  load_tile<DV>(dos, dout + o_base, q0, s);
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

  const int n_kt = causal ? qt + 1 : (skv + kB - 1) / kB;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // every thread is done with the previous tile
    load_tile<DQK>(ks, k + kv_row0 * DQK, k0, skv);
    load_tile<DV>(vs, v + kv_row0 * DV, k0, skv);
    __syncthreads();
    score_tile<DQK, DV>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, s, skv,
                        causal, scale, nullptr, dss);
    __syncthreads();
    // dq += dS K
    for (int j = 0; j < kB; ++j) {
      float sa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = dss[(ti + 16 * a) * kPadS + j];
#pragma unroll
      for (int e = 0; e < kDPer; ++e) {
        const float k_je = ks[j * RQ + td + 16 * e];
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
      dq[q_base + (long long)row * DQK + td + 16 * e] = dq_acc[a][e] * scale;
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

unsigned int n_tiles(int n) { return (unsigned int)((n + kB - 1) / kB); }

// delta over B * H * S rows of o and dO, DV wide
template <typename T, int DV>
int launch_delta(const void* o, const void* dout, float* delta, int b,
                 int h, int s, cudaStream_t stream) {
  const long long rows = (long long)b * h * s;
  const int per_block = kThreads / 32;
  attention_bwd_delta_kernel<T, DV>
      <<<(unsigned int)((rows + per_block - 1) / per_block), kThreads, 0,
         stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                   delta, rows);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int b, int h, int kvh, int s, int skv,
               float scale, int causal, cudaStream_t stream) {
  using Sh = Bwd<DQK, DV>;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  int err = launch_delta<float, DV>(o, dout, delta, b, h, s, stream);
  if (err != 0) return err;

  auto dkdv = attention_bwd_dkdv_kernel<DQK, DV>;
  if ((err = allow_smem(dkdv, Sh::kSmemKV)) != 0) return err;
  dkdv<<<dim3((unsigned int)(b * kvh), n_tiles(skv)), kThreads, Sh::kSmemKV,
         stream>>>(qt, kt, vt, dot, lse, delta, static_cast<float*>(dk),
                   static_cast<float*>(dv), h, kvh, s, skv, scale, causal);
  if ((err = (int)cudaGetLastError()) != 0) return err;

  auto dqk = attention_bwd_dq_kernel<DQK, DV>;
  if ((err = allow_smem(dqk, Sh::kSmemQ)) != 0) return err;
  dqk<<<dim3((unsigned int)(b * h), n_tiles(s)), kThreads, Sh::kSmemQ,
        stream>>>(qt, kt, vt, dot, lse, delta, static_cast<float*>(dq), h,
                  kvh, s, skv, scale, causal);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bf16: tensor-core path
using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;                 // 16 keys (dk/dv) or rows (dq) each
constexpr int kMmaThreads = kWarps * 32;
constexpr int kPad = 8;                   // bf16 of padding per shared row
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kB == kWarps * 16, "a warp per 16 rows of a tile");

// the row stride (bf16) of a padded shared tile of D-wide rows
template <int D>
struct MmaRow {
  static constexpr int kRow = D + kPad;
};

// what kernel 2 computes in one launch: both gradients (DQK == DV), or
// one of them (the two passes at DQK != DV)
enum Part { kBoth = 0, kDvPass = 1, kDkPass = 2 };

template <int DQK, int DV>
struct MmaBwd {
  static_assert(DQK >= DV, "the pairs have DQK >= DV");
  static constexpr int kTileQK = kB * MmaRow<DQK>::kRow;  // 64 rows (bf16)
  static constexpr int kTileV = kB * MmaRow<DV>::kRow;
  static constexpr bool kHold = DQK <= 64;         // A fragments in registers
  static constexpr bool kTwoPasses = DQK != DV;    // kernel 2 as two passes
  static constexpr int kQRows = DQK <= 64 ? kB : kB / 2;  // rows of a step
  static constexpr int kQTileQK = kQRows * MmaRow<DQK>::kRow;
  static constexpr int kQTileV = kQRows * MmaRow<DV>::kRow;
  static constexpr int kKeys = DQK == DV ? kB : kB / 2;   // dq: keys a part
  // dk/dv: K, V, then two stages of Q and dO, two of lse and delta
  static constexpr size_t kSmemKV =
      (kTileQK + kTileV + 2 * kQTileQK + 2 * kQTileV) * sizeof(bf16) +
      4 * kQRows * sizeof(float);
  // dq: Q, dO, then two stages of K and two of V
  static constexpr size_t kSmemQ = 3 * (kTileQK + kTileV) * sizeof(bf16);
};
static_assert(MmaBwd<64, 64>::kSmemQ == 6 * kB * (64 + kPad) * sizeof(bf16),
              "the (D, D) layouts are those of one width");

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

// rows [row0, row0 + ROWS) of an [n, D] matrix into a padded shared tile,
// asynchronously, zero past n
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int row0, int n) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * kChunks % kMmaThreads == 0, "whole rounds");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kMmaThreads; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool ok = row0 + r < n;
    cp_async16(smem_addr(dst + r * MmaRow<D>::kRow + c * 8),
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
// a padded tile of D-wide rows.
template <int D>
__device__ __forceinline__ void load_a(const bf16* tile, int row0, int ks,
                                       unsigned a[4]) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(smem_addr(tile + (row0 + (lane & 15)) * MmaRow<D>::kRow +
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
                        (n0 + (lane & 7) + (lane >> 4) * 8) * MmaRow<D>::kRow +
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
                (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * MmaRow<D>::kRow +
                dp * 16 + (lane >> 4) * 8),
      b);
}

// An accumulator as the A operand of a second product: k-step j / 2 takes
// n-tiles j = 2 kk and 2 kk + 1, and the pair of n-tile j in fragment row
// g + 8 r (elements 2 r, 2 r + 1) is its register a_reg(j, r).
__device__ __forceinline__ int a_reg(int j, int r) { return 2 * (j & 1) + r; }

// Kernel 2 for one PART: kBoth takes dk and dv (DQK == DV), kDvPass dv
// alone (S^T, no V and no dP^T), kDkPass dk alone.
template <int DQK, int DV, int PART>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int h, int kvh, int s, int skv, float scale,
                              float scale_log2, int causal) {
  using Sh = MmaBwd<DQK, DV>;
  constexpr bool kWantDv = PART != kDkPass;
  constexpr bool kWantDk = PART != kDvPass;
  static_assert(PART == kBoth || Sh::kTwoPasses, "one pass at DQK == DV");
  constexpr int kQRows = Sh::kQRows;
  constexpr int kKStepsQK = DQK / 16;    // k-steps of S^T
  constexpr int kKStepsV = DV / 16;      // k-steps of dP^T
  constexpr int kNTiles = kQRows / 8;    // n-tiles of S^T (query rows)
  constexpr int kRSteps = kQRows / 16;   // k-steps of dv and dk
  constexpr int kDTilesQK = DQK / 8;     // n-tiles of dk
  constexpr int kDTilesV = DV / 8;       // n-tiles of dv
  constexpr int kHeld = Sh::kHold ? kKStepsQK : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + Sh::kTileQK;
  bf16* sq = sv + Sh::kTileV;               // stages 0, 1
  bf16* sdo = sq + 2 * Sh::kQTileQK;        // stages 0, 1
  float* slse = reinterpret_cast<float*>(sdo + 2 * Sh::kQTileV);
  float* sdelta = slse + 2 * kQRows;

  const int bk = blockIdx.x;  // b * kvh + kv head
  const int b = bk / kvh;
  const int kv_head = bk % kvh;
  const int G = h / kvh;
  const int k0 = blockIdx.y * kB;  // the first key tiles see the most rows
  const long long k_base = (long long)bk * skv * DQK;
  const long long v_base = (long long)bk * skv * DV;

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
    load_tile_async<DQK, kQRows>(sq + stage * Sh::kQTileQK,
                                 q + bh * s * DQK, q0, s);
    load_tile_async<DV, kQRows>(sdo + stage * Sh::kQTileV,
                                dout + bh * s * DV, q0, s);
    load_rows_async<kQRows>(slse + stage * kQRows, sdelta + stage * kQRows,
                            lse + bh * s, delta + bh * s, q0, s);
  };
  load_tile_async<DQK, kB>(sk, k + k_base, k0, skv);
  if constexpr (kWantDk) load_tile_async<DV, kB>(sv, v + v_base, k0, skv);
  load_step(0, 0);
  cp_async_commit();

  unsigned kf[kHeld][4], vf[kHeld][4];
  // one pass leaves the other's accumulators unused (and unallocated)
  float dk_acc[kDTilesQK][4], dv_acc[kDTilesV][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int n = 0; n < kDTilesQK; ++n) dk_acc[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < kDTilesV; ++n) dv_acc[n][e] = 0.f;
  }

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
        load_a<DQK>(sk, wkey, ks, kf[ks]);
        load_a<DV>(sv, wkey, ks, vf[ks]);
      }
    }
    const bf16* q_s = sq + stage * Sh::kQTileQK;
    const bf16* do_s = sdo + stage * Sh::kQTileV;
    const float* lse_s = slse + stage * kQRows;
    const float* delta_s = sdelta + stage * kQRows;
    const int q0 = (qt0 + i % per_head) * kQRows;

    // S^T = K Q^T (over DQK) and dP^T = V dO^T (over DV) for the warp's
    // 16 keys
    float sacc[kNTiles][4], dpacc[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = dpacc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKStepsQK; ++ks) {
      const bool dp_step = kWantDk && ks < kKStepsV;
      unsigned ka[4], va[4];
      if constexpr (Sh::kHold) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ka[r] = kf[ks][r];
          va[r] = vf[ks][r];
        }
      } else {
        load_a<DQK>(sk, wkey, ks, ka);
        if (dp_step) load_a<DV>(sv, wkey, ks, va);
      }
#pragma unroll
      for (int jp = 0; jp < kNTiles / 2; ++jp) {
        unsigned bf[4];
        load_b<DQK>(q_s, jp * 16, ks, bf);
        mma_bf16(sacc[2 * jp], ka, bf[0], bf[1]);
        mma_bf16(sacc[2 * jp + 1], ka, bf[2], bf[3]);
        if (dp_step) {
          load_b<DV>(do_s, jp * 16, ks, bf);
          mma_bf16(dpacc[2 * jp], va, bf[0], bf[1]);
          mma_bf16(dpacc[2 * jp + 1], va, bf[2], bf[3]);
        }
      }
    }

    // P^T and dS^T on the fragments: element e of n-tile j is key
    // k0 + wkey + g + 8 (e >> 1), query row q0 + 8 j + 2 tig + (e & 1)
    const bool masked = q0 + kQRows > s || k0 + kB > skv ||
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
            if (row >= s || key >= skv || (causal && key > row)) pe = 0.f;
          }
          p[x] = pe;
          if constexpr (kWantDk) ds[x] = pe * (dpacc[j][e] - dl[x]);
        }
        if constexpr (kWantDv)
          split_bf16(p[0], p[1], p_hi[j >> 1][a_reg(j, r)],
                     p_lo[j >> 1][a_reg(j, r)]);
        if constexpr (kWantDk)
          split_bf16(ds[0], ds[1], ds_hi[j >> 1][a_reg(j, r)],
                     ds_lo[j >> 1][a_reg(j, r)]);
      }
    }

    // dv += P^T dO, dk += dS^T Q, each in two parts
#pragma unroll
    for (int kk = 0; kk < kRSteps; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kDTilesQK / 2; ++dp) {
        unsigned bf[4];
        if (kWantDv && dp < kDTilesV / 2) {
          load_bt<DV>(do_s, kk * 16, dp, bf);
          mma_bf16(dv_acc[2 * dp], p_hi[kk], bf[0], bf[1]);
          mma_bf16(dv_acc[2 * dp], p_lo[kk], bf[0], bf[1]);
          mma_bf16(dv_acc[2 * dp + 1], p_hi[kk], bf[2], bf[3]);
          mma_bf16(dv_acc[2 * dp + 1], p_lo[kk], bf[2], bf[3]);
        }
        if constexpr (kWantDk) {
          load_bt<DQK>(q_s, kk * 16, dp, bf);
          mma_bf16(dk_acc[2 * dp], ds_hi[kk], bf[0], bf[1]);
          mma_bf16(dk_acc[2 * dp], ds_lo[kk], bf[0], bf[1]);
          mma_bf16(dk_acc[2 * dp + 1], ds_hi[kk], bf[2], bf[3]);
          mma_bf16(dk_acc[2 * dp + 1], ds_lo[kk], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // element e of n-tile n: key k0 + wkey + g + 8 (e >> 1), dims
  // 8 n + 2 tig + (e & 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wkey + g + 8 * r;
    if (key >= skv) continue;
#pragma unroll
    for (int n = 0; n < kDTilesQK; ++n) {
      if constexpr (kWantDk)
        *reinterpret_cast<unsigned*>(dk + k_base + (long long)key * DQK +
                                     n * 8 + 2 * tig) =
            pack_bf16(dk_acc[n][2 * r] * scale,
                      dk_acc[n][2 * r + 1] * scale);
      if (kWantDv && n < kDTilesV)
        *reinterpret_cast<unsigned*>(dv + v_base + (long long)key * DV +
                                     n * 8 + 2 * tig) =
            pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dq, int h, int kvh, int s,
                            int skv, float scale, float scale_log2,
                            int causal) {
  using Sh = MmaBwd<DQK, DV>;
  constexpr int kKStepsQK = DQK / 16;  // k-steps of S
  constexpr int kKStepsV = DV / 16;    // k-steps of dP
  constexpr int kKeys = Sh::kKeys;     // keys of a part of the tile
  constexpr int kNTiles = kKeys / 8;   // n-tiles of S (keys) in a part
  constexpr int kDTiles = DQK / 8;     // n-tiles of dq
  constexpr int kHeld = Sh::kHold ? kKStepsQK : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + Sh::kTileQK;
  bf16* sk = sdo + Sh::kTileV;        // stages 0, 1
  bf16* sv = sk + 2 * Sh::kTileQK;    // stages 0, 1

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;  // heaviest first
  const int b = bh / h;
  const int kv_head = (bh % h) / (h / kvh);
  const long long q_base = (long long)bh * s * DQK;
  const long long o_base = (long long)bh * s * DV;
  const long long kv_row0 = ((long long)b * kvh + kv_head) * skv;
  const bf16* kg = k + kv_row0 * DQK;
  const bf16* vg = v + kv_row0 * DV;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tig = lane & 3;  // fragment column pair: keys
  const int wrow = warp * 16;

  const int q_last = min(q0 + kB, s) - 1;
  const int n_kt = causal ? q_last / kB + 1 : (skv + kB - 1) / kB;

  load_tile_async<DQK, kB>(sq, q + q_base, q0, s);
  load_tile_async<DV, kB>(sdo, dout + o_base, q0, s);
  load_tile_async<DQK, kB>(sk, kg, 0, skv);
  load_tile_async<DV, kB>(sv, vg, 0, skv);
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
      load_tile_async<DQK, kB>(sk + (stage ^ 1) * Sh::kTileQK, kg,
                               (kt + 1) * kB, skv);
      load_tile_async<DV, kB>(sv + (stage ^ 1) * Sh::kTileV, vg,
                              (kt + 1) * kB, skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and at kt == 0 the Q and dO tiles) landed
    if (Sh::kHold && kt == 0) {
#pragma unroll
      for (int ks = 0; ks < kHeld; ++ks) {
        load_a<DQK>(sq, wrow, ks, qf[ks]);
        load_a<DV>(sdo, wrow, ks, of[ks]);
      }
    }
    const bf16* k_s = sk + stage * Sh::kTileQK;
    const bf16* v_s = sv + stage * Sh::kTileV;
    const int k0 = kt * kB;
    const bool masked = q0 + kB > s || k0 + kB > skv ||
                        (causal && k0 + kB - 1 > q0 + wrow);

    // the tile's keys in parts of kKeys (one part at DQK == DV); the two
    // parts at 192 stay a loop: unrolled, the dq kernel spilled 40 bytes
    // at the 255-register cap and ran 3 % slower
#pragma unroll 1
    for (int kc = 0; kc < kB; kc += kKeys) {
      // S = Q K^T and dP = dO V^T for the warp's 16 rows
      float sacc[kNTiles][4], dpacc[kNTiles][4];
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = dpacc[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKStepsQK; ++ks) {
        const bool dp_step = ks < kKStepsV;
        unsigned qa[4], oa[4];
        if constexpr (Sh::kHold) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            qa[r] = qf[ks][r];
            oa[r] = of[ks][r];
          }
        } else {
          load_a<DQK>(sq, wrow, ks, qa);
          if (dp_step) load_a<DV>(sdo, wrow, ks, oa);
        }
#pragma unroll
        for (int jp = 0; jp < kNTiles / 2; ++jp) {
          unsigned bf[4];
          load_b<DQK>(k_s, kc + jp * 16, ks, bf);
          mma_bf16(sacc[2 * jp], qa, bf[0], bf[1]);
          mma_bf16(sacc[2 * jp + 1], qa, bf[2], bf[3]);
          if (dp_step) {
            load_b<DV>(v_s, kc + jp * 16, ks, bf);
            mma_bf16(dpacc[2 * jp], oa, bf[0], bf[1]);
            mma_bf16(dpacc[2 * jp + 1], oa, bf[2], bf[3]);
          }
        }
      }

      // dS on the fragments: element e of n-tile j is row
      // q0 + wrow + g + 8 (e >> 1), key k0 + kc + 8 j + 2 tig + (e & 1)
      unsigned ds_hi[kKeys / 16][4], ds_lo[kKeys / 16][4];
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
              const int key = k0 + kc + 8 * j + 2 * tig + x;
              if (row >= s || key >= skv || (causal && key > row)) pe = 0.f;
            }
            ds[x] = pe * (dpacc[j][e] - dl[r]);
          }
          split_bf16(ds[0], ds[1], ds_hi[j >> 1][a_reg(j, r)],
                     ds_lo[j >> 1][a_reg(j, r)]);
        }
      }

      // dq += dS K, in two parts
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
        for (int dp = 0; dp < kDTiles / 2; ++dp) {
          unsigned bf[4];
          load_bt<DQK>(k_s, kc + kk * 16, dp, bf);
          mma_bf16(dq_acc[2 * dp], ds_hi[kk], bf[0], bf[1]);
          mma_bf16(dq_acc[2 * dp], ds_lo[kk], bf[0], bf[1]);
          mma_bf16(dq_acc[2 * dp + 1], ds_hi[kk], bf[2], bf[3]);
          mma_bf16(dq_acc[2 * dp + 1], ds_lo[kk], bf[2], bf[3]);
        }
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
      *reinterpret_cast<unsigned*>(dq + q_base + (long long)row * DQK +
                                   n * 8 + 2 * tig) =
          pack_bf16(dq_acc[n][2 * r] * scale, dq_acc[n][2 * r + 1] * scale);
  }
}

template <int DQK, int DV, int PART>
int launch_dkdv_mma(const bf16* q, const bf16* k, const bf16* v,
                    const bf16* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int b, int h, int kvh, int s, int skv,
                    float scale, float scale_log2, int causal,
                    cudaStream_t stream) {
  using Sh = MmaBwd<DQK, DV>;
  auto kernel = attention_bwd_dkdv_mma_kernel<DQK, DV, PART>;
  int err = allow_smem(kernel, Sh::kSmemKV);
  if (err != 0) return err;
  kernel<<<dim3((unsigned int)(b * kvh), n_tiles(skv)), kMmaThreads,
           Sh::kSmemKV, stream>>>(q, k, v, dout, lse, delta,
                                  static_cast<bf16*>(dk),
                                  static_cast<bf16*>(dv), h, kvh, s, skv,
                                  scale, scale_log2, causal);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_mma(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int b, int h, int kvh, int s, int skv,
               float scale, int causal, cudaStream_t stream) {
  using Sh = MmaBwd<DQK, DV>;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float scale_log2 = scale * kLog2e;
  int err = launch_delta<bf16, DV>(o, dout, delta, b, h, s, stream);
  if (err != 0) return err;

  if constexpr (Sh::kTwoPasses) {
    err = launch_dkdv_mma<DQK, DV, kDvPass>(qt, kt, vt, dot, lse, delta, dk,
                                            dv, b, h, kvh, s, skv, scale,
                                            scale_log2, causal, stream);
    if (err != 0) return err;
    err = launch_dkdv_mma<DQK, DV, kDkPass>(qt, kt, vt, dot, lse, delta, dk,
                                            dv, b, h, kvh, s, skv, scale,
                                            scale_log2, causal, stream);
  } else {
    err = launch_dkdv_mma<DQK, DV, kBoth>(qt, kt, vt, dot, lse, delta, dk,
                                          dv, b, h, kvh, s, skv, scale,
                                          scale_log2, causal, stream);
  }
  if (err != 0) return err;

  auto dqk = attention_bwd_dq_mma_kernel<DQK, DV>;
  if ((err = allow_smem(dqk, Sh::kSmemQ)) != 0) return err;
  dqk<<<dim3((unsigned int)(b * h), n_tiles(s)), kMmaThreads, Sh::kSmemQ,
        stream>>>(qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), h,
                  kvh, s, skv, scale, scale_log2, causal);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int b, int h, int kvh, int s, int skv,
             int dqk, int d_v, int dtype, float scale, int causal,
             cudaStream_t st) {
#define REPRO_BWD_CASE(DQK, DV)                                             \
  if (dqk == DQK && d_v == DV)                                              \
    return dtype == 0                                                       \
               ? launch_f32<DQK, DV>(q, k, v, o, dout, lse, delta, dq, dk,  \
                                     dv, b, h, kvh, s, skv, scale, causal,  \
                                     st)                                    \
               : launch_mma<DQK, DV>(q, k, v, o, dout, lse, delta, dq, dk,  \
                                     dv, b, h, kvh, s, skv, scale, causal,  \
                                     st);
  REPRO_BWD_CASE(32, 32)
  REPRO_BWD_CASE(64, 64)
  REPRO_BWD_CASE(128, 128)
  REPRO_BWD_CASE(192, 128)
#undef REPRO_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches the three kernels (four at 192 / 128) on `stream` and returns
// cudaGetLastError(); never synchronises.  dtype: 0 = float32 (CUDA-core
// kernels), 1 = bfloat16 (tensor-core kernels) for q, k, v, o, dO and the
// three gradients.  s: q's, o's and dO's length; skv: k's and v's, which
// must equal s when causal.  (dqk, d_v): q's and k's width, and v's, o's
// and dO's, one of the pairs above.  `delta` is f32 scratch of B * H * S
// floats.  Every tensor is contiguous, and q, k, v and dO are 16-byte
// aligned (the wrapper checks).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int b, int h, int kvh, int s, int skv,
                                   int dqk, int d_v, int dtype, int causal,
                                   float scale, void* stream) {
  if (b < 1 || h < 1 || kvh < 1 || s < 1 || skv < 1 || h % kvh != 0 ||
      (causal && skv != s) || (long long)b * h > 0x7fffffffLL ||
      ((long long)s + kB - 1) / kB > 65535 ||
      ((long long)skv + kB - 1) / kB > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return dispatch(q, k, v, o, dout, static_cast<const float*>(lse),
                  static_cast<float*>(delta), dq, dk, dv, b, h, kvh, s, skv,
                  dqk, d_v, dtype, scale, causal,
                  static_cast<cudaStream_t>(stream));
}
