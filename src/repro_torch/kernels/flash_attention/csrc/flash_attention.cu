// Forward GQA attention with an online softmax for Hopper (sm_90a): the
// prefill attention of every layer of the LM serving path.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention/flash.py).  Same contract:
//   q [B, H, S, D], k and v [B, KV, S, D], H % KV == 0, f32 or bf16
//   o [B, H, S, D] in q's type, o = softmax(q k^T / sqrt(D)) v per head,
// query head bh reading KV head bh / (H / KV) (K and V are never
// replicated), keys after the query masked with -1e30 when causal, the
// softmax sum clamped to 1e-30 before the divide.
//
// Bound: at the serving shapes it is bytes (q, k, v read once and o written
// once: 12.6 MB at B=8, S=512 and smollm's 9/3 heads, 3.8 us at 3.35 TB/s)
// or, for long prompts, the causal S^2 D products (19 GFLOP at S=4096,
// 20 us at the bf16 tensor-core rate).
//
// The TPU kernel walks the KV blocks as the sequential innermost grid axis
// and keeps (m, l, acc) in VMEM scratch across grid steps.  Here one thread
// block owns one (batch * head, 64-row query tile) and walks the 64-key KV
// tiles in a loop with every running statistic in registers.  Under
// `causal`, tiles wholly after the tile's last query row are never loaded
// (the loop ends at the diagonal tile, whose later keys are masked by
// index), and the heaviest query tiles are scheduled first.  Any S: rows of
// a ragged last tile are zero-filled and masked as keys, and not written as
// queries.  The two dtypes take two kernels.
//
// bf16 (the serving path): tensor cores.  A block is 4 warps; each warp
// owns 16 query rows and issues mma.sync.m16n8k16 on bf16 with f32
// accumulators, for S = Q K^T and for O += P V:
//   - Q's A fragments are loaded once with ldmatrix; K's B fragments with
//     ldmatrix, V's with ldmatrix.trans, from bf16 tiles in shared memory;
//   - K and V tiles stay bf16 and go through a 2-stage ring filled by
//     16-byte cp.async (src-size 0 zero-fills rows >= S), so tile j+1 loads
//     while tile j is multiplied; each shared row is padded by 16 bytes,
//     which puts the 8 rows of every ldmatrix in 8 distinct bank groups;
//   - the online softmax runs on the accumulator fragments: a thread holds
//     two rows' scores, the row max and the row sum take two xor shuffles
//     across the quad; exp2f with log2(e)/sqrt(D) folded into the scale;
//   - P goes from the S accumulators straight into the A fragments of the
//     PV product, in registers, split into two bf16 parts P_hi + P_lo that
//     take one product each (50 % more tensor-core work than P_hi alone,
//     and ~16 bits of P kept): with P rounded to bf16 alone the bf16
//     prefill logits of the 30-layer serving model came barely inside
//     their 5e-2 gate against the plain attention
//     (scripts/torch_kernel_probe.py measures both roundings); the row sum
//     l adds the f32 P;
//   - the output tile is staged in the warp's own rows of the Q tile and
//     written as 16-byte chunks of rows < S.
// Registers stay under the 255 of __launch_bounds__(128); at D=64 a block
// takes 45 KB of shared memory, so several blocks share an SM.
//
// f32 (the 2e-5 check; TF32 would break it): the CUDA-core design of the
// first version.  D / 16 threads share a query row, each owning 16 of its
// dims as four float4 chunks interleaved across the row's threads; a 64-key
// K and V tile is staged in shared memory as f32; per key each thread forms
// its partial dot product and the row's threads sum it with xor shuffles;
// then one max, one rescale of (l, acc) and the probabilities times V.
// Arithmetic is f32 throughout, with expf (not __expf) and an IEEE divide.
//
// The build uses no --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per thread block
constexpr int kBKV = 64;         // keys per staged K/V tile
constexpr int kDimsPerThread = 16;
constexpr int kChunks = kDimsPerThread / 4;  // float4 chunks per thread
constexpr float kNegInf = -1e30f;

template <int D>
struct Shape {
  static constexpr int kTPR = D / kDimsPerThread;  // threads per query row
  static constexpr int kThreads = kBQ * kTPR;
  static constexpr size_t kSmem = 2 * kBKV * D * sizeof(float);
};

// ------------------------------------------------ f32: CUDA-core path
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  // four values from global memory
  static __device__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  // one 16-byte global load -> 4 floats in shared memory
  static constexpr int kPer16 = 4;
  static __device__ void load16(const float* src, float* dst) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int h, int kvh, int s,
                       float scale, int causal) {
  constexpr int kTPR = Shape<D>::kTPR;
  constexpr int kThreads = Shape<D>::kThreads;
  constexpr int kPer16 = Elem<T>::kPer16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + kBKV * D;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = bh / h;
  const int kv_head = (bh % h) / (h / kvh);
  const long long q_base = (long long)bh * s * D;
  const long long kv_base = ((long long)b * kvh + kv_head) * s * D;

  const int tid = threadIdx.x;
  const int r = tid / kTPR;  // query row within the tile
  const int t = tid % kTPR;  // this thread's share of the row
  const int qpos = qt * kBQ + r;
  const bool row_ok = qpos < s;

  float qr[kDimsPerThread];
  float acc[kDimsPerThread];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d0 = (c * kTPR + t) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_ok) x = Elem<T>::load4(q + q_base + (long long)qpos * D + d0);
    qr[4 * c] = x.x;
    qr[4 * c + 1] = x.y;
    qr[4 * c + 2] = x.z;
    qr[4 * c + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) acc[i] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  const int q_last = min(qt * kBQ + kBQ, s) - 1;
  const int n_kt = causal ? q_last / kBKV + 1 : (s + kBKV - 1) / kBKV;
  constexpr int kVecs = kBKV * D / kPer16;  // 16-byte loads per full tile
  for (int kt = 0; kt < n_kt; ++kt) {
    const int j0 = kt * kBKV;
    const int valid = min(kBKV, s - j0) * D / kPer16;
    const T* kg = k + kv_base + (long long)j0 * D;
    const T* vg = v + kv_base + (long long)j0 * D;
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < kVecs; i += kThreads) {
      float* kd = ks + i * kPer16;
      float* vd = vs + i * kPer16;
      if (i < valid) {
        Elem<T>::load16(kg + (long long)i * kPer16, kd);
        Elem<T>::load16(vg + (long long)i * kPer16, vd);
      } else {
#pragma unroll
        for (int e = 0; e < kPer16; e += 4) {
          *reinterpret_cast<float4*>(kd + e) = make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(vd + e) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    __syncthreads();

    // scores of this tile: sc[j] = q . k_j * scale, masked to -1e30
    float sc[kBKV];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBKV; ++j) {
      const float* kr = ks + j * D;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(kr + (c * kTPR + t) * 4);
        dot = fmaf(qr[4 * c], kk.x, dot);
        dot = fmaf(qr[4 * c + 1], kk.y, dot);
        dot = fmaf(qr[4 * c + 2], kk.z, dot);
        dot = fmaf(qr[4 * c + 3], kk.w, dot);
      }
#pragma unroll
      for (int off = kTPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      float sv = dot * scale;
      const int kpos = j0 + j;
      if (kpos >= s || (causal && kpos > qpos)) sv = kNegInf;
      sc[j] = sv;
      mx = fmaxf(mx, sv);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBKV; ++j) {
      sc[j] = expf(sc[j] - m_new);
      psum += sc[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBKV; ++j) {
      const float* vr = vs + j * D;
      const float p = sc[j];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(vr + (c * kTPR + t) * 4);
        acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (!row_ok) return;
  const float denom = fmaxf(l, 1e-30f);
  if (lse != nullptr && t == 0)  // natural log of the scaled scores
    lse[(long long)bh * s + qpos] = m + logf(denom);
  T* orow = o + q_base + (long long)qpos * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 y = make_float4(acc[4 * c] / denom, acc[4 * c + 1] / denom,
                                 acc[4 * c + 2] / denom,
                                 acc[4 * c + 3] / denom);
    Elem<T>::store4(orow + (c * kTPR + t) * 4, y);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int h, int kvh, int s, float scale, int causal,
           cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  constexpr size_t smem = Shape<D>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned int)(b * h), (unsigned int)((s + kBQ - 1) / kBQ));
  kernel<<<grid, Shape<D>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, h, kvh, s, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int h, int kvh, int s, int d, float scale,
               int causal, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, b, h, kvh, s, scale, causal,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, b, h, kvh, s, scale, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, b, h, kvh, s, scale, causal,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------- bf16: tensor-core path
constexpr int kWarps = 4;                 // 16 query rows each
constexpr int kMmaThreads = kWarps * 32;
constexpr int kPad = 8;                   // bf16 of padding per shared row

template <int D>
struct MmaShape {
  static constexpr int kRow = D + kPad;       // shared row stride (bf16)
  static constexpr int kTile = kBKV * kRow;   // one 64-row tile (bf16)
  static constexpr int kChunks = D / 8;       // 16-byte chunks per row
  static constexpr int kLoads = kBKV * kChunks / kMmaThreads;  // per thread
  // the Q tile, then two stages of K and two of V
  static constexpr size_t kSmem = 5 * kTile * sizeof(__nv_bfloat16);
};
static_assert(kBQ == kBKV && kBQ == kWarps * 16, "one tile shape");

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

// rows [row0, row0 + 64) of a [s, D] matrix into a padded shared tile
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int s) {
  using Sh = MmaShape<D>;
#pragma unroll
  for (int it = 0; it < Sh::kLoads; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i / Sh::kChunks;
    const int c = i % Sh::kChunks;
    const bool ok = row0 + r < s;
    cp_async16(smem_addr(dst + r * Sh::kRow + c * 8),
               src + (long long)(ok ? row0 + r : 0) * D + c * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int h, int kvh, int s,
                           float scale_log2, int causal) {
  using Sh = MmaShape<D>;
  constexpr int kRow = Sh::kRow;
  constexpr int kKSteps = D / 16;      // k-steps of Q K^T
  constexpr int kDTiles = D / 8;       // n-tiles of O
  constexpr int kNTiles = kBKV / 8;    // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + Sh::kTile;      // stages 0, 1
  __nv_bfloat16* sv = sk + 2 * Sh::kTile;  // stages 0, 1

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int b = bh / h;
  const int kv_head = (bh % h) / (h / kvh);
  const __nv_bfloat16* qg = q + (long long)bh * s * D;
  const __nv_bfloat16* kg = k + ((long long)b * kvh + kv_head) * s * D;
  const __nv_bfloat16* vg = v + ((long long)b * kvh + kv_head) * s * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tig = lane & 3;  // fragment column pair
  const int wrow = warp * 16;

  const int q_last = min(q0 + kBQ, s) - 1;
  const int n_kt = causal ? q_last / kBKV + 1 : (s + kBKV - 1) / kBKV;

  load_tile<D>(sq, qg, q0, s);
  load_tile<D>(sk, kg, 0, s);
  load_tile<D>(sv, vg, 0, s);
  cp_async_commit();

  unsigned qf[kKSteps][4];
  float oacc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // rows g, g + 8 (log2 domain)
  float l_r[2] = {0.f, 0.f};          // this thread's share of the sums

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile<D>(sk + (stage ^ 1) * Sh::kTile, kg, (kt + 1) * kBKV, s);
      load_tile<D>(sv + (stage ^ 1) * Sh::kTile, vg, (kt + 1) * kBKV, s);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and at kt == 0 the Q tile) has landed
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        ldmatrix_x4(smem_addr(sq + (wrow + (lane & 15)) * kRow + ks * 16 +
                              (lane >> 4) * 8),
                    qf[ks]);
    }
    const __nv_bfloat16* kt_s = sk + stage * Sh::kTile;
    const __nv_bfloat16* vt_s = sv + stage * Sh::kTile;

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys
    float sacc[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
      sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
      for (int jp = 0; jp < kNTiles / 2; ++jp) {
        unsigned bf[4];  // keys 16 jp + 0..7 and + 8..15, dims 16 ks + 0..15
        ldmatrix_x4(smem_addr(kt_s +
                              (jp * 16 + (lane & 7) + (lane >> 4) * 8) * kRow +
                              ks * 16 + ((lane >> 3) & 1) * 8),
                    bf);
        mma_bf16(sacc[2 * jp], qf[ks], bf[0], bf[1]);
        mma_bf16(sacc[2 * jp + 1], qf[ks], bf[2], bf[3]);
      }
    }

    // online softmax on the fragments: element e of n-tile j is row
    // g + 8 (e >> 1), key 8 j + 2 tig + (e & 1)
    const int j0 = kt * kBKV;
    const bool masked =
        j0 + kBKV > s || (causal && j0 + kBKV - 1 > q0 + wrow);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[j][e] * scale_log2;
        if (masked) {
          const int key = j0 + 8 * j + 2 * tig + (e & 1);
          const int row = q0 + wrow + g + 8 * (e >> 1);
          if (key >= s || (causal && key > row)) x = kNegInf;
        }
        sacc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }
    // P = P_hi + P_lo, both bf16, as the A fragments of P V: k-step kk
    // takes n-tiles 2 kk and 2 kk + 1
    unsigned p_hi[kBKV / 16][4], p_lo[kBKV / 16][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // row g, then row g + 8
        const float a = exp2f(sacc[j][2 * r] - mx[r]);
        const float b = exp2f(sacc[j][2 * r + 1] - mx[r]);
        l_r[r] += a + b;
        split_bf16(a, b, p_hi[j >> 1][2 * (j & 1) + r],
                   p_lo[j >> 1][2 * (j & 1) + r]);
      }
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        unsigned bf[4];  // keys 16 kk + 0..15, dims 16 dp + 0..7, + 8..15
        ldmatrix_x4_trans(
            smem_addr(vt_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 kRow +
                      dp * 16 + (lane >> 4) * 8),
            bf);
        mma_bf16(oacc[2 * dp], p_hi[kk], bf[0], bf[1]);
        mma_bf16(oacc[2 * dp], p_lo[kk], bf[0], bf[1]);
        mma_bf16(oacc[2 * dp + 1], p_hi[kk], bf[2], bf[3]);
        mma_bf16(oacc[2 * dp + 1], p_lo[kk], bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    denom[r] = fmaxf(l_r[r], 1e-30f);
  }
  // m and l are in the log2 domain of the scaled scores; lse is stored in
  // the natural one, as the f32 kernel stores it: ln 2 (m + log2 l)
  if (lse != nullptr && tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wrow + g + 8 * r;
      if (row < s)
        lse[(long long)bh * s + row] =
            (m_r[r] + log2f(denom[r])) * 0.6931471805599453f;
    }
  }
  // the warp's 16 rows of the Q tile are its own: stage O there, then
  // write 16-byte chunks of the rows < s
  __nv_bfloat16* so = sq + wrow * kRow;
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    *reinterpret_cast<unsigned*>(so + g * kRow + n * 8 + 2 * tig) =
        pack_bf16(oacc[n][0] / denom[0], oacc[n][1] / denom[0]);
    *reinterpret_cast<unsigned*>(so + (g + 8) * kRow + n * 8 + 2 * tig) =
        pack_bf16(oacc[n][2] / denom[1], oacc[n][3] / denom[1]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < Sh::kChunks / 2; ++it) {  // 16 rows, 32 lanes
    const int i = lane + 32 * it;
    const int r = i / Sh::kChunks;
    const int c = i % Sh::kChunks;
    const int row = q0 + wrow + r;
    if (row < s)
      *reinterpret_cast<uint4*>(o + (long long)bh * s * D +
                                (long long)row * D + c * 8) =
          *reinterpret_cast<const uint4*>(so + r * kRow + c * 8);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int h, int kvh, int s, float scale,
               int causal, cudaStream_t stream) {
  auto kernel = flash_attention_mma_kernel<D>;
  constexpr size_t smem = MmaShape<D>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned int)(b * h), (unsigned int)((s + kBQ - 1) / kBQ));
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, h, kvh, s, scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

int dispatch_mma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int b, int h, int kvh, int s, int d, float scale,
                 int causal, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_mma<32>(q, k, v, o, lse, b, h, kvh, s, scale, causal,
                            stream);
    case 64:
      return launch_mma<64>(q, k, v, o, lse, b, h, kvh, s, scale, causal,
                            stream);
    case 128:
      return launch_mma<128>(q, k, v, o, lse, b, h, kvh, s, scale, causal,
                             stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises.
// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel).
// All four tensors are contiguous and 16-byte aligned (the wrapper checks).
// `lse` is null (serving) or an f32 [B, H, S] that receives each query
// row's logsumexp of its scaled, masked scores, in the natural log domain:
// the statistic the backward (flash_attention_bwd.cu) recomputes P from.
// Writing it changes no arithmetic of o.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* lse, int b, int h, int kvh,
                               int s, int d, int dtype, int causal,
                               float scale, void* stream) {
  if (b < 1 || h < 1 || kvh < 1 || s < 1 || h % kvh != 0 ||
      (long long)b * h > 0x7fffffffLL || (s + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, l, b, h, kvh, s, d, scale, causal,
                             st);
  if (dtype == 1)
    return dispatch_mma(q, k, v, o, l, b, h, kvh, s, d, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
