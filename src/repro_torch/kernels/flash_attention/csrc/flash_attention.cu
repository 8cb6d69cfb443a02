// Forward GQA attention with an online softmax for Hopper (sm_90a): the
// prefill attention of every layer of the LM serving path.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention/flash.py).  Same contract, with v's
// width apart from q's and k's as the reference's chunked attention
// allows it (MLA: q.k over 192 dims, v over 128), and keys of a length
// apart from the queries' (cross-attention: a decoder's queries over an
// encoder's keys):
//   q [B, H, S, DQK], k [B, KV, SKV, DQK], v [B, KV, SKV, DV],
//   H % KV == 0, f32 or bf16; o [B, H, S, DV] in q's type,
//   o = softmax(q k^T / sqrt(DQK)) v per head,
// query head bh reading KV head bh / (H / KV) (K and V are never
// replicated), keys after the query masked with -1e30 when causal (which
// needs SKV == S: the entry refuses causal with two lengths rather than
// guess how they align), the softmax sum clamped to 1e-30 before the
// divide.  (DQK, DV) is one of (32, 32), (64, 64), (128, 128) and
// (192, 128); every (D, D) pair is the same code, and so the same bits,
// as before DV was a parameter, and every call with SKV == S the same
// bits as before SKV was one.
//
// Bound: at the serving shapes it is bytes (q, k, v read once and o written
// once: 12.6 MB at B=8, S=512 and smollm's 9/3 heads, 3.8 us at 3.35 TB/s;
// 83.9 MB at deepseek-v2-lite's 16/16 heads at 192/128, 25 us; 21.0 MB
// at seamless-m4t-medium's cross-attention, 512 queries over 128 keys at
// 16/16 heads of 64, 6.3 us) or, for long
// prompts, the causal S^2 D products (19 GFLOP at S=4096, 20 us at the
// bf16 tensor-core rate).
//
// The TPU kernel walks the KV blocks as the sequential innermost grid axis
// and keeps (m, l, acc) in VMEM scratch across grid steps.  Here one thread
// block owns one (batch * head, query tile) and walks the 64-key KV tiles
// in a loop with every running statistic in registers.  Under `causal`,
// tiles wholly after the tile's last query row are never loaded (the loop
// ends at the diagonal tile, whose later keys are masked by index), and the
// heaviest query tiles are scheduled first.  The grid covers the query
// tiles of S, and the loop the ceil(SKV / 64) key tiles.  Any S and SKV:
// key rows of a ragged last tile are zero-filled and masked, and query
// rows of one are not written.  The two dtypes take two kernels.
//
// bf16 (the serving path): tensor cores.  A block is 4 warps; each warp
// owns 16 query rows and issues mma.sync.m16n8k16 on bf16 with f32
// accumulators, for S = Q K^T and for O += P V:
//   - Q's A fragments are loaded with ldmatrix, once per block at
//     DQK <= 128; at DQK = 192 they would take 48 registers on top of the
//     D=128 kernel's 228 under the 255 cap, so each KV tile re-reads them
//     from the Q tile in shared memory, one k-step at a time (12 more
//     ldmatrix.x4 a tile beside K's 48 and V's 32); K's B fragments with
//     ldmatrix, V's with ldmatrix.trans, from bf16 tiles in shared memory;
//   - K and V tiles stay bf16 and go through a 2-stage ring filled by
//     16-byte cp.async (src-size 0 zero-fills rows >= S), so tile j+1 loads
//     while tile j is multiplied; each shared row is padded by 16 bytes,
//     which puts the 8 rows of every ldmatrix in 8 distinct bank groups;
//   - the online softmax runs on the accumulator fragments: a thread holds
//     two rows' scores, the row max and the row sum take two xor shuffles
//     across the quad; exp2f with log2(e)/sqrt(DQK) folded into the scale;
//   - P goes from the S accumulators straight into the A fragments of the
//     PV product, in registers, split into two bf16 parts P_hi + P_lo that
//     take one product each (50 % more tensor-core work than P_hi alone,
//     and ~16 bits of P kept): with P rounded to bf16 alone the bf16
//     prefill logits of the 30-layer serving model came barely inside
//     their 5e-2 gate against the plain attention
//     (scripts/torch_kernel_probe.py measures both roundings); the row sum
//     l adds the f32 P;
//   - the output tile is staged in the warp's own rows of the Q tile (row
//     stride DQK + 8) and written as 16-byte chunks of rows < S at stride
//     DV.
// Registers stay under the 255 of __launch_bounds__(128).  Shared memory
// is the Q tile and two stages of K (64 x (DQK + 8) bf16 each) and two of
// V (64 x (DV + 8)): 45 KB at D=64, so several blocks share an SM; 85 KB
// at D=128 and 109 KB at 192/128, which opt in past the 48 KB default and
// fit two blocks an SM.
//
// f32 (the 2e-5 check; TF32 would break it): the CUDA-core design of the
// first version.  kTPR threads share a query row; each owns DQK / kTPR of
// its q.k dims and DV / kTPR of its output dims as float4 chunks
// interleaved across the row's threads; a 64-key K and V tile is staged in
// shared memory as f32; per key each thread forms its partial dot product
// and the row's threads sum it with xor shuffles; then one max, one
// rescale of (l, acc) and the probabilities times V.  Arithmetic is f32
// throughout, with expf (not __expf) and an IEEE divide.  At DQK = DV = D,
// kTPR = D / 16 (16 dims each); at 192/128 D / 16 would be 12 threads, not
// a power of two for the shuffles, so kTPR = 16: 12 q.k dims and 8 output
// dims a thread.  A block owns 64 query rows, 32 at D=128 and 16 at
// 192/128: 64 rows of 8 threads would be 512 threads, whose 128-register
// cap spilled the 64 scores a thread holds; a row's arithmetic does not
// depend on how many rows share its block (a wholly masked key tile leaves
// (m, l, acc) exactly as they are).
//
// The build uses no --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per thread block
constexpr int kBKV = 64;         // keys per staged K/V tile
constexpr int kDimsPerThread = 16;
constexpr float kNegInf = -1e30f;

template <int DQK, int DV>
struct Shape {
  static_assert(DQK >= DV, "the pairs have DQK >= DV");
  // threads per query row: D / 16 at DQK = DV = D, else 16
  static constexpr int kTPR = DQK == DV ? DQK / kDimsPerThread : 16;
  static constexpr int kQkChunks = DQK / (4 * kTPR);  // float4s of q.k
  static constexpr int kVChunks = DV / (4 * kTPR);    // float4s of o
  static constexpr int kRows =  // query rows per block
      DQK != DV ? kBQ / 4 : (DQK == 128 ? kBQ / 2 : kBQ);
  static constexpr int kThreads = kRows * kTPR;
  static constexpr size_t kSmem = kBKV * (DQK + DV) * sizeof(float);
  static_assert(kQkChunks * 4 * kTPR == DQK && kVChunks * 4 * kTPR == DV,
                "whole float4 chunks per thread");
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

// rows [j0, j0 + 64) of a [s, D] matrix into a shared f32 tile of 64 x D,
// zero past row s
template <typename T, int D, int kThreads>
__device__ __forceinline__ void stage_f32(float* dst, const T* src, int j0,
                                          int s) {
  constexpr int kPer16 = Elem<T>::kPer16;
  constexpr int kVecs = kBKV * D / kPer16;  // 16-byte loads per full tile
  const int valid = min(kBKV, s - j0) * D / kPer16;
  const T* g = src + (long long)j0 * D;
  for (int i = threadIdx.x; i < kVecs; i += kThreads) {
    float* d = dst + i * kPer16;
    if (i < valid) {
      Elem<T>::load16(g + (long long)i * kPer16, d);
    } else {
#pragma unroll
      for (int e = 0; e < kPer16; e += 4)
        *reinterpret_cast<float4*>(d + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// the body of both f32 entries below
template <typename T, int DQK, int DV>
__device__ __forceinline__ void flash_attention_rows(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int h, int kvh, int s,
    int skv, float scale, int causal) {
  using Sh = Shape<DQK, DV>;
  constexpr int kTPR = Sh::kTPR;
  constexpr int kRows = Sh::kRows;
  constexpr int kThreads = Sh::kThreads;
  constexpr int kQk = Sh::kQkChunks;
  constexpr int kV = Sh::kVChunks;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + kBKV * DQK;

  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = bh / h;
  const int kv_head = (bh % h) / (h / kvh);
  const long long kv_row0 = ((long long)b * kvh + kv_head) * skv;

  const int tid = threadIdx.x;
  const int r = tid / kTPR;  // query row within the tile
  const int t = tid % kTPR;  // this thread's share of the row
  const int qpos = qt * kRows + r;
  const bool row_ok = qpos < s;

  float qr[4 * kQk];
  float acc[4 * kV];
#pragma unroll
  for (int c = 0; c < kQk; ++c) {
    const int d0 = (c * kTPR + t) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_ok)
      x = Elem<T>::load4(q + ((long long)bh * s + qpos) * DQK + d0);
    qr[4 * c] = x.x;
    qr[4 * c + 1] = x.y;
    qr[4 * c + 2] = x.z;
    qr[4 * c + 3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < 4 * kV; ++i) acc[i] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  const int q_last = min(qt * kRows + kRows, s) - 1;
  const int n_kt = causal ? q_last / kBKV + 1 : (skv + kBKV - 1) / kBKV;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int j0 = kt * kBKV;
    __syncthreads();  // every thread is done with the previous tile
    stage_f32<T, DQK, kThreads>(ks, k + kv_row0 * DQK, j0, skv);
    stage_f32<T, DV, kThreads>(vs, v + kv_row0 * DV, j0, skv);
    __syncthreads();

    // scores of this tile: sc[j] = q . k_j * scale, masked to -1e30
    float sc[kBKV];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBKV; ++j) {
      const float* kr = ks + j * DQK;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kQk; ++c) {
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
      if (kpos >= skv || (causal && kpos > qpos)) sv = kNegInf;
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
    for (int i = 0; i < 4 * kV; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBKV; ++j) {
      const float* vr = vs + j * DV;
      const float p = sc[j];
#pragma unroll
      for (int c = 0; c < kV; ++c) {
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
  T* orow = o + ((long long)bh * s + qpos) * DV;
#pragma unroll
  for (int c = 0; c < kV; ++c) {
    const float4 y = make_float4(acc[4 * c] / denom, acc[4 * c + 1] / denom,
                                 acc[4 * c + 2] / denom,
                                 acc[4 * c + 3] / denom);
    Elem<T>::store4(orow + (c * kTPR + t) * 4, y);
  }
}

// (D, D) pairs: ptxas picks the registers for kThreads alone
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(Shape<DQK, DV>::kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int h, int kvh, int s,
                       int skv, float scale, int causal) {
  flash_attention_rows<T, DQK, DV>(q, k, v, o, lse, h, kvh, s, skv, scale,
                                   causal);
}

// 192/128: one block an SM is enough for its register budget; without the
// minimum ptxas held it to 128 registers and spilled
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(Shape<DQK, DV>::kThreads, 1)
flash_attention_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            float* __restrict__ lse, int h, int kvh, int s,
                            int skv, float scale, int causal) {
  flash_attention_rows<T, DQK, DV>(q, k, v, o, lse, h, kvh, s, skv, scale,
                                   causal);
}

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int h, int kvh, int s, int skv, float scale, int causal,
           cudaStream_t stream) {
  void (*kernel)(const T*, const T*, const T*, T*, float*, int, int, int,
                 int, float, int);
  if constexpr (DQK == DV)
    kernel = flash_attention_kernel<T, DQK, DV>;
  else
    kernel = flash_attention_kernel_wide<T, DQK, DV>;
  using Sh = Shape<DQK, DV>;
  constexpr size_t smem = Sh::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  constexpr int rows = Sh::kRows;
  if ((s + rows - 1) / rows > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)(b * h), (unsigned int)((s + rows - 1) / rows));
  kernel<<<grid, Sh::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, h, kvh, s, skv,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int h, int kvh, int s, int skv, int dqk,
               int dv, float scale, int causal, cudaStream_t stream) {
  if (dqk == 32 && dv == 32)
    return launch<T, 32, 32>(q, k, v, o, lse, b, h, kvh, s, skv,
                             scale, causal, stream);
  if (dqk == 64 && dv == 64)
    return launch<T, 64, 64>(q, k, v, o, lse, b, h, kvh, s, skv,
                             scale, causal, stream);
  if (dqk == 128 && dv == 128)
    return launch<T, 128, 128>(q, k, v, o, lse, b, h, kvh, s, skv,
                               scale, causal, stream);
  if (dqk == 192 && dv == 128)
    return launch<T, 192, 128>(q, k, v, o, lse, b, h, kvh, s, skv,
                               scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------- bf16: tensor-core path
constexpr int kWarps = 4;                 // 16 query rows each
constexpr int kMmaThreads = kWarps * 32;
constexpr int kPad = 8;                   // bf16 of padding per shared row

// a 64-row bf16 tile of D-wide rows in shared memory
template <int D>
struct Tile {
  static constexpr int kRow = D + kPad;       // shared row stride (bf16)
  static constexpr int kSize = kBKV * kRow;   // one 64-row tile (bf16)
  static constexpr int kChunks = D / 8;       // 16-byte chunks per row
  static constexpr int kLoads = kBKV * kChunks / kMmaThreads;  // per thread
};

template <int DQK, int DV>
struct MmaShape {
  // Q's fragments held in registers across the KV tiles (DQK <= 128), or
  // re-read from the Q tile for each (see the top of the file)
  static constexpr bool kQInRegs = DQK <= 128;
  // the Q tile, then two stages of K and two of V
  static constexpr size_t kSmem =
      (3 * Tile<DQK>::kSize + 2 * Tile<DV>::kSize) * sizeof(__nv_bfloat16);
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
  using Sh = Tile<D>;
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

// sacc += Q K^T over k-step ks (dims 16 ks + 0..15) for the warp's 16 rows
// and the tile's 64 keys, from Q's A fragment `a`
template <int kRow, int kNTiles>
__device__ __forceinline__ void qk_kstep(float (&sacc)[kNTiles][4],
                                         const unsigned a[4],
                                         const __nv_bfloat16* kt_s, int ks,
                                         int lane) {
#pragma unroll
  for (int jp = 0; jp < kNTiles / 2; ++jp) {
    unsigned bf[4];  // keys 16 jp + 0..7 and + 8..15, dims 16 ks + 0..15
    ldmatrix_x4(smem_addr(kt_s + (jp * 16 + (lane & 7) + (lane >> 4) * 8) *
                                     kRow +
                          ks * 16 + ((lane >> 3) & 1) * 8),
                bf);
    mma_bf16(sacc[2 * jp], a, bf[0], bf[1]);
    mma_bf16(sacc[2 * jp + 1], a, bf[2], bf[3]);
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int h, int kvh, int s,
                           int skv, float scale_log2, int causal) {
  using QK = Tile<DQK>;
  using VT = Tile<DV>;
  constexpr bool kQInRegs = MmaShape<DQK, DV>::kQInRegs;
  constexpr int kRow = QK::kRow;       // Q and K tiles' row stride
  constexpr int kRowV = VT::kRow;
  constexpr int kKSteps = DQK / 16;    // k-steps of Q K^T
  constexpr int kDTiles = DV / 8;      // n-tiles of O
  constexpr int kNTiles = kBKV / 8;    // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + QK::kSize;      // stages 0, 1
  __nv_bfloat16* sv = sk + 2 * QK::kSize;  // stages 0, 1

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int b = bh / h;
  const int kv_head = (bh % h) / (h / kvh);
  const long long kv_row0 = ((long long)b * kvh + kv_head) * skv;
  const __nv_bfloat16* qg = q + (long long)bh * s * DQK;
  const __nv_bfloat16* kg = k + kv_row0 * DQK;
  const __nv_bfloat16* vg = v + kv_row0 * DV;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tig = lane & 3;  // fragment column pair
  const int wrow = warp * 16;

  const int q_last = min(q0 + kBQ, s) - 1;
  const int n_kt = causal ? q_last / kBKV + 1 : (skv + kBKV - 1) / kBKV;

  load_tile<DQK>(sq, qg, q0, s);
  load_tile<DQK>(sk, kg, 0, skv);
  load_tile<DV>(sv, vg, 0, skv);
  cp_async_commit();

  // Q's A fragment of k-step ks, from the warp's own rows of the Q tile
  const unsigned q_frag0 =
      smem_addr(sq + (wrow + (lane & 15)) * kRow + (lane >> 4) * 8);
  unsigned qf[kQInRegs ? kKSteps : 1][4];
  float oacc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // rows g, g + 8 (log2 domain)
  float l_r[2] = {0.f, 0.f};          // this thread's share of the sums

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile<DQK>(sk + (stage ^ 1) * QK::kSize, kg, (kt + 1) * kBKV,
                     skv);
      load_tile<DV>(sv + (stage ^ 1) * VT::kSize, vg, (kt + 1) * kBKV, skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and at kt == 0 the Q tile) has landed
    if constexpr (kQInRegs) {
      if (kt == 0) {
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks)
          ldmatrix_x4(smem_addr(sq + (wrow + (lane & 15)) * kRow + ks * 16 +
                                (lane >> 4) * 8),
                      qf[ks]);
      }
    }
    const __nv_bfloat16* kt_s = sk + stage * QK::kSize;
    const __nv_bfloat16* vt_s = sv + stage * VT::kSize;

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys
    float sacc[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
      sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      if constexpr (kQInRegs) {
        qk_kstep<kRow, kNTiles>(sacc, qf[ks], kt_s, ks, lane);
      } else {
        unsigned a[4];
        ldmatrix_x4(q_frag0 + ks * 32, a);
        qk_kstep<kRow, kNTiles>(sacc, a, kt_s, ks, lane);
      }
    }

    // online softmax on the fragments: element e of n-tile j is row
    // g + 8 (e >> 1), key 8 j + 2 tig + (e & 1)
    const int j0 = kt * kBKV;
    const bool masked =
        j0 + kBKV > skv || (causal && j0 + kBKV - 1 > q0 + wrow);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[j][e] * scale_log2;
        if (masked) {
          const int key = j0 + 8 * j + 2 * tig + (e & 1);
          const int row = q0 + wrow + g + 8 * (e >> 1);
          if (key >= skv || (causal && key > row)) x = kNegInf;
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
                                 kRowV +
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
  // the warp's 16 rows of the Q tile are its own: stage O there (DV of
  // each DQK-wide row), then write 16-byte chunks of the rows < s
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
  for (int it = 0; it < VT::kChunks / 2; ++it) {  // 16 rows, 32 lanes
    const int i = lane + 32 * it;
    const int r = i / VT::kChunks;
    const int c = i % VT::kChunks;
    const int row = q0 + wrow + r;
    if (row < s)
      *reinterpret_cast<uint4*>(o + ((long long)bh * s + row) * DV + c * 8) =
          *reinterpret_cast<const uint4*>(so + r * kRow + c * 8);
  }
}

template <int DQK, int DV>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int h, int kvh, int s, int skv, float scale,
               int causal, cudaStream_t stream) {
  auto kernel = flash_attention_mma_kernel<DQK, DV>;
  constexpr size_t smem = MmaShape<DQK, DV>::kSmem;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if ((s + kBQ - 1) / kBQ > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)(b * h), (unsigned int)((s + kBQ - 1) / kBQ));
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, h, kvh, s, skv, scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

int dispatch_mma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int b, int h, int kvh, int s, int skv, int dqk,
                 int dv, float scale, int causal, cudaStream_t stream) {
  if (dqk == 32 && dv == 32)
    return launch_mma<32, 32>(q, k, v, o, lse, b, h, kvh, s, skv,
                              scale, causal, stream);
  if (dqk == 64 && dv == 64)
    return launch_mma<64, 64>(q, k, v, o, lse, b, h, kvh, s, skv,
                              scale, causal, stream);
  if (dqk == 128 && dv == 128)
    return launch_mma<128, 128>(q, k, v, o, lse, b, h, kvh, s, skv,
                                scale, causal, stream);
  if (dqk == 192 && dv == 128)
    return launch_mma<192, 128>(q, k, v, o, lse, b, h, kvh, s, skv,
                                scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises.
// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel).
// (dqk, dv): q's and k's width, and v's and o's, one of the pairs above.
// s: q's and o's length; skv: k's and v's, which must equal s when causal.
// All four tensors are contiguous and 16-byte aligned (the wrapper checks).
// `lse` is null (serving) or an f32 [B, H, S] that receives each query
// row's logsumexp of its scaled, masked scores, in the natural log domain:
// the statistic the backward (flash_attention_bwd.cu) recomputes P from.
// Writing it changes no arithmetic of o.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* lse, int b, int h, int kvh,
                               int s, int skv, int dqk, int dv, int dtype,
                               int causal, float scale, void* stream) {
  if (b < 1 || h < 1 || kvh < 1 || s < 1 || skv < 1 || h % kvh != 0 ||
      (causal && skv != s) || (long long)b * h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, l, b, h, kvh, s, skv, dqk, dv,
                             scale, causal, st);
  if (dtype == 1)
    return dispatch_mma(q, k, v, o, l, b, h, kvh, s, skv, dqk, dv, scale,
                        causal, st);
  return (int)cudaErrorInvalidValue;
}
