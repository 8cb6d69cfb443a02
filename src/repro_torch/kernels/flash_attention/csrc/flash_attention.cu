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
// 20 us at the bf16 tensor-core rate).  This first version does its
// products as fp32 FMAs on the CUDA cores, so it is bound by those
// (67 TFLOP/s) and by shared-memory reads; tensor-core tiles (mma.sync or
// wgmma), TMA and warp specialisation are later work.
//
// Design.  The TPU kernel walks the KV blocks as the sequential innermost
// grid axis and keeps (m, l, acc) in VMEM scratch across grid steps.  Here
// one thread block owns one (batch * head, 64-row query tile) and walks the
// KV tiles in a loop; every running statistic stays in registers:
//   - D / 16 threads share a query row, each owning 16 of its dims as four
//     float4 chunks interleaved across the row's threads (chunk c of thread
//     t holds dims 4 (c TPR + t) .. +3), so the row's threads read
//     neighbouring 16-byte words of a shared-memory K or V row: no bank
//     conflicts, and every warp reads one key row at a time (broadcast);
//   - a 64-key K and V tile is staged in shared memory as f32, loaded with
//     coalesced 16-byte global loads (8 bf16 or 4 f32 values) and converted
//     once with the intrinsics;
//   - per key, each thread forms its partial dot product, the row's threads
//     sum it with xor shuffles, so all of them hold the 64 scores of the
//     tile in registers; then one max, one rescale of (l, acc) and the
//     probabilities times V, as the TPU kernel does per KV block;
//   - under `causal`, tiles wholly after the tile's last query row are never
//     loaded (the loop ends at the diagonal tile, whose later keys are
//     masked); the heaviest query tiles are scheduled first;
//   - any S: rows of a ragged last tile are zero-filled and masked as keys,
//     and not written as queries.
// Arithmetic is f32 throughout, with expf (not __expf) and an IEEE divide;
// the build uses no --use_fast_math.
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

template <>
struct Elem<__nv_bfloat16> {
  static __device__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ void store4(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<unsigned int*>(&a);
    u.y = *reinterpret_cast<unsigned int*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
  // one 16-byte global load -> 8 floats in shared memory
  static constexpr int kPer16 = 8;
  static __device__ void load16(const __nv_bfloat16* src, float* dst) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
    float f[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
    reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int h,
                       int kvh, int s, float scale, int causal) {
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
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int kvh, int s, float scale, int causal,
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
      static_cast<const T*>(v), static_cast<T*>(o), h, kvh, s, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int b,
               int h, int kvh, int s, int d, float scale, int causal,
               cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, h, kvh, s, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, h, kvh, s, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, h, kvh, s, scale, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises.
// dtype: 0 = float32, 1 = bfloat16.  All four tensors are contiguous and
// 16-byte aligned (the wrapper checks).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int h, int kvh, int s, int d,
                               int dtype, int causal, float scale,
                               void* stream) {
  if (b < 1 || h < 1 || kvh < 1 || s < 1 || h % kvh != 0 ||
      (long long)b * h > 0x7fffffffLL || (s + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, b, h, kvh, s, d, scale, causal, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, b, h, kvh, s, d, scale,
                                     causal, st);
  return (int)cudaErrorInvalidValue;
}
