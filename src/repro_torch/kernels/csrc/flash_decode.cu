// Flash decode for Hopper (sm_90a), written by hand: one query token per row
// against a KV cache with per-row lengths.
//
// Replaces the Pallas kernel `_decode_kernel` / `flash_decode` of
// src/repro/kernels/flash_decode.py.  q [B,1,H,D], caches [B,S,KV,D],
// lengths [B] = valid entries including the current token (the query sits at
// position lengths - 1).  Same scale / softcap / window / -1e30 rules as the
// prefill kernel.
//
// The work is bytes: every cache entry in range is read once and used for two
// flops per byte.  So one block takes (row, kv head, kv split) and loads each
// K/V tile once for all `group` q heads that share the kv head; the loop runs
// from the window's lower edge to min(lengths[b], S) and no further, where the
// kernel it replaces walks the whole padded cache; loads are 16 bytes a
// thread along D.  With more than one split the partial (m, l, acc) go to
// scratch that the wrapper allocates and a second small kernel combines them
// by their log-sum-exp weights.
#include "common.cuh"

namespace rt {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeBK = 32;

__host__ __device__ inline int decode_smem_floats(int D, int group) {
  return kDecodeBK * (D + 4) + kDecodeBK * D + group * (2 * D + kDecodeBK + 3);
}

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ lengths,
                    T* __restrict__ out, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc,
                    int S, int H, int KV, int group, int n_splits, int chunk,
                    int window, float cap, float scale) {
  constexpr int BK = kDecodeBK;
  constexpr int THREADS = kDecodeThreads;
  constexpr int LDK = D + 4;

  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                       // [BK][LDK]
  float* sV = sK + BK * LDK;              // [BK][D]
  float* sQ = sV + BK * D;                // [group][D]
  float* sAcc = sQ + group * D;           // [group][D]
  float* sS = sAcc + group * D;           // [group][BK] scores, then weights
  float* sM = sS + group * BK;            // [group]
  float* sL = sM + group;
  float* sAlpha = sL + group;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lengths[b];

  // Valid keys are [len - window, len) cut to the cache.  Where that is empty
  // (window == 0, len <= 0, or a window that lies wholly beyond S) every key
  // is masked and the row is the mean of V over the whole cache.
  int lo = window > 0 ? max(0, len - window) : 0;
  int hi = min(len, S);
  if (window == 0 || lo >= hi) {
    lo = 0;
    hi = S;
  }
  const int kb = max(split * chunk, (lo / BK) * BK);
  const int ke = min((split + 1) * chunk, hi);

  for (int i = tid; i < group * D; i += THREADS) {
    const int g = i / D, d = i % D;
    sQ[i] = Elem<T>::load(q + (static_cast<int64_t>(b) * H + kvh * group + g) * D + d);
    sAcc[i] = 0.f;
  }
  if (tid < group) {
    // an empty split carries weight exp(-inf) = 0 into the combine
    sM[tid] = kb < ke ? kNegInf : -INFINITY;
    sL[tid] = 0.f;
  }

  const int64_t kv_stride = static_cast<int64_t>(KV) * D;
  const T* k_base = kc + (static_cast<int64_t>(b) * S * KV + kvh) * D;
  const T* v_base = vc + (static_cast<int64_t>(b) * S * KV + kvh) * D;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    __syncthreads();   // the previous tile is no longer read; sQ is written
    load_tile<T, D, BK, LDK, THREADS>(sK, k_base, kv_stride, k0, ke);
    load_tile<T, D, BK, D, THREADS>(sV, v_base, kv_stride, k0, ke);
    __syncthreads();

    // ---- scores: one (head, key) pair per thread and turn --------------------
    for (int i = tid; i < group * BK; i += THREADS) {
      const int g = i / BK, kk = i % BK;
      const float* qr = sQ + g * D;
      const float* kr = sK + kk * LDK;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qr + d);
        const float4 c = *reinterpret_cast<const float4*>(kr + d);
        s = fmaf(a.x, c.x, s);
        s = fmaf(a.y, c.y, s);
        s = fmaf(a.z, c.z, s);
        s = fmaf(a.w, c.w, s);
      }
      const int k_pos = k0 + kk;
      const int dist = len - 1 - k_pos;
      const bool ok = dist >= 0 && (window < 0 || dist < window);
      // keys at or beyond `ke` are not this block's: weight exactly 0
      sS[i] = k_pos < ke ? (ok ? apply_cap(s * scale, cap) : kNegInf) : -INFINITY;
    }
    __syncthreads();

    // ---- online softmax: one warp per head ------------------------------------
    for (int g = warp; g < group; g += THREADS / 32) {
      float sv = sS[g * BK + lane];       // BK == 32: one key per lane
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(sv - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sS[g * BK + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sAlpha[g] = alpha;
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // ---- acc += p V: one (head, column) pair per thread and turn --------------
    for (int i = tid; i < group * D; i += THREADS) {
      const int g = i / D, d = i % D;
      const float* pr = sS + g * BK;
      float a = sAcc[i] * sAlpha[g];
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) a = fmaf(pr[kk], sV[kk * D + d], a);
      sAcc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < group * D; i += THREADS) {
    const int g = i / D, d = i % D;
    const int h = kvh * group + g;
    if (n_splits == 1) {
      float l = sL[g];
      if (l == 0.f) l = 1.f;
      Elem<T>::store(out + (static_cast<int64_t>(b) * H + h) * D + d, sAcc[i] / l);
    } else {
      const int64_t idx = (static_cast<int64_t>(b) * H + h) * n_splits + split;
      part_acc[idx * D + d] = sAcc[i];
      if (d == 0) {
        part_m[idx] = sM[g];
        part_l[idx] = sL[g];
      }
    }
  }
}

// Combine the splits' partial results of one (row, head):
//   out = sum_i w_i acc_i / sum_i w_i l_i,  w_i = exp(m_i - max_j m_j).
template <typename T>
__global__ void flash_decode_combine_kernel(const float* __restrict__ part_m,
                                            const float* __restrict__ part_l,
                                            const float* __restrict__ part_acc,
                                            T* __restrict__ out, int D,
                                            int n_splits) {
  const int64_t bh = blockIdx.x;
  const float* pm = part_m + bh * n_splits;
  const float* pl = part_l + bh * n_splits;
  float m = -INFINITY;
  for (int i = 0; i < n_splits; ++i) m = fmaxf(m, pm[i]);
  float l = 0.f;
  for (int i = 0; i < n_splits; ++i) l += pl[i] * expf(pm[i] - m);
  if (l == 0.f) l = 1.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < n_splits; ++i)
      a += expf(pm[i] - m) * part_acc[(bh * n_splits + i) * D + d];
    Elem<T>::store(out + bh * D + d, a / l);
  }
}

template <typename T, int D>
int launch_decode(const void* q, const void* kc, const void* vc,
                  const int* lengths, void* out, float* part_m, float* part_l,
                  float* part_acc, int B, int S, int H, int KV, int n_splits,
                  int chunk, int window, float cap, float scale,
                  cudaStream_t stream) {
  const int group = H / KV;
  auto kern = flash_decode_kernel<T, D>;
  const int smem_bytes = decode_smem_floats(D, group) * sizeof(float);
  static int attr_bytes = 0;
  if (smem_bytes > attr_bytes) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_bytes = smem_bytes;
  }
  dim3 grid(n_splits, KV, B);
  kern<<<grid, kDecodeThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lengths, static_cast<T*>(out), part_m, part_l,
      part_acc, S, H, KV, group, n_splits, chunk, window, cap, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return static_cast<int>(e);
  flash_decode_combine_kernel<T><<<B * H, 128, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), D, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_decode(int D, const void* q, const void* kc, const void* vc,
                    const int* lengths, void* out, float* part_m,
                    float* part_l, float* part_acc, int B, int S, int H,
                    int KV, int n_splits, int chunk, int window, float cap,
                    float scale, cudaStream_t stream) {
#define RT_DECODE_CASE(DD)                                                     \
  case DD:                                                                     \
    return launch_decode<T, DD>(q, kc, vc, lengths, out, part_m, part_l,       \
                                part_acc, B, S, H, KV, n_splits, chunk,        \
                                window, cap, scale, stream);
  switch (D) {
    RT_DECODE_CASE(16)
    RT_DECODE_CASE(32)
    RT_DECODE_CASE(64)
    RT_DECODE_CASE(128)
    RT_DECODE_CASE(256)
    default:
      return -1;
  }
#undef RT_DECODE_CASE
}

}  // namespace rt

// Keys per tile; `chunk` (keys per split) must be a multiple of it.
extern "C" int rt_flash_decode_tile(void) { return rt::kDecodeBK; }

// dtype: 0 = float32, 1 = bfloat16.  part_* are scratch for n_splits > 1:
// part_m, part_l [B,H,n_splits] and part_acc [B,H,n_splits,D], f32; unused
// (may be null) for n_splits == 1.  Returns cudaGetLastError() after the
// launches (0 on success), -1 for a head_dim or dtype the kernel does not
// take.  Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int rt_flash_decode(const void* q, const void* kc, const void* vc,
                               const void* lengths, void* out, void* part_m,
                               void* part_l, void* part_acc, int B, int S,
                               int H, int KV, int D, int dtype, int n_splits,
                               int chunk, int window, float cap, float scale,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 0)
    return rt::dispatch_decode<float>(D, q, kc, vc, len, out, pm, pl, pa, B, S,
                                      H, KV, n_splits, chunk, window, cap,
                                      scale, st);
  if (dtype == 1)
    return rt::dispatch_decode<__nv_bfloat16>(D, q, kc, vc, len, out, pm, pl,
                                              pa, B, S, H, KV, n_splits, chunk,
                                              window, cap, scale, st);
  return -1;
}
