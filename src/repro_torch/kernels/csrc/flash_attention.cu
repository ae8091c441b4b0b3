// Flash attention forward for Hopper (sm_90a), written by hand: the entry
// point, and the kernel for f32 inputs.
//
// Replaces the Pallas kernel `_flash_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py.  Computes, for q [B,S,H,D] and
// k/v [B,S,KV,D] with H = KV * group,
//     out = softmax(mask(softcap(q k^T / sqrt(D)))) v
// by an online softmax over kv tiles.  bf16 inputs go to the tensor-core
// kernel of flash_attention_tc.cu; f32 inputs to the kernel below.
//
// What differs from the kernel it replaces: the sequential kv axis of the
// grid becomes a loop inside the block, one block per (batch, q head,
// q tile), with the running (m, l, acc) of each row in registers; the loop
// starts at the window's lower edge and stops at the causal frontier, so
// masked-out tiles are never read; the ragged edge of S is masked here and
// nothing is padded in device memory.  GQA is by index (head h reads kv head
// h / group).
//
// The f32 kernel does both products and the softmax in IEEE f32 on the CUDA
// cores (no TF32: the f32 whole-path check of the serving paths holds the
// kernels to 1e-4 of the largest logit, which TF32's 10-bit mantissa would
// break).  It is bound by the CUDA cores' f32 rate and stages K, V and P
// through shared memory behind three block barriers a tile; f32 is the
// checking path, not the serving one, so it stays simple.
#include "common.cuh"

namespace rt {

template <int VEC>
__device__ __forceinline__ void lds_vec(const float* p, float* dst) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else {
    dst[0] = *p;
  }
}

template <typename T, int D, int BQ, int BK>
struct FlashCfg {
  static constexpr int THREADS = 256;
  static constexpr int LDQ = D + 4;    // row stride of the Q and K tiles
  static constexpr int LDV = D;
  static constexpr int LDP = BK + 4;
  static constexpr int RQ = BQ / 16;   // q rows per thread
  static constexpr int CK = BK / 16;   // score columns per thread
  static constexpr int DV = D / 16;    // output columns per thread
  static constexpr int VEC = DV >= 4 ? 4 : 1;
  static constexpr int NV = DV / VEC;
  static constexpr int SMEM_FLOATS = BQ * LDQ + BK * LDQ + BK * LDV + BQ * LDP;
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(256)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int H, int KV, int group, int causal, int window,
                       float cap, float scale) {
  using C = FlashCfg<T, D, BQ, BK>;
  constexpr int RQ = C::RQ, CK = C::CK, DV = C::DV, VEC = C::VEC, NV = C::NV;
  constexpr int LDQ = C::LDQ, LDV = C::LDV, LDP = C::LDP;

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LDQ;
  float* sV = sK + BK * LDQ;
  float* sP = sV + BK * LDV;

  const int tid = threadIdx.x;
  const int tx = tid & 15;        // column group; the 16 threads of a row
  const int ty = tid >> 4;        // row group     are one half of a warp
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;

  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(KV) * D;
  const T* q_base = q + (static_cast<int64_t>(b) * S * H + h) * D;
  const T* k_base = k + (static_cast<int64_t>(b) * S * KV + kvh) * D;
  const T* v_base = v + (static_cast<int64_t>(b) * S * KV + kvh) * D;

  load_tile<T, D, BQ, LDQ, C::THREADS>(sQ, q_base, q_stride, q0, S);

  // kv range this q tile can see.  window == 0 masks every key; the row is
  // then the mean of V over all keys, so the whole range is visited.
  int k_lo = 0, k_hi = S;
  if (window != 0) {
    if (causal) k_hi = min(S, q0 + BQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }

  float m_i[RQ], l_i[RQ], acc[RQ][DV];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DV; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous tile's K, V and P are no longer read
    load_tile<T, D, BK, LDQ, C::THREADS>(sK, k_base, kv_stride, k0, S);
    load_tile<T, D, BK, LDV, C::THREADS>(sV, v_base, kv_stride, k0, S);
    __syncthreads();

    // ---- scores of this thread's RQ x CK micro-tile ------------------------
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[RQ], bb[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        a[i] = *reinterpret_cast<const float4*>(sQ + (ty * RQ + i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < CK; ++j)
        bb[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          s[i][j] = fmaf(a[i].x, bb[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bb[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bb[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bb[j].w, s[i][j]);
        }
    }

    // ---- scale, softcap, mask, online softmax ------------------------------
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int q_pos = q0 + ty * RQ + i;
      bool in_range[CK];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const int dist = q_pos - k_pos;
        in_range[j] = k_pos < S;
        bool ok = in_range[j];
        if (causal) ok = ok && dist >= 0;
        ok = ok && (window < 0 || dist < window);
        s[i][j] = ok ? apply_cap(s[i][j] * scale, cap) : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m_i[i], row_max);
      const float alpha = expf(m_i[i] - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        // keys beyond S do not exist: weight exactly 0, unlike masked keys
        const float p = in_range[j] ? expf(s[i][j] - m_new) : 0.f;
        p_sum += p;
        sP[(ty * RQ + i) * LDP + tx + 16 * j] = p;
      }
      // l is kept as a per-thread partial sum; alpha is the same for the 16
      // threads of a row, so the partials are summed once, at the end
      l_i[i] = l_i[i] * alpha + p_sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DV; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // ---- acc += P V --------------------------------------------------------
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float p4[RQ][4];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        lds_vec<4>(sP + (ty * RQ + i) * LDP + kk, p4[i]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int jv = 0; jv < NV; ++jv) {
          float vv[VEC];
          lds_vec<VEC>(sV + (kk + t) * LDV + (jv * 16 + tx) * VEC, vv);
#pragma unroll
          for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][jv * VEC + e] = fmaf(p4[i][t], vv[e], acc[i][jv * VEC + e]);
        }
      }
    }
  }

  // ---- normalise and write ---------------------------------------------------
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    float l = l_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (l == 0.f) l = 1.f;
    const int q_pos = q0 + ty * RQ + i;
    if (q_pos < S) {
      T* o = out + (static_cast<int64_t>(b) * S + q_pos) * q_stride +
             static_cast<int64_t>(h) * D;
#pragma unroll
      for (int jv = 0; jv < NV; ++jv)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          Elem<T>::store(o + (jv * 16 + tx) * VEC + e, acc[i][jv * VEC + e] / l);
    }
  }
}

template <typename T, int D, int BQ, int BK>
int launch_flash(const void* q, const void* k, const void* v, void* out, int B,
                 int S, int H, int KV, int causal, int window, float cap,
                 float scale, cudaStream_t stream) {
  using C = FlashCfg<T, D, BQ, BK>;
  auto kern = flash_attention_kernel<T, D, BQ, BK>;
  constexpr int smem_bytes = C::SMEM_FLOATS * sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, C::THREADS, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, H / KV, causal,
      window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_flash(int D, const void* q, const void* k, const void* v,
                   void* out, int B, int S, int H, int KV, int causal,
                   int window, float cap, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_flash<T, 16, 64, 64>(q, k, v, out, B, S, H, KV, causal,
                                         window, cap, scale, stream);
    case 32:
      return launch_flash<T, 32, 64, 64>(q, k, v, out, B, S, H, KV, causal,
                                         window, cap, scale, stream);
    case 64:
      return launch_flash<T, 64, 64, 64>(q, k, v, out, B, S, H, KV, causal,
                                         window, cap, scale, stream);
    case 128:
      return launch_flash<T, 128, 64, 64>(q, k, v, out, B, S, H, KV, causal,
                                          window, cap, scale, stream);
    case 256:
      return launch_flash<T, 256, 32, 32>(q, k, v, out, B, S, H, KV, causal,
                                          window, cap, scale, stream);
    default:
      return -1;
  }
}

}  // namespace rt

namespace rt {
int flash_attention_bf16(int D, int DV, int bq, int wk, int bk, const void* q,
                         const void* k, const void* v, void* out, int B, int S,
                         int H, int KV, int causal, int window, float cap,
                         float scale, cudaStream_t stream);
}  // namespace rt

// dtype: 0 = float32, 1 = bfloat16.  D is the width of q and k, DV that of
// v and the output (DV < D only in bf16, at D 192, DV 128).  bq x bk are the
// q rows and keys of a tile and `kv_warps` the warps that share a q tile's
// kv range, as the wrapper's plan chose them (`attention_plan` in
// kernels/flash_attention.py).  Returns cudaGetLastError() after the launch
// (0 on success), -1 for a head_dim, dtype or tile the kernels do not take.
// Launches on `stream`, does not synchronise, allocates nothing.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int B, int S, int H, int KV,
                                  int D, int DV, int dtype, int bq,
                                  int kv_warps, int bk, int causal, int window,
                                  float cap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int want = D == 256 ? 32 : 64;
    if (bq != want || bk != want || kv_warps != 1 || DV != D) return -1;
    return rt::dispatch_flash<float>(D, q, k, v, out, B, S, H, KV, causal,
                                     window, cap, scale, st);
  }
  if (dtype == 1)
    return rt::flash_attention_bf16(D, DV, bq, kv_warps, bk, q, k, v, out, B,
                                    S, H, KV, causal, window, cap, scale, st);
  return -1;
}
