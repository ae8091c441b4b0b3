// Flash decode for Hopper (sm_90a), written by hand: one query token per row
// against a KV cache with per-row lengths.
//
// Replaces the Pallas kernel `_decode_kernel` / `flash_decode` of
// src/repro/kernels/flash_decode.py.  q [B,1,H,D], caches [B,S,KV,D],
// lengths [B] = valid entries including the current token (the query sits at
// position lengths - 1).  Same scale / softcap / window / -1e30 rules as the
// prefill kernel.
//
// What bounds it: bytes.  Every cache entry in range is read once and used
// for two flops per byte, so the CUDA cores suffice and the design is about
// keeping enough loads in flight and never stalling a block on them:
//   * grid (kv split, kv head x head block, row); a block of 4 warps reads
//     each K/V row once for all the q heads it serves (up to 8 of the kv
//     head's group; a larger group is cut into ceil(group / 8) even head
//     blocks), walks only [window's lower edge, min(len, S)), and a split
//     beyond its row's length skips the key loop (its partial weighs 0);
//   * a key row is D * elt / 16 lanes of 16 bytes (16 lanes at D 128 bf16),
//     so a warp step covers 32 / that many keys; the warps take the steps of
//     the block's chunk in turn;
//   * each warp keeps 8 steps of K and V in its own ring in shared memory,
//     4 of them in flight while it works on the other 4 (cp.async, rows at
//     or beyond the split's end zero-filled; 2 and 2 where a block serves
//     more than 2 heads, for registers).  A lane reads back only the 16-byte
//     segments it copied itself, so `cp.async.wait_group` is the only wait:
//     the key loop has no block barrier and no warp barrier;
//   * the steps of one iteration are scored together, so their products and
//     shuffles overlap and one rescale of (l, acc) serves them all;
//   * each lane keeps in registers its segment of every served q vector (f32,
//     pre-scaled), and its own running (m, l) and accumulator segment per
//     head; a score is the lane's partial dot product plus shuffles across
//     the lanes of one key;
//   * after the loop, the key slots of a warp are merged by shuffles and the
//     warps by shared memory (one barrier).  With several splits each block
//     writes an f32 partial (acc, m, l) and counts itself in with an atomic;
//     the last block of a (row, head block) to arrive merges the splits by
//     their log-sum-exp weights and resets the counter to 0 for the next
//     launch.  (A second kernel for that merge cost a fifth of the decode
//     time at qwen3-1.7b's shape.)
#include "common.cuh"

namespace rt {

constexpr int kDecodeWarps = 4;
constexpr int kDecodeThreads = 32 * kDecodeWarps;
constexpr int kDecodeStages = 8;    // warp steps in flight, per warp
constexpr int kDecodeTile = 32;     // a split's chunk is a multiple of this
constexpr int kDecodeMaxHeads = 8;  // q heads a block keeps in registers
constexpr float kDecodeLog2e = 1.4426950408889634f;

template <typename T, int D>
struct DecodeCfg {
  static constexpr int VEC = 16 / sizeof(T);          // elements in 16 bytes
  static constexpr int SEGS = D / VEC;                // 16-byte segments a row
  static constexpr int LPK = SEGS < 32 ? SEGS : 32;   // lanes per key
  static constexpr int SPL = SEGS / LPK;              // segments per lane
  static constexpr int KPI = 32 / LPK;                // keys per warp step
  static constexpr int EPL = SPL * VEC;               // elements per lane
  // per warp: [stage][K, V][segment of the lane][lane] of uint4
  static constexpr int RING_U4 = kDecodeStages * 2 * SPL * 32;
  static constexpr int RING_BYTES = kDecodeWarps * RING_U4 * 16;
  // after the loop the ring is reused for the warps' (acc, m, l) per head
  static constexpr int RED_BYTES = kDecodeWarps * kDecodeMaxHeads * (D + 2) * 4;
  static constexpr int SMEM_BYTES = RING_BYTES > RED_BYTES ? RING_BYTES
                                                           : RED_BYTES;
};

__device__ __forceinline__ void dec_cp_async16(void* dst, const void* src,
                                               int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// One warp step's K and V segments of this lane (key `key`, zero-filled at or
// beyond `ke`) into the lane's slots of ring stage `st`; then close the group.
template <int SPL, int LPK, int VEC, typename T>
__device__ __forceinline__ void issue_step(uint4* st, const T* k_lane,
                                           const T* v_lane, int64_t kv_stride,
                                           int key, int ke, int kb, bool live) {
  if (live) {
    const bool ok = key < ke;
    const int64_t off = static_cast<int64_t>(ok ? key : kb) * kv_stride;
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      dec_cp_async16(st + s * 32, k_lane + off + s * LPK * VEC, ok ? 16 : 0);
      dec_cp_async16(st + (SPL + s) * 32, v_lane + off + s * LPK * VEC,
                     ok ? 16 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* dst) {
  float tmp[Elem<T>::kPerVec];
  Elem<T>::unpack(u, tmp);
#pragma unroll
  for (int e = 0; e < Elem<T>::kPerVec; ++e) dst[e] = tmp[e];
}

// G: the most q heads a block serves (a power of two, >= the `nh` of any
// block of this launch).
template <typename T, int D, int G>
__global__ void __launch_bounds__(kDecodeThreads, 1)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ lengths,
                    T* __restrict__ out, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc,
                    int* __restrict__ counters, int S, int H, int KV,
                    int group, int heads_per_block, int n_splits, int chunk,
                    int window, float cap, float scale) {
  using C = DecodeCfg<T, D>;
  constexpr int VEC = C::VEC, LPK = C::LPK, SPL = C::SPL, KPI = C::KPI,
                EPL = C::EPL, NST = kDecodeStages, W = kDecodeWarps;
  constexpr int U = G <= 2 ? 4 : 2;  // warp steps an iteration

  extern __shared__ __align__(16) uint4 smem_u4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = lane / LPK;  // which key of a warp step
  const int seg = lane % LPK;   // which 16-byte segment(s) of that key
  const int split = blockIdx.x;
  const int n_hb = (group + heads_per_block - 1) / heads_per_block;
  const int kvh = blockIdx.y / n_hb;
  const int h0 = kvh * group + (blockIdx.y % n_hb) * heads_per_block;
  const int nh = min(heads_per_block, kvh * group + group - h0);
  const int b = blockIdx.z;
  const int len = lengths[b];

  // Valid keys are [len - window, len) cut to the cache.  Where that is empty
  // (window == 0, len <= 0, or a window that lies wholly beyond S) every key
  // is masked and the row is the mean of V over the whole cache.
  int lo = window > 0 ? max(0, len - window) : 0;
  int hi = min(len, S);
  const bool all_masked = window == 0 || lo >= hi;
  if (all_masked) {
    lo = 0;
    hi = S;
  }
  const int kb = max(split * chunk, lo);
  const int ke = min((split + 1) * chunk, hi);
  float* red = reinterpret_cast<float*>(smem_u4);  // [W][G][D + 2], after
  if (kb < ke) {
    // ---- the key loop: warp w takes steps w, w + W, ... of [kb, ke) --------
    const int64_t kv_stride = static_cast<int64_t>(KV) * D;
    const int64_t base =
        (static_cast<int64_t>(b) * S * KV + kvh) * D + seg * VEC;
    const T* k_lane = kc + base;
    const T* v_lane = vc + base;
    uint4* ring = smem_u4 + warp * C::RING_U4 + lane;
    const int n_steps = (ke - kb + KPI - 1) / KPI;
    const int my_steps = n_steps > warp ? (n_steps - warp + W - 1) / W : 0;
    const int key0 = kb + warp * KPI + slot;  // this lane's key at step 0
#pragma unroll
    for (int i = 0; i < NST - U; ++i)
      issue_step<SPL, LPK, VEC>(ring + (i % NST) * 2 * SPL * 32, k_lane,
                                v_lane, kv_stride, key0 + i * W * KPI, ke, kb,
                                i < my_steps);

    // ---- this lane's segment of each served q vector, scaled (its loads
    // overlap the first K/V copies) ------------------------------------------
    float qv[G][EPL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const T* qr =
          q + (static_cast<int64_t>(b) * H + h0 + min(g, nh - 1)) * D;
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        const uint4 u =
            *reinterpret_cast<const uint4*>(qr + (seg + s * LPK) * VEC);
        unpack16<T>(u, qv[g] + s * VEC);
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[g][e] *= scale;
    }
    float m_g[G], l_g[G], acc[G][EPL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_g[g] = kNegInf;
      l_g[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
    }
    const bool capped = cap > 0.f;
    const float cap_l = cap * kDecodeLog2e;
    const float inv_cap = capped ? 1.f / cap : 0.f;

    // U steps an iteration: their scores are independent, so their loads,
    // products and shuffles overlap, and one rescale serves U keys
    for (int i = 0; i < my_steps; i += U) {
      // the stages refilled here were read (into registers, and used) by the
      // previous iteration
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = i + NST - U + u;
        issue_step<SPL, LPK, VEC>(ring + (j % NST) * 2 * SPL * 32, k_lane,
                                  v_lane, kv_stride, key0 + j * W * KPI, ke,
                                  kb, j < my_steps);
      }
      asm volatile("cp.async.wait_group %0;\n" ::"n"(NST - U) : "memory");
      float kf[U][EPL], vf[U][EPL];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        live[u] = i + u < my_steps;
        const uint4* st = ring + ((i + u) % NST) * 2 * SPL * 32;
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          unpack16<T>(st[s * 32], kf[u] + s * VEC);
          unpack16<T>(st[(SPL + s) * 32], vf[u] + s * VEC);
        }
        // a step past the warp's last was never copied: its stage holds
        // whatever it held, so weigh it 0 (below) and read V as zeros
#pragma unroll
        for (int e = 0; e < EPL; ++e) vf[u][e] = live[u] ? vf[u][e] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= nh) break;
        float x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          x[u] = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) x[u] = fmaf(qv[g][e], kf[u][e], x[u]);
        }
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
          for (int u = 0; u < U; ++u)
            x[u] += __shfl_xor_sync(0xffffffffu, x[u], off);
        float m_new = m_g[g];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float t = capped ? cap_l * tanhf(x[u] * inv_cap) : x[u] * kDecodeLog2e;
          if (all_masked) t = kNegInf;
          // not a key of this block: weight exactly 0
          if (!live[u] || key0 + (i + u) * W * KPI >= ke) t = -INFINITY;
          x[u] = t;
          m_new = fmaxf(m_new, t);
        }
        const float alpha = exp2_ftz(m_g[g] - m_new);
        m_g[g] = m_new;
        float p[U], psum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[u] = exp2_ftz(x[u] - m_new);
          psum += p[u];
        }
        l_g[g] = l_g[g] * alpha + psum;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          float a = acc[g][e] * alpha;
#pragma unroll
          for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][e], a);
          acc[g][e] = a;
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");

    // ---- merge the key slots of the warp (lanes LPK apart) -----------------
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m_g[g], off);
        const float lo_ = __shfl_xor_sync(0xffffffffu, l_g[g], off);
        const float mm = fmaxf(m_g[g], mo);
        const float fa = exp2_ftz(m_g[g] - mm), fb = exp2_ftz(mo - mm);
        l_g[g] = l_g[g] * fa + lo_ * fb;
        m_g[g] = mm;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
          acc[g][e] = acc[g][e] * fa + ao * fb;
        }
      }
    }

    // ---- the warps' results into shared memory (the ring is free now) ------
    __syncthreads();
    if (slot == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= nh) break;
        float* r = red + (warp * G + g) * (D + 2);
#pragma unroll
        for (int s = 0; s < SPL; ++s)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            r[(seg + s * LPK) * VEC + e] = acc[g][s * VEC + e];
        if (seg == 0) {
          r[D] = m_g[g];
          r[D + 1] = l_g[g];
        }
      }
    }
    __syncthreads();
  }

  // ---- merge the warps: the output, or this split's partial ----------------
  for (int i = threadIdx.x; i < nh * D; i += kDecodeThreads) {
    const int g = i / D, d = i % D;
    float mm = -INFINITY, a = 0.f, l = 0.f;  // an empty split: weight 0
    if (kb < ke) {
      mm = kNegInf;
#pragma unroll
      for (int w = 0; w < W; ++w)
        mm = fmaxf(mm, red[(w * G + g) * (D + 2) + D]);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float* r = red + (w * G + g) * (D + 2);
        const float f = exp2_ftz(r[D] - mm);
        a += f * r[d];
        l += f * r[D + 1];
      }
    }
    const int64_t bh = static_cast<int64_t>(b) * H + h0 + g;
    if (n_splits == 1) {
      Elem<T>::store(out + bh * D + d, a / (l == 0.f ? 1.f : l));
    } else {
      const int64_t idx = bh * n_splits + split;
      part_acc[idx * D + d] = a;
      if (d == 0) {
        part_m[idx] = mm;
        part_l[idx] = l;
      }
    }
  }
  if (n_splits == 1) return;

  // ---- the last split of this (row, head block) to finish merges them ------
  __shared__ int last;
  __threadfence();  // this block's partials are visible before it counts in
  __syncthreads();
  int* counter = counters + static_cast<int64_t>(b) * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < nh * D; i += kDecodeThreads) {
    const int g = i / D, d = i % D;
    const int64_t bh = static_cast<int64_t>(b) * H + h0 + g;
    const float* pm = part_m + bh * n_splits;
    const float* pl = part_l + bh * n_splits;
    const float* pa = part_acc + bh * n_splits * D + d;
    float mm = -INFINITY;
    for (int sp = 0; sp < n_splits; ++sp) mm = fmaxf(mm, __ldcg(pm + sp));
    float a = 0.f, l = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) {
      const float f = exp2_ftz(__ldcg(pm + sp) - mm);
      a += f * __ldcg(pa + sp * D);
      l += f * __ldcg(pl + sp);
    }
    Elem<T>::store(out + bh * D + d, a / (l == 0.f ? 1.f : l));
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

template <typename T, int D, int G>
int launch_decode(const void* q, const void* kc, const void* vc,
                  const int* lengths, void* out, float* part_m, float* part_l,
                  float* part_acc, int* counters, int B, int S, int H, int KV,
                  int hpb, int n_splits, int chunk, int window, float cap,
                  float scale, cudaStream_t stream) {
  using C = DecodeCfg<T, D>;
  const int group = H / KV;
  auto kern = flash_decode_kernel<T, D, G>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid(n_splits, KV * ((group + hpb - 1) / hpb), B);
  kern<<<grid, kDecodeThreads, C::SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lengths, static_cast<T*>(out), part_m, part_l,
      part_acc, counters, S, H, KV, group, hpb, n_splits, chunk, window, cap,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_heads(const void* q, const void* kc, const void* vc, const int* lengths,
             void* out, float* part_m, float* part_l, float* part_acc,
             int* counters, int B, int S, int H, int KV, int hpb, int n_splits,
             int chunk, int window, float cap, float scale,
             cudaStream_t stream) {
#define RT_DECODE_G(GG)                                                        \
  if (hpb <= GG)                                                               \
    return launch_decode<T, D, GG>(q, kc, vc, lengths, out, part_m, part_l,    \
                                   part_acc, counters, B, S, H, KV, hpb,       \
                                   n_splits, chunk, window, cap, scale,        \
                                   stream);
  RT_DECODE_G(1)
  RT_DECODE_G(2)
  RT_DECODE_G(4)
  RT_DECODE_G(8)
#undef RT_DECODE_G
  return -1;
}

template <typename T>
int dispatch_decode(int D, const void* q, const void* kc, const void* vc,
                    const int* lengths, void* out, float* part_m,
                    float* part_l, float* part_acc, int* counters, int B,
                    int S, int H, int KV, int hpb, int n_splits, int chunk,
                    int window, float cap, float scale, cudaStream_t stream) {
#define RT_DECODE_CASE(DD)                                                     \
  case DD:                                                                     \
    return by_heads<T, DD>(q, kc, vc, lengths, out, part_m, part_l, part_acc,  \
                           counters, B, S, H, KV, hpb, n_splits, chunk,        \
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

// A split's chunk of keys is a multiple of this.
extern "C" int rt_flash_decode_tile(void) { return rt::kDecodeTile; }

// dtype: 0 = float32, 1 = bfloat16.  A block serves `heads_per_block` q heads
// of one kv head (at most 8; the group is cut into ceil(group / that) head
// blocks) and one chunk of `chunk` keys, as the wrapper's plan chose them
// (`head_blocks`, `split_plan` in kernels/flash_decode.py).  For n_splits > 1:
// part_m, part_l [B,H,n_splits] and part_acc [B,H,n_splits,D] are f32
// scratch, and `counters` holds B * KV * ceil(group / heads_per_block) int32
// that are 0 before the launch and 0 again after it (the last split of each
// (row, head block) resets its own), so launches that share them must not
// run at once.  All four are unused (may be null) for n_splits == 1.
// Returns cudaGetLastError() after the launch (0 on success), -1 for a
// head_dim, dtype, head block or chunk the kernel does not take.  Launches
// on `stream`, does not synchronise, allocates nothing.
extern "C" int rt_flash_decode(const void* q, const void* kc, const void* vc,
                               const void* lengths, void* out, void* part_m,
                               void* part_l, void* part_acc, void* counters,
                               int B, int S, int H, int KV, int D, int dtype,
                               int heads_per_block, int n_splits, int chunk,
                               int window, float cap, float scale,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  int* cnt = static_cast<int*>(counters);
  const int hpb = heads_per_block;
  if (chunk % rt::kDecodeTile != 0 || hpb < 1 || hpb > rt::kDecodeMaxHeads)
    return -1;
  if (dtype == 0)
    return rt::dispatch_decode<float>(D, q, kc, vc, len, out, pm, pl, pa, cnt,
                                      B, S, H, KV, hpb, n_splits, chunk,
                                      window, cap, scale, st);
  if (dtype == 1)
    return rt::dispatch_decode<__nv_bfloat16>(D, q, kc, vc, len, out, pm, pl,
                                              pa, cnt, B, S, H, KV, hpb,
                                              n_splits, chunk, window, cap,
                                              scale, st);
  return -1;
}
