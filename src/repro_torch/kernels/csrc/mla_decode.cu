// Latent attention's decode (DeepSeek-V2, arXiv:2405.04434 §2.1, the
// absorbed form) for bf16 on Hopper's tensor cores (sm_90a), written by hand.
// No counterpart in src/repro: the JAX package has no latent attention.
//
// One query token a row, 16 heads a block, against the row's latent cache:
//   out[b, h, :] = sum_j softmax_j(scale * q[b, h, :] . c[b, j, :]) c[b, j, :DL]
// q [B, H, D] (D = DL + DR: the query absorbed into the latent, 512, and its
// roped part, 64), cache [B, S, D] (the normalised latent and the roped key
// of each token, shared by every head), lengths [B] (keys in range, the
// current token included), out [B, H, DL].  Every head reads the same keys,
// so a block takes all 16 heads of a row (one m16 tile) and reads each key
// once for them: the scores Q K^T (16 x 64 a tile, depth 576) and the output
// P V (16 x 512, depth 64) are mma.sync m16n8k16 products, bf16 in, f32 out.
//
// What bounds it.  A key is 1 152 bytes and used for 2 x 16 x (576 + 512)
// operations, about 30 a byte, far under the card's ridge: the kernel is
// bound by reading the cache.  So:
//   * the keys of a row are split over blocks (`n_splits` chunks of `chunk`
//     keys; a block whose chunk lies past the row's length reads nothing), so
//     that a batch of rows fills the SMs;
//   * a block of 8 warps walks its chunk in tiles of 64 keys through a
//     two-stage cp.async ring (73.7 KB a stage): tile u + 1 loads while tile
//     u computes;
//   * warp w computes the scores of keys 8w ... 8w + 7 of the tile over the
//     whole depth (Q from shared memory by ldmatrix), then the block's
//     warps share the scores through shared memory; two rows a warp take the
//     online softmax (row max and sum by shuffles within 16 lanes), write P
//     as bf16 and each row's rescale factor; then warp w accumulates columns
//     64w ... 64w + 63 of the output, P V with V the tile's first 512
//     columns (ldmatrix.trans), its O in registers;
//   * the splits of a row are merged by the last of its blocks to finish (an
//     atomic counter that it resets to 0), as the flash-decode kernel does.
// Scores are in log2 units (scale times log2 e); P is rounded to bf16 for
// the product, l summed from the f32 P, so an output moves by at most about
// 2^-8 of the largest |c|.
#include "common.cuh"

namespace rt {
namespace mla {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int DL = 512;         // the latent: values and the absorbed keys
constexpr int DR = 64;          // the roped key
constexpr int D = DL + DR;      // a cache row
constexpr int HT = 16;          // heads a block (one m16 tile)
constexpr int BK = 64;          // keys a tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int LDS = D + 8;      // bf16 elements a shared row (ldmatrix free
                                // of bank conflicts)
constexpr int LDSS = BK + 4;    // f32 elements a row of the scores
constexpr int LDP = BK + 8;     // bf16 elements a row of P
constexpr int STAGES = 2;
constexpr int COLS = DL / WARPS;  // output columns a warp: 64
constexpr int MAX_SPLITS = 64;
// Q, the ring, the scores, P, and each row's m, l and rescale factor
constexpr int SMEM_BYTES = (HT + STAGES * BK) * LDS * 2 + HT * LDSS * 4 +
                           HT * LDP * 2 + 3 * HT * 4;
static_assert(BK == 8 * WARPS, "a warp scores 8 keys of a tile");
static_assert(MAX_SPLITS * HT * 4 <= STAGES * BK * LDS * 2,
              "the merge's weights fit the ring");

// Rows [row0, row0 + ROWS) of a [*, D] bf16 slice (row stride D) into shared
// memory with row stride LDS; rows at or beyond `n_rows` are zero-filled and
// read nothing.
template <int ROWS>
__device__ __forceinline__ void cp_rows(uint32_t s_addr, const bf16* gmem,
                                        int row0, int n_rows) {
  constexpr int CH = D / 8;  // 72 chunks of 16 bytes a row
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async16(s_addr + (r * LDS + c) * 2,
               ok ? gmem + static_cast<int64_t>(row0 + r) * D + c : gmem,
               ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
mla_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ cache,
                  const int* __restrict__ lengths, bf16* __restrict__ out,
                  float* __restrict__ part_m, float* __restrict__ part_l,
                  float* __restrict__ part_acc, int* __restrict__ counters,
                  int S, int H, int n_splits, int chunk, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + HT * LDS;                               // [STAGES][BK][LDS]
  float* sS = reinterpret_cast<float*>(sK + STAGES * BK * LDS);  // [HT][LDSS]
  bf16* sP = reinterpret_cast<bf16*>(sS + HT * LDSS);     // [HT][LDP]
  float* sM = reinterpret_cast<float*>(sP + HT * LDP);    // [HT] running max
  float* sL = sM + HT;                                    // [HT] running sum
  float* sA = sL + HT;                                    // [HT] rescale

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x, ht = blockIdx.y, b = blockIdx.z;
  const int len = min(lengths[b], S);
  const int k_lo = split * chunk;
  const int k_hi = min(len, k_lo + chunk);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  const bf16* c_base = cache + static_cast<int64_t>(b) * S * D;
  const int64_t row_head = static_cast<int64_t>(b) * H + ht * HT;

  if (threadIdx.x < HT) {
    sM[threadIdx.x] = -INFINITY;
    sL[threadIdx.x] = 0.f;
  }
  const uint32_t sK_addr = smem_addr(sK);
  cp_rows<HT>(smem_addr(sQ), q + row_head * D, 0, HT);
  if (n_tiles > 0) cp_rows<BK>(sK_addr, c_base, k_lo, k_hi);
  cp_async_commit();

  // lane addressing of the ldmatrix loads: A of Q and of P (rows lane & 15,
  // column +8 for lanes 16-31); B of K over four k8 pieces of one n8 tile
  // (key lane & 7, column 8 (lane >> 3)); B of V transposed (key +8 for
  // lanes 8-15 and 24-31, column +8 for lanes 16-31)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7), v_col = (lane >> 4) * 8;
  const uint32_t sQ_lane = smem_addr(sQ + a_row * LDS + a_col);
  const uint32_t sP_lane = smem_addr(sP + a_row * LDP + a_col);

  float o[COLS / 8][4];
#pragma unroll
  for (int n = 0; n < COLS / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const float s_mul = scale * kLog2e;

  for (int u = 0; u < n_tiles; ++u) {
    cp_async_wait<0>();  // tile u has landed
    __syncthreads();     // ... for every thread; tile u - 1 is not read now
    if (u + 1 < n_tiles)
      cp_rows<BK>(sK_addr + ((u + 1) % STAGES) * BK * LDS * 2, c_base,
                  k_lo + (u + 1) * BK, k_hi);
    cp_async_commit();
    const int k0 = k_lo + u * BK;
    const bf16* sT = sK + (u % STAGES) * BK * LDS;

    // ---- scores of keys k0 + 8 warp ... + 7, all 16 heads -------------------
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const uint32_t sKw =
        smem_addr(sT + (warp * 8 + (lane & 7)) * LDS + (lane >> 3) * 8);
#pragma unroll 6
    for (int kd = 0; kd < D / 32; ++kd) {  // two k16 steps a pass
      uint32_t bk[4], a0[4], a1[4];
      ldsm_x4(sKw + kd * 64, bk);
      ldsm_x4(sQ_lane + kd * 64, a0);
      ldsm_x4(sQ_lane + kd * 64 + 32, a1);
      mma_bf16(s, a0, bk[0], bk[1]);
      mma_bf16(s, a1, bk[2], bk[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + warp * 8 + 2 * t4 + (e & 1);
      // keys past the row's length weigh exactly 0
      const float v = key < k_hi ? s[e] * s_mul : -INFINITY;
      sS[(g8 + (e >> 1) * 8) * LDSS + warp * 8 + 2 * t4 + (e & 1)] = v;
    }
    __syncthreads();

    // ---- online softmax: rows 2 warp and 2 warp + 1, 16 lanes a row ---------
    {
      const int row = 2 * warp + (lane >> 4), c0 = (lane & 15) * 4;
      const float4 sv = *reinterpret_cast<const float4*>(sS + row * LDSS + c0);
      float mx = fmaxf(fmaxf(sv.x, sv.y), fmaxf(sv.z, sv.w));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, mx);  // finite: key k0 is in range
      const float p0 = exp2_ftz(sv.x - m_new), p1 = exp2_ftz(sv.y - m_new),
                  p2 = exp2_ftz(sv.z - m_new), p3 = exp2_ftz(sv.w - m_new);
      uint2 pk;
      pk.x = pack_bf16(p0, p1);
      pk.y = pack_bf16(p2, p3);
      *reinterpret_cast<uint2*>(sP + row * LDP + c0) = pk;
      float sum = (p0 + p1) + (p2 + p3);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if ((lane & 15) == 0) {
        const float alpha = exp2_ftz(m_old - m_new);
        sA[row] = alpha;
        sL[row] = sL[row] * alpha + sum;
        sM[row] = m_new;
      }
    }
    __syncthreads();

    // ---- O = alpha O + P V over this warp's 64 columns ----------------------
    const float al0 = sA[g8], al1 = sA[g8 + 8];
#pragma unroll
    for (int n = 0; n < COLS / 8; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
    const uint32_t sV_lane =
        smem_addr(sT + v_row * LDS + warp * COLS + v_col);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(sP_lane + kk * 32, a);
#pragma unroll
      for (int dp = 0; dp < COLS / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(sV_lane + (kk * 16 * LDS + dp * 16) * 2, bv);
        mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int r0 = g8, r1 = g8 + 8;
  const int col = warp * COLS + 2 * t4;
  if (n_splits == 1) {
    const float i0 = 1.f / (sL[r0] == 0.f ? 1.f : sL[r0]);
    const float i1 = 1.f / (sL[r1] == 0.f ? 1.f : sL[r1]);
    bf16* ob = out + row_head * DL;
#pragma unroll
    for (int n = 0; n < COLS / 8; ++n) {
      *reinterpret_cast<uint32_t*>(ob + r0 * DL + col + n * 8) =
          pack_bf16(o[n][0] * i0, o[n][1] * i0);
      *reinterpret_cast<uint32_t*>(ob + r1 * DL + col + n * 8) =
          pack_bf16(o[n][2] * i1, o[n][3] * i1);
    }
    return;
  }

  // ---- this split's partial: O unnormalised, m, l ---------------------------
  const int64_t pidx = (row_head / HT * n_splits + split) * HT;  // first row
  float* pa = part_acc + pidx * DL;
#pragma unroll
  for (int n = 0; n < COLS / 8; ++n) {
    *reinterpret_cast<float2*>(pa + r0 * DL + col + n * 8) =
        make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(pa + r1 * DL + col + n * 8) =
        make_float2(o[n][2], o[n][3]);
  }
  if (threadIdx.x < HT) {
    part_m[pidx + threadIdx.x] = sM[threadIdx.x];
    part_l[pidx + threadIdx.x] = sL[threadIdx.x];
  }

  // ---- the last split of this (row, head tile) to finish merges them --------
  __shared__ int last;
  __threadfence();  // this block's partials are visible before it counts in
  __syncthreads();
  int* counter = counters + row_head / HT;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int64_t first = row_head / HT * n_splits * HT;  // split 0, row 0
  float* sW = reinterpret_cast<float*>(sK);  // [n_splits][HT] weights
  if (threadIdx.x < HT) {
    const int r = threadIdx.x;
    float mm = -INFINITY;
    for (int sp = 0; sp < n_splits; ++sp)
      mm = fmaxf(mm, __ldcg(part_m + first + sp * HT + r));
    float l = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) {
      const float f = exp2_ftz(__ldcg(part_m + first + sp * HT + r) - mm);
      sW[sp * HT + r] = f;
      l += f * __ldcg(part_l + first + sp * HT + r);
    }
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    for (int sp = 0; sp < n_splits; ++sp) sW[sp * HT + r] *= inv;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HT * DL / 4; i += THREADS) {
    const int r = i / (DL / 4), c = (i % (DL / 4)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < n_splits; ++sp) {
      const float w = sW[sp * HT + r];
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          part_acc + (first + sp * HT + r) * DL + c));
      acc.x = fmaf(w, v.x, acc.x);
      acc.y = fmaf(w, v.y, acc.y);
      acc.z = fmaf(w, v.z, acc.z);
      acc.w = fmaf(w, v.w, acc.w);
    }
    uint2 pk;
    pk.x = pack_bf16(acc.x, acc.y);
    pk.y = pack_bf16(acc.z, acc.w);
    *reinterpret_cast<uint2*>(out + (row_head + r) * DL + c) = pk;
  }
  if (threadIdx.x == 0) *counter = 0;  // ready for the next launch
}

}  // namespace mla
}  // namespace rt

// q [B, H, 576], cache [B, S, 576], lengths [B] int32, out [B, H, 512], all
// bf16 but the lengths; H a multiple of 16.  With n_splits > 1, part_m and
// part_l hold B * H * n_splits f32 and part_acc B * H * n_splits * 512, and
// `counters` B * H / 16 int32 zeros (left at 0).  Returns
// cudaGetLastError() after the launch, -1 for sizes it does not take.
extern "C" int rt_mla_decode(const void* q, const void* cache,
                             const void* lengths, void* out, void* part_m,
                             void* part_l, void* part_acc, int B, int S, int H,
                             int n_splits, int chunk, void* counters,
                             float scale, void* stream) {
  using namespace rt::mla;
  if (H % HT != 0 || n_splits < 1 || n_splits > MAX_SPLITS ||
      chunk % BK != 0 || static_cast<int64_t>(n_splits) * chunk < S)
    return -1;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid(n_splits, H / HT, B);
  mla_decode_kernel<<<grid, THREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(cache),
      static_cast<const int*>(lengths), static_cast<bf16*>(out),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), static_cast<int*>(counters), S, H,
      n_splits, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}
