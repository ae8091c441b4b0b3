// Flash attention forward for bf16 inputs on Hopper's tensor cores (sm_90a),
// written by hand.  The f32 inputs keep the IEEE-f32 kernel of
// flash_attention.cu; rt_flash_attention there chooses by dtype.
//
// Replaces, for bf16, the Pallas kernel `_flash_kernel` / `flash_attention`
// of src/repro/kernels/flash_attention.py: out = softmax(mask(softcap(
// q k^T scale))) v for q [B,S,H,D], k [B,S,KV,D], v [B,S,KV,DV], H = KV *
// group, by an online softmax over kv tiles, f32 inside.  DV = D but for
// latent attention's expanded prefill (D 192 = 128 + 64 rope, DV 128), whose
// values are narrower than its keys; its scale is not D^-1/2.
//
// What bounds it.  At the serving paths' prefills (S 256-512) the work is a
// fraction of a GFLOP and a few MB, and the kernel is bound by latency and
// instruction issue: every SM runs a handful of warps, and a warp's round
// (products, softmax, the next copies) is a long chain of dependent
// instructions.  A causal q tile near the end of S walks every kv tile
// before it, so the chain of rounds of the longest blocks sets the time; at
// long S the traffic from L2 and the tensor-core rate of mma.sync take over.
// The design:
//   * a block of 8 warps takes one (q tile, q head, row): R row warps of 16 q
//     rows each (q tile 16 R) times WK = 8 / R kv warps.  The q tile's kv
//     tiles go round by round, WK tiles a round, one to each kv warp, so a
//     warp's chain is 1 / WK of the q tile's.  At the end the kv warps'
//     (m, l, O) of each row are merged through shared memory.  The wrapper's
//     plan (kernels/flash_attention.py) takes the largest R whose grid still
//     fills the SMs: R 8 (one kv warp, 128 q rows sharing each K/V tile) for
//     zamba2-1.2b's and long prefills, R 2 (four kv warps) for qwen3-1.7b's;
//     the causal q tiles launch longest first;
//   * Q is copied once by cp.async into shared memory as bf16 (rows padded by
//     8 elements, so ldmatrix is free of bank conflicts) and moved by
//     ldmatrix into A fragments that stay in registers for the whole kv loop
//     (read from shared memory per tile at D 256, where registers run out);
//   * K/V rounds come through a three-stage cp.async ring (rows at or beyond
//     S are zero-filled by a source size of 0): rounds u+1 and u+2 load while
//     round u computes, one block barrier a round.  A thread copies one
//     fixed 16-byte column of rows 256 / (D / 8) apart, so a copy is a
//     compare, a select and two adds;
//   * S = Q K^T and O += P V by mma.sync m16n8k16 (bf16 in, f32 out); scale,
//     soft-cap and mask act on the accumulator fragment in registers, each
//     under one uniform branch, the mask only on tiles that the causal
//     frontier, the window edge or the ragged end cut; row max and sum by two
//     shuffles within the lane quad; 2^x by one ex2.approx.ftz;
//   * P is rounded to bf16 in registers and is itself the A fragment of the
//     P V product (two n8 accumulator tiles are one k16 A tile), so P never
//     goes to shared memory; l is summed from the f32 P.  Rounding P adds at
//     most about 2^-8 |V| to an output.
// wgmma and TMA (64-row warpgroup tiles, a producer warp), 32 q rows a warp
// (two m16 tiles sharing each K/V fragment) and splitting the longest q
// tiles' kv range over blocks are the next steps: zamba2-1.2b's prefill is
// still slower than the library's attention (PERF.md).
//
// Mask semantics are those of the f32 kernel: masked scores are the finite
// -1e30 (a fully masked row is the mean of V), keys at or beyond S weigh
// exactly 0, and the loop runs from the window's lower edge to the causal
// frontier.
#include "common.cuh"

namespace rt {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

template <int D, int DV, int R, int WK, int BK>
struct TcCfg {
  static constexpr int WARPS = R * WK;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * R;       // q rows of a block
  static constexpr int LDS = D + 8;       // bf16 elements per shared row
  static constexpr int STAGES = 3;        // depth of the ring of K/V rounds
  static constexpr bool Q_IN_REGS = D <= 192;
  static constexpr int KD = D / 16;       // k16 steps over the head dim
  static constexpr int NS = BK / 8;       // n8 tiles of a score row block
  static constexpr int NO = DV / 8;       // n8 tiles of an output row block
  static constexpr int LDM = DV + 4;      // f32 row stride of the merge area
  // Q, then STAGES x WK x (K, V) tiles; after the loop the same memory holds
  // every warp's O (16 x LDM f32) and (m, l) of its rows.  The Python plan
  // computes the same.
  static constexpr int LOOP_BYTES = (BQ + STAGES * WK * 2 * BK) * LDS * 2;
  static constexpr int MERGE_BYTES = WARPS * 16 * (LDM + 2) * 4;
  static constexpr int SMEM_BYTES =
      LOOP_BYTES > MERGE_BYTES ? LOOP_BYTES : MERGE_BYTES;
  static_assert(D % 16 == 0 && DV % 16 == 0 && DV <= D && BK % 16 == 0,
                "tile shapes");
};

// The shared memory one block may opt in to (227 KB).
constexpr int kSmemLimit = 232448;

// kv tile of a round: 64 keys with one kv warp or at D 64 and below, else
// 32, halved until three stages of a round fit the shared memory (D 256:
// 32, or 16 with more kv warps; D 192 with four kv warps: 16).  The Python
// plan (`bf16_plan`) computes the same.
template <int D, int DV, int R, int WK>
constexpr int tile_keys() {
  int bk = (WK == 1 || D <= 64) ? 64 : 32;
  while (bk > 16 && (16 * R + 3 * WK * 2 * bk) * (D + 8) * 2 > kSmemLimit)
    bk /= 2;
  return bk;
}

// Rows [row0, row0 + ROWS) of a [n_rows, D] bf16 slice (row stride
// `row_stride` elements) into shared memory at `s_addr` with row stride LDS;
// rows at or beyond n_rows are zero-filled.  Every thread of the block
// issues copies: thread i takes 16-byte column i % (D / 8) of rows i / (D / 8)
// + k THREADS / (D / 8), so its column, its first addresses and their steps
// are fixed and a copy costs a compare, a select and two adds.  (A loop over
// i from threadIdx.x has no trip count the compiler knows; its address
// arithmetic took more instructions than the tile's products.)
template <int D, int ROWS, int LDS, int THREADS>
__device__ __forceinline__ void cp_tile(uint32_t s_addr, const bf16* gmem,
                                        int64_t row_stride, int row0,
                                        int n_rows) {
  constexpr int CH = D / 8;             // 16-byte chunks per row
  if constexpr (THREADS % CH != 0) {
    // D 192: 24 chunks a row do not divide the block, so the chunks go
    // round the threads in order
    for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = row0 + r < n_rows;
      cp_async16(s_addr + (r * LDS + c) * 2,
                 ok ? gmem + static_cast<int64_t>(row0 + r) * row_stride + c
                    : gmem,
                 ok ? 16 : 0);
    }
    return;
  }
  constexpr int RSTEP = THREADS / CH;   // rows between a thread's copies
  constexpr int ITERS = (ROWS + RSTEP - 1) / RSTEP;
  const int r = threadIdx.x / CH, c = (threadIdx.x % CH) * 8;
  const bf16* src = gmem + static_cast<int64_t>(row0 + r) * row_stride + c;
  const uint32_t dst = s_addr + (r * LDS + c) * 2;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    if (ROWS % RSTEP == 0 || r + it * RSTEP < ROWS) {
      const bool ok = row0 + r + it * RSTEP < n_rows;
      cp_async16(dst + it * RSTEP * LDS * 2,
                 ok ? src + it * RSTEP * row_stride : gmem, ok ? 16 : 0);
    }
  }
}

// (The 1 lets ptxas use up to 255 registers; without it ptxas capped the
// D 64 kernels at 128 and spilled.)
template <int D, int DV, int R, int WK, int BK>
__global__ void __launch_bounds__(32 * R * WK, 1)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out,
                            int S, int H, int KV, int group, int causal,
                            int window, float cap, float scale) {
  using C = TcCfg<D, DV, R, WK, BK>;
  constexpr int BQ = C::BQ, LDS = C::LDS, KD = C::KD, NS = C::NS, NO = C::NO,
                LDM = C::LDM, STAGES = C::STAGES;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sKV = sQ + BQ * LDS;  // [STAGES][WK][K, V][BK][LDS]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp % R;    // row warp: q rows 16 wr ... of the q tile
  const int wj = warp / R;    // kv warp: tile wj of every round
  const int g8 = lane >> 2;   // row of the m16n8 fragment (and row + 8)
  const int t4 = lane & 3;    // column pair of the fragment
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int rw = q0 + wr * 16;  // first q row of this warp

  const int64_t q_stride = static_cast<int64_t>(H) * D;
  const int64_t kv_stride = static_cast<int64_t>(KV) * D;
  const int64_t v_stride = static_cast<int64_t>(KV) * DV;
  const bf16* q_base = q + (static_cast<int64_t>(b) * S * H + h) * D;
  const bf16* k_base = k + (static_cast<int64_t>(b) * S * KV + kvh) * D;
  const bf16* v_base = v + (static_cast<int64_t>(b) * S * KV + kvh) * DV;

  // kv range this q tile can see.  window == 0 masks every key; the row is
  // then the mean of V over all keys, so the whole range is visited.
  int k_lo = 0, k_hi = S;
  if (window != 0) {
    if (causal) k_hi = min(S, q0 + BQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  const int t_begin = k_lo / BK;
  const int t_end = (k_hi + BK - 1) / BK;
  const int n_rounds = (t_end - t_begin + WK - 1) / WK;

  const uint32_t sKV_addr = smem_addr(sKV);
  auto load_round = [&](int u) {
    const uint32_t st = sKV_addr + (u % STAGES) * WK * 2 * BK * LDS * 2;
#pragma unroll
    for (int j = 0; j < WK; ++j) {
      const int t = t_begin + u * WK + j;
      if (t < t_end) {
        cp_tile<D, BK, LDS, C::THREADS>(st + j * 2 * BK * LDS * 2, k_base,
                                        kv_stride, t * BK, S);
        cp_tile<DV, BK, LDS, C::THREADS>(st + (j * 2 + 1) * BK * LDS * 2,
                                         v_base, v_stride, t * BK, S);
      }
    }
  };
  cp_tile<D, BQ, LDS, C::THREADS>(smem_addr(sQ), q_base, q_stride, q0, S);
  cp_async_commit();
#pragma unroll
  for (int u = 0; u < STAGES - 1; ++u) {
    if (u < n_rounds) load_round(u);
    cp_async_commit();
  }

  // lane addressing of the ldmatrix x4 loads (see the fragment layouts of
  // mma.m16n8k16): A of Q: row lane & 15, column +8 for lanes 16-31; B of K
  // (non-transposed): key +8 for lanes 16-31, column +8 for lanes 8-15 and
  // 24-31; B of V (transposed): key +8 for lanes 8-15 and 24-31, column +8
  // for lanes 16-31.
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = (lane >> 4) * 8 + (lane & 7), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7), v_col = (lane >> 4) * 8;
  const uint32_t sQ_warp = smem_addr(sQ + (wr * 16 + a_row) * LDS + a_col);

  uint32_t qf[C::Q_IN_REGS ? KD : 1][4];
  cp_async_wait<STAGES - 1>();  // Q has landed (rounds may be in flight)
  __syncthreads();
  if constexpr (C::Q_IN_REGS) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) ldsm_x4(sQ_warp + kd * 32, qf[kd]);
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  const bool capped = cap > 0.f;
  const float s_mul = capped ? scale / cap : scale * kLog2e;
  const float cap_l = cap * kLog2e;

  for (int u = 0; u < n_rounds; ++u) {
    cp_async_wait<STAGES - 2>();  // round u has landed
    __syncthreads();  // ... for every thread; round u-1 is no longer read,
                      // so its stage takes round u + STAGES - 1
    if (u + STAGES - 1 < n_rounds) load_round(u + STAGES - 1);
    cp_async_commit();

    const int t = t_begin + u * WK + wj;
    const int k0 = t * BK;
    if (t >= t_end || rw >= S) continue;  // no tile, or rows not written
    // this warp's rows see none of this tile: the causal frontier, or the
    // window's lower edge, lies beyond it (exact: such keys weigh 0 once the
    // row has seen a visible key, and the merge weighs a warp that saw none
    // by 0)
    if (window != 0 && ((causal && k0 > rw + 15) ||
                        (window > 0 && k0 + BK - 1 < rw - window + 1)))
      continue;

    const bf16* sK = sKV + ((u % STAGES) * WK + wj) * 2 * BK * LDS;
    const uint32_t sK_lane = smem_addr(sK + k_row * LDS + k_col);
    const uint32_t sV_lane = smem_addr(sK + BK * LDS + v_row * LDS + v_col);

    // ---- S = Q K^T, 16 x BK per warp -----------------------------------------
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      if constexpr (C::Q_IN_REGS) {
        a[0] = qf[kd][0]; a[1] = qf[kd][1]; a[2] = qf[kd][2]; a[3] = qf[kd][3];
      } else {
        ldsm_x4(sQ_warp + kd * 32, a);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(sK_lane + (np * 16 * LDS + kd * 16) * 2, bk);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // ---- scale, soft-cap, mask (log2 units); each branch is uniform ---------
    if (capped) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = cap_l * tanhf(s[n][e] * s_mul);
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= s_mul;
    }
    if (k0 + BK > S || window == 0 || (causal && k0 + BK - 1 > rw) ||
        (window > 0 && rw + 15 - k0 >= window)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t4 + (e & 1);
          const int dist = rw + g8 + (e >> 1) * 8 - key;
          const bool ok = (!causal || dist >= 0) && (window < 0 || dist < window);
          // keys beyond S do not exist: weight exactly 0, unlike masked keys
          s[n][e] = key >= S ? -INFINITY : (ok ? s[n][e] : kNegInf);
        }
    }

    // ---- online softmax over the two rows this lane holds ---------------------
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      const float alpha = exp2_ftz(m_r[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][2 * r] = exp2_ftz(s[n][2 * r] - m_new);
        s[n][2 * r + 1] = exp2_ftz(s[n][2 * r + 1] - m_new);
        sum += s[n][2 * r] + s[n][2 * r + 1];
      }
      // l is a per-lane partial sum; alpha is the same for the quad, so the
      // partials are summed once, at the end
      l_r[r] = l_r[r] * alpha + sum;
      m_r[r] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    // ---- O += P V: P from registers, V by ldmatrix.trans --------------------
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(sV_lane + (kk * 16 * LDS + dp * 16) * 2, bv);
        mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }

  // ---- merge the kv warps of each row and write --------------------------------
  // Every warp's O, m and l go to shared memory (over Q and the ring, which
  // no warp reads any more).  One thread a row turns the kv warps' (m, l)
  // into weights w_j = 2^(m_j - M) / sum_k 2^(m_k - M) l_k; then each output
  // element is sum_j w_j O_j.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* mO = reinterpret_cast<float*>(smem_raw);   // [WARPS][16][LDM]
  float* mML = mO + C::WARPS * 16 * LDM;             // [WARPS][16][m, l]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g8 + 8 * r;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(mO + row * LDM + n * 8 + 2 * t4) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
    if (t4 == 0) {
      mML[2 * row] = m_r[r];
      mML[2 * row + 1] = l_r[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < BQ) {  // row threadIdx.x of the q tile: weights in place of m
    const int rg = threadIdx.x / 16, rr = threadIdx.x % 16;
    float mm = kNegInf;
#pragma unroll
    for (int j = 0; j < WK; ++j)
      mm = fmaxf(mm, mML[2 * ((j * R + rg) * 16 + rr)]);
    float f[WK], l = 0.f;
#pragma unroll
    for (int j = 0; j < WK; ++j) {
      const int wrow = (j * R + rg) * 16 + rr;
      f[j] = exp2_ftz(mML[2 * wrow] - mm);
      l += f[j] * mML[2 * wrow + 1];
    }
    const float inv = __frcp_rn(l == 0.f ? 1.f : l);
#pragma unroll
    for (int j = 0; j < WK; ++j) mML[2 * ((j * R + rg) * 16 + rr)] = f[j] * inv;
  }
  __syncthreads();
  const int64_t o_stride = static_cast<int64_t>(H) * DV;
  bf16* o_base = out + static_cast<int64_t>(b) * S * o_stride +
                 static_cast<int64_t>(h) * DV;
  constexpr int CP = DV / 2;                // column pairs of a row
  constexpr int ROW_STEP = C::THREADS / CP;  // rows a pass of the block
  static_assert(C::THREADS % CP == 0 && BQ % ROW_STEP == 0, "merge passes");
  const int c = (threadIdx.x % CP) * 2;
#pragma unroll
  for (int it = 0; it < BQ / ROW_STEP; ++it) {
    const int row = threadIdx.x / CP + it * ROW_STEP;
    const int rg = row / 16, rr = row % 16;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int j = 0; j < WK; ++j) {
      const int wrow = (j * R + rg) * 16 + rr;
      const float w = mML[2 * wrow];
      const float2 ov = *reinterpret_cast<const float2*>(mO + wrow * LDM + c);
      a0 = fmaf(w, ov.x, a0);
      a1 = fmaf(w, ov.y, a1);
    }
    if (q0 + row < S)
      *reinterpret_cast<uint32_t*>(o_base + (q0 + row) * o_stride + c) =
          pack_bf16(a0, a1);
  }
}

template <int D, int DV, int R, int WK, int BK>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int causal, int window, float cap,
           float scale, cudaStream_t stream) {
  using C = TcCfg<D, DV, R, WK, BK>;
  auto kern = flash_attention_bf16_kernel<D, DV, R, WK, BK>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
  kern<<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, KV, H / KV,
      causal, window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DV>
int by_rows(int bq, int wk, int bk, const void* q, const void* k,
            const void* v, void* out, int B, int S, int H, int KV, int causal,
            int window, float cap, float scale, cudaStream_t stream) {
#define RT_TC_CASE(RR, WW)                                                     \
  if (bq == 16 * RR && wk == WW && bk == tile_keys<D, DV, RR, WW>())           \
    return launch<D, DV, RR, WW, tile_keys<D, DV, RR, WW>()>(                  \
        q, k, v, out, B, S, H, KV, causal, window, cap, scale, stream);
  RT_TC_CASE(8, 1)
  RT_TC_CASE(4, 2)
  RT_TC_CASE(2, 4)
#undef RT_TC_CASE
  return -1;
}

}  // namespace tc

// bf16 entry, called by rt_flash_attention: the tiles the plan chose, `bq`
// q rows (16 per row warp) with `wk` kv warps (8 warps in all) and kv tiles
// of `bk` keys.  -1 for any combination the kernel is not built for.
int flash_attention_bf16(int D, int DV, int bq, int wk, int bk, const void* q,
                         const void* k, const void* v, void* out, int B, int S,
                         int H, int KV, int causal, int window, float cap,
                         float scale, cudaStream_t stream) {
  if (D == 192 && DV == 128)  // latent attention's expanded prefill
    return tc::by_rows<192, 128>(bq, wk, bk, q, k, v, out, B, S, H, KV,
                                 causal, window, cap, scale, stream);
  if (DV != D) return -1;
  switch (D) {
#define RT_TC_D(DD)                                                            \
  case DD:                                                                     \
    return tc::by_rows<DD, DD>(bq, wk, bk, q, k, v, out, B, S, H, KV, causal,  \
                               window, cap, scale, stream);
    RT_TC_D(16)
    RT_TC_D(32)
    RT_TC_D(64)
    RT_TC_D(128)
    RT_TC_D(256)
#undef RT_TC_D
    default:
      return -1;
  }
}

}  // namespace rt
