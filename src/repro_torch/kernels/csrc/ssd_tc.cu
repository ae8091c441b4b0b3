// SSD (Mamba2) intra-chunk tile for bf16 inputs on Hopper's tensor cores
// (sm_90a), written by hand.  f32 inputs, and bf16 inputs whose pointers the
// 16- and 8-byte copies below cannot take, keep the IEEE-f32 kernel of
// ssd.cu; kernels/ssd.py chooses.
//
// Replaces, for bf16, the Pallas kernel `_ssd_kernel` / `ssd_intra` of
// src/repro/kernels/ssd.py.  For xh [B,S,nh,hp], dt [B,S,nh] (f32), A [nh]
// (f32, < 0) and Bp / Cp [B,S,N] (one group: shared by all heads), per
// (batch, head, chunk of q steps):
//     cum     = cumsum(dt * A)                            over the chunk
//     y_intra = (L o (C B^T) o dt_s) x,   L[t,s] = exp(cum_t - cum_s), t >= s
//     s_chunk = (x * dt * exp(cum_last - cum))^T B        [hp, N]
//     decay   = exp(cum_last)
// Out, all f32: y [B,S,nh,hp], s_chunk [B,nc,nh,hp,N], decay [B,nc,nh] and
// cum [B,nc,q,nh], as ssd.cu writes them.
//
// What bounds it.  At the serving paths' prefills (S 512, 48 or 64 heads of
// 64) the function moves about 13 MB and does about 2 GFLOP, a few
// microseconds either way; what a kernel has to beat is latency: enough
// blocks in flight, and a short chain of dependent steps in the longest.
// The design:
//   * work items, not one block per (batch, head, chunk): a block of 4 warps
//     takes either one 64-row t tile (or a long and a short one, `pair`) of
//     one (batch, chunk) for a group of G consecutive heads, or the s_chunk,
//     cum and decay of one (batch, chunk, head).  The grid is (head groups,
//     batch x chunks, y slots + G): blockIdx.z 0 is the longest t tile,
//     1..G the s_chunk items, then the shorter t tiles, so the longest work
//     starts first.  kernels/ssd.py's `ssd_plan` picks G and `pair` and
//     mirrors this decoding (`SsdPlan.block`), which the CPU tests check;
//   * every block computes cum for its chunk and heads by the same scan in
//     the same order (a lane sums 2-8 consecutive steps, then a warp scan of
//     the lanes' totals), so all blocks see the same cum bit for bit; only
//     the s_chunk item writes cum and decay;
//   * C B^T of a warp's 16 rows x the s tile is one accumulator fragment in
//     registers, computed once per s tile and used for all G heads (exact
//     bf16 operands, f32 sums: as accurate as the CUDA cores);
//   * per head, P' = (C B^T) o L o dt_s is formed in f32 in registers (the
//     causal mask only on the diagonal tile; nothing above the diagonal is
//     weighted).  Below the diagonal, with r the s tile's last step,
//     L dt_s = exp(cum_t - cum_r) * (exp(cum_r - cum_s) dt_s): one exp per
//     row and a table per step, made once a block, both factors at most 1,
//     so the inner loop has no exp; the diagonal tile exponentiates each
//     pair, by one ex2.approx (rounding the argument, |cum_t - cum_s| log2 e,
//     moves a weight by |cum_t - cum_s| 8.6e-8 relatively, below 2e-6
//     wherever the weight is above 1e-7).  P' is split into hi = bf16(P')
//     and lo = bf16(P' - hi): two mma.sync m16n8k16 with the exact bf16 x
//     tile (ldmatrix.trans) give P' x within about 2^-17 of P' x in f32.
//     Rounding P' once would cost 2^-9, above K3's limit
//     (tests/test_torch_ssd_numerics.py);
//   * s_chunk as (x o dt w)^T B: the x^T fragment comes by ldmatrix.trans,
//     is scaled by dt exp(cum_last - cum) in registers and split the same
//     way; B is exact;
//   * B, C and x tiles come through a two-stage cp.async ring (16-byte
//     copies, 8-byte where N is not a multiple of 8), zero-filled beyond the
//     chunk's valid steps and beyond N up to a multiple of 16 in shared
//     memory, never padded in device memory.  A thread finds its first
//     (row, column) of a tile by one division and steps by adds.
// wgmma (64-row warpgroup tiles from shared memory), a backward and the
// inter-chunk recurrence as a kernel are what K3 still lacks.
#include "common.cuh"

namespace rt {
namespace ssdtc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps of 16 t rows (y) or 16 p rows (s)
constexpr int kTile = 64;      // steps in a t tile and in an s tile
constexpr int kStages = 2;     // depth of the ring of s tiles
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// Shared memory of one block in bytes: dt, cum and the y weights of the
// off-diagonal tiles ([G][QP] f32 each) and the s_chunk weights ([QP] f32);
// the C tile; kStages x (B tile, x tile), bf16, rows padded by 8 elements so
// that ldmatrix is free of bank conflicts.  kernels/ssd.py's ssd_plan
// computes the same.
__host__ __device__ inline int smem_bytes(int hp, int g, int q, int n) {
  const int qp = (q + kTile - 1) / kTile * kTile;
  const int ldb = pad16(n) + 8, ldx = g * hp + 8;
  return 4 * (3 * g * qp + qp) + 2 * kTile * ldb +
         kStages * 2 * kTile * (ldb + ldx);
}

// Rows [row0, row0 + kTile) of a bf16 slice whose rows lie `stride`
// elements apart into shared memory at `dst` (row stride `ld` elements), as
// `alloc` columns: columns at or beyond `cols` and rows at or beyond
// `n_rows` are zero-filled (source size 0).  `vec` bytes a copy, 16 or 8.
__device__ __forceinline__ void copy_tile(uint32_t dst, int ld,
                                          const bf16* src, int64_t stride,
                                          int row0, int n_rows, int cols,
                                          int alloc, int vec) {
  const int per = vec / 2;  // elements a copy
  const int ch = alloc / per;
  const int total = kTile * ch;
  int r = threadIdx.x / ch, c = threadIdx.x - (threadIdx.x / ch) * ch;
  const int dr = kThreads / ch, dc = kThreads - (kThreads / ch) * ch;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int col = c * per;
    const bool ok = row0 + r < n_rows && col < cols;
    const bf16* s = ok ? src + static_cast<int64_t>(row0 + r) * stride + col
                       : src;
    const uint32_t d = dst + (r * ld + col) * 2;
    if (vec == 16)
      cp_async16(d, s, ok ? 16 : 0);
    else
      cp_async8(d, s, ok ? 8 : 0);
    r += dr;
    c += dc;
    if (c >= ch) {
      c -= ch;
      ++r;
    }
  }
}

// hi = bf16(a, b), lo = bf16(a - hi, b - hi): (a, b) = hi + lo within 2^-17.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16),
                 b - __uint_as_float(hi & 0xffff0000u));
}

// The two bf16 of `u` (low half first) times (w.x, w.y), split as split2.
__device__ __forceinline__ void split_scaled(uint32_t u, float2 w,
                                             uint32_t& hi, uint32_t& lo) {
  split2(__uint_as_float(u << 16) * w.x,
         __uint_as_float(u & 0xffff0000u) * w.y, hi, lo);
}

// exp(c_t - c_s) dt_s by one ex2.approx (the diagonal tile's weights)
__device__ __forceinline__ float decay_w(float c_t, float c_s, float d_s) {
  return exp2_ftz((c_t - c_s) * kLog2e) * d_s;
}

// (The 2 caps ptxas at 255 registers, two blocks an SM; with no minimum it
// capped the G = 1 kernels at 168 and spilled.)
template <int HP, int G>
__global__ void __launch_bounds__(kThreads, 2)
ssd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, float* __restrict__ y,
              float* __restrict__ s_chunk, float* __restrict__ decay,
              float* __restrict__ cum, int S, int nh, int N, int q, int nc,
              int pair, int vec) {
  constexpr int LDX = G * HP + 8;
  const int NP = pad16(N), LDB = NP + 8;
  const int n_tt = (q + kTile - 1) / kTile, QP = n_tt * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;  // fragment row and column pair

  // ---- the work item (SsdPlan.block in kernels/ssd.py decodes the same) ----
  const int b = blockIdx.y / nc, c = blockIdx.y - (blockIdx.y / nc) * nc;
  const int z = blockIdx.z;
  const bool s_item = z >= 1 && z <= G;
  const int head0 = blockIdx.x * G + (s_item ? z - 1 : 0);
  if (head0 >= nh) return;
  const int n_heads = s_item ? 1 : min(G, nh - head0);
  const int pos0 = c * q;
  const int n_valid = min(q, S - pos0);
  int t_a = -1, t_b = -1;  // the y item's t tiles, longest first
  if (!s_item) {
    const int slot = z == 0 ? 0 : z - G;
    const int first = n_tt - 1 - slot;
    const int second = pair && slot < first ? slot : -1;
    t_a = first * kTile < n_valid ? first : second;
    t_b = t_a == first ? second : -1;
    if (t_a < 0) return;  // beyond the ragged last chunk's steps
  }

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* s_dt = reinterpret_cast<float*>(smem_raw);  // [G][QP]
  float* s_cum = s_dt + G * QP;                      // [G][QP]
  float* s_bd = s_cum + G * QP;  // [G][QP] dt exp(cum at tile end - cum)
  float* s_w = s_bd + G * QP;                        // [QP] dt exp(cl - cum)
  bf16* sC = reinterpret_cast<bf16*>(s_w + QP);      // [kTile][LDB]
  bf16* ring = sC + kTile * LDB;  // [kStages][B [kTile][LDB], x [kTile][LDX]]
  const int stage_elems = kTile * (LDB + LDX);

  const int64_t row_x = static_cast<int64_t>(nh) * HP;
  const int64_t row0 = static_cast<int64_t>(b) * S + pos0;
  const bf16* x_chunk = x + row0 * row_x + static_cast<int64_t>(head0) * HP;
  const bf16* b_chunk = Bm + row0 * N;
  const bf16* c_chunk = Cm + row0 * N;
  auto load_s_tile = [&](int st, int stage) {
    const uint32_t base = smem_addr(ring + stage * stage_elems);
    copy_tile(base, LDB, b_chunk, N, st * kTile, n_valid, N, NP, vec);
    copy_tile(base + kTile * LDB * 2, LDX, x_chunk, row_x, st * kTile,
              n_valid, n_heads * HP, n_heads * HP, 16);
  };
  // the first kStages s tiles (and the C tile) are in flight during the
  // scan; one commit group a stage, so that wait<kStages - 1> at s tile st
  // means tile st has landed
  auto issue_first = [&](int tt, int n_st) {
    if (tt >= 0)
      copy_tile(smem_addr(sC), LDB, c_chunk, N, tt * kTile, n_valid, N, NP,
                vec);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      if (i < n_st) load_s_tile(i, i);
      cp_async_commit();
    }
  };
  // ---- dt (loads in flight before the tiles'), then cum by one warp a
  // head: a lane sums QP/32 steps, then a warp scan of the lanes' totals.
  // Every block runs this same code for its heads over the whole chunk, so
  // every block sees the same cum. -------------------------------------------
  constexpr int NDT = G * 256 / kThreads;  // dt values a thread loads, q <= 256
  float dtv[NDT];
#pragma unroll
  for (int i = 0; i < NDT; ++i) {
    const int e = threadIdx.x + i * kThreads, k = e >> 8, j = e & 255;
    dtv[i] = k < n_heads && j < n_valid ? dt[(row0 + j) * nh + head0 + k]
                                        : 0.f;
  }
  const int n_st_valid = (n_valid + kTile - 1) / kTile;
  issue_first(s_item ? -1 : t_a, s_item ? n_st_valid : t_a + 1);
#pragma unroll
  for (int i = 0; i < NDT; ++i) {
    const int e = threadIdx.x + i * kThreads, k = e >> 8, j = e & 255;
    if (j < QP) s_dt[k * QP + j] = dtv[i];
  }
  __syncthreads();
  const int per = QP / 32;
  for (int k = warp; k < n_heads; k += kThreads / 32) {
    const float a = A[head0 + k];
    const float* d = s_dt + k * QP + lane * per;
    float* cm = s_cum + k * QP + lane * per;
    float run = 0.f;
    for (int i = 0; i < per; ++i) {
      run += d[i] * a;
      cm[i] = run;
    }
    float inc = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += u;
    }
    float excl = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) excl = 0.f;
    for (int i = 0; i < per; ++i) cm[i] = excl + cm[i];
  }
  __syncthreads();
  // y weights of the s tiles below the diagonal: with r the s tile's last
  // step, exp(cum_t - cum_s) = exp(cum_t - cum_r) exp(cum_r - cum_s), both
  // factors at most 1 (cum falls); the second, times dt_s, is the same for
  // every t tile
  if (!s_item) {
    for (int k = 0; k < n_heads; ++k)
      for (int j = threadIdx.x; j < QP; j += kThreads)
        s_bd[k * QP + j] = s_dt[k * QP + j] *
                           expf(s_cum[k * QP + (j | (kTile - 1))] -
                                s_cum[k * QP + j]);
    __syncthreads();
  }

  // lane addressing of ldmatrix (fragment layouts of mma.m16n8k16): A of a
  // row-major tile: row lane & 15, column +8 for lanes 16-31; B of a tile
  // stored [n][k]: n +8 for lanes 16-31, k +8 for lanes 8-15 and 24-31; B
  // of a tile stored [k][n] (.trans): k +8 for lanes 8-15 and 24-31, n +8
  // for lanes 16-31; A of a tile stored [k][m] (.trans): k +8 for lanes
  // 16-31, m +8 for lanes 8-15 and 24-31.
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7), v_col = (lane >> 4) * 8;

  if (s_item) {
    // ---- s_chunk, cum and decay of head0 ------------------------------------
    const float cum_last = s_cum[q - 1];
    for (int j = threadIdx.x; j < QP; j += kThreads)
      s_w[j] = s_dt[j] * expf(cum_last - s_cum[j]);
    float* cum_out = cum + static_cast<int64_t>(b * nc + c) * q * nh + head0;
    for (int j = threadIdx.x; j < q; j += kThreads)
      cum_out[static_cast<int64_t>(j) * nh] = s_cum[j];
    if (threadIdx.x == 0) decay[(b * nc + c) * nh + head0] = expf(cum_last);
    __syncthreads();

    constexpr int MT = HP / 16;     // m16 tiles of p
    constexpr int JS = 4 / MT;      // warps that share an m tile
    constexpr int MAXJ = 8 / JS;    // n16 pieces a warp at N 128
    const int mt = warp % MT, jg = warp / MT;
    const int NJ = NP / 16;
    float acc[MAXJ][2][4];
#pragma unroll
    for (int i = 0; i < MAXJ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][0][e] = acc[i][1][e] = 0.f;
    const int xa_row = (lane & 7) + ((lane >> 4) & 1) * 8;
    const int xa_col = mt * 16 + ((lane >> 3) & 1) * 8;
    for (int st = 0; st < n_st_valid; ++st) {
      cp_async_wait<kStages - 1>();
      __syncthreads();  // tile st has landed for every thread
      const bf16* sB = ring + (st % kStages) * stage_elems;
      const bf16* sX = sB + kTile * LDB;
      const uint32_t xa = smem_addr(sX + xa_row * LDX + xa_col);
      const uint32_t bb = smem_addr(sB + v_row * LDB + v_col);
      const float* w = s_w + st * kTile;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t a[4], hi[4], lo[4];
        ldsm_x4_trans(xa + kk * 16 * LDX * 2, a);
        const float* wk = w + kk * 16 + 2 * t4;
        const float2 w0 = *reinterpret_cast<const float2*>(wk);
        const float2 w1 = *reinterpret_cast<const float2*>(wk + 8);
        split_scaled(a[0], w0, hi[0], lo[0]);
        split_scaled(a[1], w0, hi[1], lo[1]);
        split_scaled(a[2], w1, hi[2], lo[2]);
        split_scaled(a[3], w1, hi[3], lo[3]);
#pragma unroll
        for (int i = 0; i < MAXJ; ++i) {
          const int j = jg + JS * i;
          if (j < NJ) {
            uint32_t bv[4];
            ldsm_x4_trans(bb + (kk * 16 * LDB + j * 16) * 2, bv);
            mma_bf16(acc[i][0], hi, bv[0], bv[1]);
            mma_bf16(acc[i][1], hi, bv[2], bv[3]);
            mma_bf16(acc[i][0], lo, bv[0], bv[1]);
            mma_bf16(acc[i][1], lo, bv[2], bv[3]);
          }
        }
      }
      __syncthreads();  // stage st % kStages is no longer read
      if (st + kStages < n_st_valid) load_s_tile(st + kStages, st % kStages);
      cp_async_commit();
    }
    float* sc = s_chunk +
                (static_cast<int64_t>(b * nc + c) * nh + head0) * HP * N;
    const int p = mt * 16 + g8;
#pragma unroll
    for (int i = 0; i < MAXJ; ++i) {
      const int j = jg + JS * i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = j * 16 + h * 8 + 2 * t4;
        if (j < NJ && n < N) {
          *reinterpret_cast<float2*>(sc + p * N + n) =
              make_float2(acc[i][h][0], acc[i][h][1]);
          *reinterpret_cast<float2*>(sc + (p + 8) * N + n) =
              make_float2(acc[i][h][2], acc[i][h][3]);
        }
      }
    }
    return;
  }

  // ---- y rows of the t tile(s) for the heads of the group -------------------
  const uint32_t ca = smem_addr(sC + (warp * 16 + (lane & 15)) * LDB +
                                (lane >> 4) * 8);
  const int k_row = (lane >> 4) * 8 + (lane & 7), k_col = ((lane >> 3) & 1) * 8;
  for (int ti = 0; ti < 2; ++ti) {
    const int tt = ti ? t_b : t_a;
    if (tt < 0) break;
    if (ti > 0) issue_first(tt, tt + 1);  // the ring is drained: restart it
    const int rw = tt * kTile + warp * 16;  // this warp's first row
    const int t_lo = rw + g8, t_hi = t_lo + 8;
    float yacc[G][HP / 8][4];
#pragma unroll
    for (int k = 0; k < G; ++k)
#pragma unroll
      for (int n = 0; n < HP / 8; ++n)
        yacc[k][n][0] = yacc[k][n][1] = yacc[k][n][2] = yacc[k][n][3] = 0.f;

    for (int st = 0; st <= tt; ++st) {
      cp_async_wait<kStages - 1>();
      __syncthreads();  // tile st (and the C tile) has landed
      const bf16* sB = ring + (st % kStages) * stage_elems;
      const bf16* sX = sB + kTile * LDB;
      const int s0 = st * kTile;
      if (rw < n_valid) {
        // C B^T of the warp's 16 rows x 64 steps, once for all heads
        float cb[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          cb[n][0] = cb[n][1] = cb[n][2] = cb[n][3] = 0.f;
        const uint32_t bk = smem_addr(sB + k_row * LDB + k_col);
        for (int kd = 0; kd < NP / 16; ++kd) {
          uint32_t a[4];
          ldsm_x4(ca + kd * 32, a);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bq[4];
            ldsm_x4(bk + (np * 16 * LDB + kd * 16) * 2, bq);
            mma_bf16(cb[2 * np], a, bq[0], bq[1]);
            mma_bf16(cb[2 * np + 1], a, bq[2], bq[3]);
          }
        }
        const bool diag = st == tt;  // the only tile the causal mask cuts
        const uint32_t xb = smem_addr(sX + v_row * LDX + v_col);
#pragma unroll
        for (int k = 0; k < G; ++k) {
          if (k >= n_heads) continue;
          const float* cm = s_cum + k * QP;
          const float* dk = s_dt + k * QP;
          const float* bdk = s_bd + k * QP;
          const float c_lo = cm[t_lo], c_hi = cm[t_hi];
          // below the diagonal: the rows' factor exp(cum_t - cum_r)
          const float c_r = cm[s0 + kTile - 1];
          const float a_lo = diag ? 0.f : expf(c_lo - c_r);
          const float a_hi = diag ? 0.f : expf(c_hi - c_r);
#pragma unroll
          for (int kk = 0; kk < kTile / 16; ++kk) {
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // n8 tiles 2 kk and 2 kk + 1
              const int j = 2 * kk + h;
              const int s = s0 + j * 8 + 2 * t4;
              float p[4];
              if (diag) {  // the causal mask; nothing above it is weighted
                const float2 cs = *reinterpret_cast<const float2*>(cm + s);
                const float2 ds = *reinterpret_cast<const float2*>(dk + s);
                p[0] = s <= t_lo ? cb[j][0] * decay_w(c_lo, cs.x, ds.x) : 0.f;
                p[1] = s < t_lo ? cb[j][1] * decay_w(c_lo, cs.y, ds.y) : 0.f;
                p[2] = s <= t_hi ? cb[j][2] * decay_w(c_hi, cs.x, ds.x) : 0.f;
                p[3] = s < t_hi ? cb[j][3] * decay_w(c_hi, cs.y, ds.y) : 0.f;
              } else {
                const float2 bd = *reinterpret_cast<const float2*>(bdk + s);
                p[0] = cb[j][0] * a_lo * bd.x;
                p[1] = cb[j][1] * a_lo * bd.y;
                p[2] = cb[j][2] * a_hi * bd.x;
                p[3] = cb[j][3] * a_hi * bd.y;
              }
              split2(p[0], p[1], hi[2 * h], lo[2 * h]);
              split2(p[2], p[3], hi[2 * h + 1], lo[2 * h + 1]);
            }
#pragma unroll
            for (int dp = 0; dp < HP / 16; ++dp) {
              uint32_t bv[4];
              ldsm_x4_trans(xb + (kk * 16 * LDX + k * HP + dp * 16) * 2, bv);
              mma_bf16(yacc[k][2 * dp], hi, bv[0], bv[1]);
              mma_bf16(yacc[k][2 * dp + 1], hi, bv[2], bv[3]);
              mma_bf16(yacc[k][2 * dp], lo, bv[0], bv[1]);
              mma_bf16(yacc[k][2 * dp + 1], lo, bv[2], bv[3]);
            }
          }
        }
      }
      __syncthreads();  // stage st % kStages (and, at the end, sC) is free
      if (st + kStages <= tt) load_s_tile(st + kStages, st % kStages);
      cp_async_commit();
    }

#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (k >= n_heads) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = r ? t_hi : t_lo;
        if (t >= n_valid) continue;
        float* yr = y + ((row0 + t) * nh + head0 + k) * HP + 2 * t4;
#pragma unroll
        for (int n = 0; n < HP / 8; ++n)
          *reinterpret_cast<float2*>(yr + n * 8) =
              make_float2(yacc[k][n][2 * r], yacc[k][n][2 * r + 1]);
      }
    }
  }
}

template <int HP, int G>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* s_chunk, void* decay, void* cum,
           int B, int S, int nh, int N, int q, int pair, int vec,
           cudaStream_t stream) {
  auto kern = ssd_tc_kernel<HP, G>;
  const int smem = smem_bytes(HP, G, q, N);
  static int attr_bytes = 48 * 1024;  // opted in so far (per instance)
  if (smem > attr_bytes) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_bytes = smem;
  }
  const int nc = (S + q - 1) / q;
  const int n_tt = (q + kTile - 1) / kTile;
  const int n_slots = pair ? (n_tt + 1) / 2 : n_tt;
  dim3 grid((nh + G - 1) / G, B * nc, n_slots + G);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<float*>(y),
      static_cast<float*>(s_chunk), static_cast<float*>(decay),
      static_cast<float*>(cum), S, nh, N, q, nc, pair, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssdtc
}  // namespace rt

// bf16 x, Bm, Cm (dt, A f32): the launch plan's `heads_per_block` (G: 1-8 at
// hp 16, 1-4 at 32, 1-2 at 64) and `pair`; `vec` = 16 where N is a multiple
// of 8 and B, C are 16-byte aligned, else 8 (x 16-byte aligned, B and C
// 8-byte aligned: kernels/ssd.py checks).  Returns cudaGetLastError() after
// the launch, -1 for sizes the kernel is not built for.  Launches on
// `stream`, does not synchronise, allocates nothing.
extern "C" int rt_ssd_intra_tc(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* s_chunk, void* decay, void* cum, int B,
                               int S, int nh, int hp, int N, int q,
                               int heads_per_block, int pair, int vec,
                               void* stream) {
  if (N <= 0 || N % 4 != 0 || N > 128 || q <= 0 || S <= 0 ||
      (vec != 16 && vec != 8) || (vec == 16 && N % 8 != 0))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_SSD_TC(HH, GG)                                                      \
  if (hp == HH && heads_per_block == GG)                                       \
    return rt::ssdtc::launch<HH, GG>(x, dt, A, Bm, Cm, y, s_chunk, decay, cum, \
                                     B, S, nh, N, q, pair, vec, st);
  RT_SSD_TC(16, 1)
  RT_SSD_TC(16, 2)
  RT_SSD_TC(16, 4)
  RT_SSD_TC(16, 8)
  RT_SSD_TC(32, 1)
  RT_SSD_TC(32, 2)
  RT_SSD_TC(32, 4)
  RT_SSD_TC(64, 1)
  RT_SSD_TC(64, 2)
#undef RT_SSD_TC
  return -1;
}
