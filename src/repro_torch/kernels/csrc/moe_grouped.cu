// The MoE layer's expert products over the routed (token, expert) entries
// only, grouped by expert, for bf16 on Hopper's tensor cores (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the experts' products to
// XLA as dense einsums over capacity buffers [B, E, C, d], and so does the
// port's buffer path (models/moe.py).  At decode (one token a row) those
// buffers are 64x larger than the routed entries at olmoe-1b-7b's widths,
// so this kernel was added for the decode step: given the entries sorted by
// expert (`order`), each expert's count and the running end of the counts,
// it computes
//     h[i]           = silu(x[tok(i)] wi[e]) * (x[tok(i)] wg[e])  (sorted i)
//     out[order[i]]  = h[i] wo[e]
// where tok(i) = order[i] / top_k, in two launches (the up and the down
// projection), f32 sums, h and out rounded to bf16 once.
//
// What bounds it.  At the decode shapes (olmoe-1b-7b: 2 048 entries over 64
// experts, 32 on average) the products do about 32 flops per weight byte,
// against the card's ridge of about 295: the kernel is bound by reading each
// routed expert's weights once (805 MB a layer at olmoe's widths).  The
// design:
//   * a block takes one (column tile of BN, expert); its grid is fixed by the
//     shapes, and a block finds its expert's rows from `counts` and `ends`
//     on the device (no count reaches the host).  An expert with no entry
//     reads nothing; an expert with more than BM entries loops over chunks
//     of BM, reading its weight tile once a chunk;
//   * the weight tiles (BK x BN, both wi and wg in the up projection) come
//     through a four-stage cp.async ring, three stages in flight while one
//     computes, one block barrier a stage; two blocks fit an SM;
//   * the A rows are gathered straight from x by token (up) or read from the
//     sorted h (down): no zeroed buffer, no copy of the tokens.  Only the
//     m16 tiles that hold entries are copied and multiplied; rows past the
//     count inside the last one are zero-filled (source size 0) and never
//     stored;
//   * products by mma.sync m16n8k16 (bf16 in, f32 out), A by ldmatrix, the
//     weights (row-major [K, N]) by ldmatrix.trans; each warp takes 16
//     columns of every m16 tile, so a weight fragment serves up to 4 tiles;
//   * the epilogue applies silu(a) * g in f32 and writes bf16 pairs: h in
//     sorted order, out at each entry's (token, k) row.
// wgmma and TMA (a producer warp) are the next step if the ring's
// cp.async issue ever limits it.
#include "common.cuh"

namespace rt {
namespace moe {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;        // entries of a chunk: 4 m16 tiles
constexpr int BN = 64;        // output columns of a block: 4 warps x 16
constexpr int BK = 64;        // depth of a stage
constexpr int LDA = BK + 8;   // bf16 per shared row of A (padded: ldmatrix
constexpr int LDB = BN + 8;   // ... and of a weight tile are conflict-free)
constexpr int STAGES = 4;
constexpr int THREADS = 128;

template <bool UP>
struct Cfg {
  static constexpr int NB = UP ? 2 : 1;  // weight matrices: wi, wg | wo
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int STAGE_ELEMS = A_ELEMS + NB * B_ELEMS;
  // the ring, then each chunk row's A row and output row
  static constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * 2 + 2 * BM * 4;
};

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + __expf(-v));
}

// UP:   a = x [T, K] (row = order[i] / top_k), w0 = wi, w1 = wg [E, K, N],
//       out = h [entries, N] (row = i, sorted).
// down: a = h [entries, K] (row = i), w0 = wo [E, K, N], out [entries, N]
//       (row = order[i], the entry's (token, k) position).
template <bool UP>
__global__ void __launch_bounds__(THREADS)
moe_grouped_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w0,
               const bf16* __restrict__ w1, bf16* __restrict__ out,
               const int64_t* __restrict__ order,
               const int* __restrict__ counts, const int* __restrict__ ends,
               int K, int N, int top_k) {
  using C = Cfg<UP>;
  constexpr int NB = C::NB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sbuf = reinterpret_cast<bf16*>(smem_raw);
  int* s_arow = reinterpret_cast<int*>(smem_raw + STAGES * C::STAGE_ELEMS * 2);
  int* s_orow = s_arow + BM;

  const int e = blockIdx.y;
  const int cnt = counts[e];
  if (cnt == 0) return;  // an expert with no entry reads no weights
  const int start = ends[e] - cnt;
  const int n0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g8 = lane >> 2;  // row of the m16n8 fragment (and row + 8)
  const int t4 = lane & 3;   // column pair of the fragment
  const int64_t w_size = static_cast<int64_t>(K) * N;
  const bf16* wb0 = w0 + e * w_size + n0;
  const bf16* wb1 = UP ? w1 + e * w_size + n0 : w0;
  const int KT = K / BK;

  // copies: thread t takes 16-byte column t % 8 of rows t / 8 + 16 i, so
  // row block i of A is m16 tile i
  const int cr = threadIdx.x >> 3, cc = (threadIdx.x & 7) * 8;
  const uint32_t s_base = smem_addr(sbuf);
  // ldmatrix lane addressing, A (plain) and weights (transposed) alike: row
  // lane & 15, column +8 for lanes 16-31
  const int l_row = lane & 15, l_col = (lane >> 4) * 8;

  for (int m0 = 0; m0 < cnt; m0 += BM) {
    const int rows = min(BM, cnt - m0);
    const int m_tiles = (rows + 15) >> 4;
    if (threadIdx.x < BM) {
      const int r = threadIdx.x;
      int arow = 0, orow = 0;
      if (r < rows) {
        const int pos = start + m0 + r;
        const int64_t entry = order[pos];
        arow = UP ? static_cast<int>(entry / top_k) : pos;
        orow = UP ? pos : static_cast<int>(entry);
      }
      s_arow[r] = arow;
      s_orow[r] = orow;
    }
    __syncthreads();

    auto load_stage = [&](int stage, int kt) {
      const uint32_t st = s_base + stage * C::STAGE_ELEMS * 2;
      const int k0 = kt * BK;
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        if (i < m_tiles) {
          const int r = cr + 16 * i;
          const bf16* src =
              a + static_cast<int64_t>(s_arow[r]) * K + k0 + cc;
          cp_async16(st + (r * LDA + cc) * 2, src, r < rows ? 16 : 0);
        }
      }
#pragma unroll
      for (int i = 0; i < BK / 16; ++i) {
        const int kr = cr + 16 * i;
        const int64_t off = static_cast<int64_t>(k0 + kr) * N + cc;
        cp_async16(st + (C::A_ELEMS + kr * LDB + cc) * 2, wb0 + off, 16);
        if constexpr (UP)
          cp_async16(st + (C::A_ELEMS + C::B_ELEMS + kr * LDB + cc) * 2,
                     wb1 + off, 16);
      }
    };

    float acc[NB][BM / 16][2][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int mt = 0; mt < BM / 16; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          acc[j][mt][nt][0] = acc[j][mt][nt][1] = acc[j][mt][nt][2] =
              acc[j][mt][nt][3] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < KT) load_stage(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<STAGES - 2>();  // stage kt has landed
      __syncthreads();  // ... for every thread; stage kt - 1 is no longer
                        // read, so it takes stage kt + STAGES - 1
      if (kt + STAGES - 1 < KT)
        load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
      cp_async_commit();

      const bf16* sA = sbuf + (kt % STAGES) * C::STAGE_ELEMS;
      const bf16* sB = sA + C::A_ELEMS;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t bw[NB][4];
#pragma unroll
        for (int j = 0; j < NB; ++j)
          ldsm_x4_trans(smem_addr(sB + j * C::B_ELEMS +
                                  (kk * 16 + l_row) * LDB + warp * 16 + l_col),
                        bw[j]);
#pragma unroll
        for (int mt = 0; mt < BM / 16; ++mt) {
          if (mt < m_tiles) {
            uint32_t af[4];
            ldsm_x4(smem_addr(sA + (mt * 16 + l_row) * LDA + kk * 16 + l_col),
                    af);
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              mma_bf16(acc[j][mt][0], af, bw[j][0], bw[j][1]);
              mma_bf16(acc[j][mt][1], af, bw[j][2], bw[j][3]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < BM / 16; ++mt) {
      if (mt >= m_tiles) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = n0 + warp * 16 + nt * 8 + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + g8 + 8 * half;
          if (r >= rows) continue;
          float v0 = acc[0][mt][nt][2 * half], v1 = acc[0][mt][nt][2 * half + 1];
          if constexpr (UP) {
            v0 = silu(v0) * acc[NB - 1][mt][nt][2 * half];
            v1 = silu(v1) * acc[NB - 1][mt][nt][2 * half + 1];
          }
          *reinterpret_cast<uint32_t*>(
              out + static_cast<int64_t>(s_orow[r]) * N + col) =
              pack_bf16(v0, v1);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next chunk rewrites the ring and the row indices
  }
}

template <bool UP>
int launch(const void* a, const void* w0, const void* w1, void* out,
           const void* order, const void* counts, const void* ends, int E,
           int K, int N, int top_k, cudaStream_t stream) {
  using C = Cfg<UP>;
  auto kern = moe_grouped_kernel<UP>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  dim3 grid(N / BN, E);
  kern<<<grid, THREADS, C::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w0),
      static_cast<const bf16*>(w1), static_cast<bf16*>(out),
      static_cast<const int64_t*>(order), static_cast<const int*>(counts),
      static_cast<const int*>(ends), K, N, top_k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace moe
}  // namespace rt

// x [T, d], wi / wg [E, d, fe], wo [E, fe, d], all bf16 and contiguous;
// order [entries] int64 (the entries sorted by expert, stably; entry i is
// token i / top_k's k-th choice), counts and ends [E] int32 (entries per
// expert and their running sum); h [entries, fe] bf16 scratch, out
// [entries, d] bf16, rows in entry order.  Two launches on `stream`, up then
// down; no synchronisation, no allocation.  Returns cudaGetLastError()
// after each launch (0 on success), -1 for widths the tiles do not divide.
extern "C" int rt_moe_grouped(const void* x, const void* wi, const void* wg,
                              const void* wo, void* h, void* out,
                              const void* order, const void* counts,
                              const void* ends, int E, int d, int fe,
                              int top_k, void* stream) {
  using namespace rt::moe;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % BK != 0 || d % BN != 0 || fe % BK != 0 || fe % BN != 0 ||
      top_k < 1)
    return -1;
  int err = launch<true>(x, wi, wg, h, order, counts, ends, E, d, fe, top_k,
                         st);
  if (err != 0) return err;
  return launch<false>(h, wo, nullptr, out, order, counts, ends, E, fe, d,
                       top_k, st);
}
