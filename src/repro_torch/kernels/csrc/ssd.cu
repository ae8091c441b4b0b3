// SSD (Mamba2) intra-chunk tile for Hopper (sm_90a), written by hand: the
// IEEE-f32 kernel.  It serves f32 inputs, and bf16 inputs whose pointers the
// tensor-core kernel of ssd_tc.cu cannot copy from (kernels/ssd.py routes).
//
// Replaces the Pallas kernel `_ssd_kernel` / `ssd_intra` of
// src/repro/kernels/ssd.py.  For xh [B,S,nh,hp], dt [B,S,nh] (f32), A [nh]
// (f32, < 0) and Bp / Cp [B,S,N] (one group: shared by all heads), per
// (batch, head, chunk of q steps):
//     cum     = cumsum(dt * A)                            over the chunk
//     y_intra = (L o (C B^T)) (x * dt),   L[t,s] = exp(cum_t - cum_s), t >= s
//     s_chunk = (x * dt * exp(cum_last - cum))^T B        [hp, N]
//     decay   = exp(cum_last)
// Out: y [B,S,nh,hp], s_chunk [B,nc,nh,hp,N], decay [B,nc,nh] and cum
// [B,nc,q,nh] (for the inter-chunk term, from the same sums), all f32.
//
// Design.  One block per (batch, head, chunk), as the TPU kernel's grid.
// The cumsum is a block-wide prefix sum (warp scans, then a scan of the warp
// totals) into shared memory.  A full [q,q] f32 score tile does not fit
// shared memory at q = 256 (256 KB), so the chunk is cut into tiles of 64
// steps: for each t tile, the block walks the s tiles at or below the
// diagonal, computes the 64x64 tile of C B^T, multiplies it by L (entries
// above the diagonal are written as 0 and never exponentiated), and adds the
// tile's product with x*dt to the y rows it keeps in registers.  The last t
// tile sees every s tile, so s_chunk is accumulated there, from the B and
// x*dt tiles already in shared memory.  The ragged last chunk is masked
// here, not padded in device memory: a position at or beyond S acts as
// dt = 0 (cum stays flat, so decay = exp(cum at the last valid step)) with
// x, B and C read as 0, which is exactly the reference's zero padding.
//
// Arithmetic: inputs f32 or bf16, every product and sum in IEEE f32 on the
// CUDA cores (no TF32, no tensor cores yet).
//
// What bounds it.  At the serving path's prefill shapes the function is
// bound by bytes: it reads x, dt, B, C once and writes y and s_chunk once
// (about 13 MB at mamba2-780m's B 1, S 512, nh 48, hp 64, N 128), against
// about 1.2 GFLOP if C B^T is counted once per (batch, chunk).  This first
// version is far from that bound: it recomputes C B^T for every head, as the
// TPU kernel does, and runs all three products on the CUDA cores; ssd_tc.cu
// shares C B^T across heads and moves the products to the tensor cores.
#include "common.cuh"

namespace rt {

constexpr int kSsdThreads = 256;
constexpr int kSsdTile = 64;      // steps in one t tile and one s tile
constexpr int kSsdMaxN = 128;     // s_chunk accumulators are sized for this

__host__ __device__ constexpr int ssd_ldn(int n) { return n + 4; }

template <int HP>
struct SsdCfg {
  static constexpr int TQ = kSsdTile;
  static constexpr int LDX = HP + 4;              // row stride of the x*dt tile
  static constexpr int LDP = TQ + 4;              // row stride of the L o CB tile
  static constexpr int YC = HP / 16;              // y columns per thread
  static constexpr int RU = HP * (kSsdMaxN / 4) / kSsdThreads;  // s_chunk units
  static constexpr int NW = kSsdThreads / 32;

  __host__ __device__ static int smem_floats(int q, int n) {
    const int qp = (q + TQ - 1) / TQ * TQ;
    return 3 * qp + 2 * TQ * ssd_ldn(n) + TQ * LDX + TQ * LDP;
  }
};

template <typename T, int HP>
__global__ void __launch_bounds__(kSsdThreads)
ssd_intra_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ s_chunk, float* __restrict__ decay,
                 float* __restrict__ cum, int S, int nh, int N, int q,
                 int nc) {
  using C = SsdCfg<HP>;
  constexpr int TQ = C::TQ, LDX = C::LDX, LDP = C::LDP, YC = C::YC;
  constexpr int RU = C::RU, NW = C::NW, THREADS = kSsdThreads;
  const int LDN = ssd_ldn(N);
  const int n_tiles = (q + TQ - 1) / TQ;
  const int QP = n_tiles * TQ;

  extern __shared__ __align__(16) float smem[];
  float* s_dt = smem;                 // [QP] dt; 0 beyond the chunk or S
  float* s_cum = s_dt + QP;           // [QP] cumsum(dt * A)
  float* s_w = s_cum + QP;            // [QP] exp(cum_last - cum)
  float* sC = s_w + QP;               // [TQ][LDN] C rows of the t tile
  float* sB = sC + TQ * LDN;          // [TQ][LDN] B rows of the s tile
  float* sX = sB + TQ * LDN;          // [TQ][LDX] x * dt rows of the s tile
  float* sP = sX + TQ * LDX;          // [TQ][LDP] L o (C B^T) of the pair
  __shared__ float s_warp[NW];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15;            // 16 x 16 threads over a 64 x 64 tile:
  const int ty = tid >> 4;            // rows ty*4 + i, columns tx + 16*j
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int pos0 = c * q;             // first position of the chunk
  const int n_valid = min(q, S - pos0);
  const float a = A[h];

  // ---- dt of the chunk, then cum by a block-wide prefix sum ----------------
  for (int i = tid; i < QP; i += THREADS)
    s_dt[i] = i < n_valid
        ? dt[(static_cast<int64_t>(b) * S + pos0 + i) * nh + h] : 0.f;
  __syncthreads();
  float carry = 0.f;
  for (int base = 0; base < QP; base += THREADS) {
    const int i = base + tid;
    float v = i < QP ? s_dt[i] * a : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) s_warp[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float w = lane < NW ? s_warp[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < NW; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += u;
      }
      if (lane < NW) s_warp[lane] = w;
    }
    __syncthreads();
    if (i < QP) s_cum[i] = carry + (warp > 0 ? s_warp[warp - 1] : 0.f) + v;
    carry += s_warp[NW - 1];
    __syncthreads();
  }
  const float cum_last = s_cum[q - 1];
  for (int i = tid; i < QP; i += THREADS) s_w[i] = expf(cum_last - s_cum[i]);
  float* cum_out = cum + (static_cast<int64_t>(b) * nc + c) * q * nh + h;
  for (int i = tid; i < q; i += THREADS) cum_out[i * nh] = s_cum[i];
  if (tid == 0)
    decay[(static_cast<int64_t>(b) * nc + c) * nh + h] = expf(cum_last);

  const int64_t x_row = static_cast<int64_t>(nh) * HP;   // between positions
  const T* x_base = x + (static_cast<int64_t>(b) * S + pos0) * x_row +
                    static_cast<int64_t>(h) * HP;
  const T* b_base = Bm + (static_cast<int64_t>(b) * S + pos0) * N;
  const T* c_base = Cm + (static_cast<int64_t>(b) * S + pos0) * N;
  float* y_base = y + (static_cast<int64_t>(b) * S + pos0) * x_row +
                  static_cast<int64_t>(h) * HP;

  // s_chunk: units of 4 consecutive n of one p; unit u = tid + THREADS * r
  const int NQ = N / 4;
  const int n_units = HP * NQ;
  float sacc[RU][4];
#pragma unroll
  for (int r = 0; r < RU; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[r][e] = 0.f;

  for (int tt = 0; tt < n_tiles; ++tt) {
    const int t0 = tt * TQ;
    __syncthreads();            // the previous t tile no longer reads sC
    for (int i = tid; i < TQ * N; i += THREADS) {
      const int r = i / N, col = i - r * N;
      sC[r * LDN + col] = t0 + r < n_valid
          ? Elem<T>::load(c_base + static_cast<int64_t>(t0 + r) * N + col) : 0.f;
    }
    float yacc[4][YC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < YC; ++k) yacc[i][k] = 0.f;

    for (int st = 0; st <= tt; ++st) {
      const int s0 = st * TQ;
      __syncthreads();          // sB, sX and sP of the previous pair are read
      for (int i = tid; i < TQ * N; i += THREADS) {
        const int r = i / N, col = i - r * N;
        sB[r * LDN + col] = s0 + r < n_valid
            ? Elem<T>::load(b_base + static_cast<int64_t>(s0 + r) * N + col)
            : 0.f;
      }
      for (int i = tid; i < TQ * HP; i += THREADS) {
        const int r = i / HP, p = i - r * HP;
        sX[r * LDX + p] = s0 + r < n_valid
            ? Elem<T>::load(x_base + (s0 + r) * x_row + p) * s_dt[s0 + r] : 0.f;
      }
      __syncthreads();

      // ---- C B^T of the pair, times L ------------------------------------
      float cb[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cb[i][j] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(sC + (ty * 4 + i) * LDN + n);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(sB + (tx + 16 * j) * LDN + n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            cb[i][j] = fmaf(cv[i].x, bv[j].x, cb[i][j]);
            cb[i][j] = fmaf(cv[i].y, bv[j].y, cb[i][j]);
            cb[i][j] = fmaf(cv[i].z, bv[j].z, cb[i][j]);
            cb[i][j] = fmaf(cv[i].w, bv[j].w, cb[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + ty * 4 + i, s = s0 + tx + 16 * j;
          float p = 0.f;            // above the diagonal: 0, never exp(+x)
          if (s <= t) p = cb[i][j] * expf(s_cum[t] - s_cum[s]);
          sP[(ty * 4 + i) * LDP + tx + 16 * j] = p;
        }
      __syncthreads();

      // ---- y rows of the t tile += (L o C B^T) (x * dt) -------------------
#pragma unroll 4
      for (int s = 0; s < TQ; ++s) {
        float pv[4], xv[YC];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * LDP + s];
#pragma unroll
        for (int k = 0; k < YC; ++k) xv[k] = sX[s * LDX + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < YC; ++k)
            yacc[i][k] = fmaf(pv[i], xv[k], yacc[i][k]);
      }

      // ---- s_chunk, with the last t tile, which walks every s tile --------
      if (tt == n_tiles - 1) {
        for (int s = 0; s < TQ; ++s) {
          const float w = s_w[s0 + s];
          const float* brow = sB + s * LDN;
          const float* xrow = sX + s * LDX;
#pragma unroll
          for (int r = 0; r < RU; ++r) {
            const int u = tid + THREADS * r;
            if (u < n_units) {
              const int p = u / NQ, nq = u - p * NQ;
              const float xw = xrow[p] * w;
              const float4 bv = *reinterpret_cast<const float4*>(brow + nq * 4);
              sacc[r][0] = fmaf(xw, bv.x, sacc[r][0]);
              sacc[r][1] = fmaf(xw, bv.y, sacc[r][1]);
              sacc[r][2] = fmaf(xw, bv.z, sacc[r][2]);
              sacc[r][3] = fmaf(xw, bv.w, sacc[r][3]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t < n_valid) {
        float* yr = y_base + t * x_row;
#pragma unroll
        for (int k = 0; k < YC; ++k) yr[tx + 16 * k] = yacc[i][k];
      }
    }
  }

  float* sc = s_chunk +
              ((static_cast<int64_t>(b) * nc + c) * nh + h) * HP * N;
#pragma unroll
  for (int r = 0; r < RU; ++r) {
    const int u = tid + THREADS * r;
    if (u < n_units) {
      const int p = u / NQ, nq = u - p * NQ;
      *reinterpret_cast<float4*>(sc + p * N + nq * 4) =
          make_float4(sacc[r][0], sacc[r][1], sacc[r][2], sacc[r][3]);
    }
  }
}

template <typename T, int HP>
int launch_ssd(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, void* y, void* s_chunk, void* decay,
               void* cum, int B, int S, int nh, int N, int q,
               cudaStream_t stream) {
  auto kern = ssd_intra_kernel<T, HP>;
  const size_t smem = SsdCfg<HP>::smem_floats(q, N) * sizeof(float);
  static size_t attr_bytes = 48 * 1024;   // opted in so far (per instance)
  if (smem > attr_bytes) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_bytes = smem;
  }
  const int nc = (S + q - 1) / q;
  dim3 grid(nc, nh, B);
  kern<<<grid, kSsdThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(s_chunk), static_cast<float*>(decay),
      static_cast<float*>(cum), S, nh, N, q, nc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_ssd(int hp, const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, void* y, void* s_chunk,
                 void* decay, void* cum, int B, int S, int nh, int N, int q,
                 cudaStream_t stream) {
  switch (hp) {
    case 16:
      return launch_ssd<T, 16>(x, dt, A, Bm, Cm, y, s_chunk, decay, cum, B, S,
                               nh, N, q, stream);
    case 32:
      return launch_ssd<T, 32>(x, dt, A, Bm, Cm, y, s_chunk, decay, cum, B, S,
                               nh, N, q, stream);
    case 64:
      return launch_ssd<T, 64>(x, dt, A, Bm, Cm, y, s_chunk, decay, cum, B, S,
                               nh, N, q, stream);
    default:
      return -1;
  }
}

}  // namespace rt

// dtype of x / Bm / Cm: 0 = float32, 1 = bfloat16 (dt and A are float32).
// Returns cudaGetLastError() after the launch (0 on success), -1 for a head
// dim, state size or dtype the kernel does not take.  Launches on `stream`,
// does not synchronise, allocates nothing.
extern "C" int rt_ssd_intra(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            void* s_chunk, void* decay, void* cum, int B,
                            int S, int nh, int hp, int N, int q, int dtype,
                            void* stream) {
  if (N <= 0 || N % 4 != 0 || N > rt::kSsdMaxN || q <= 0 || S <= 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return rt::dispatch_ssd<float>(hp, x, dt, A, Bm, Cm, y, s_chunk, decay,
                                   cum, B, S, nh, N, q, st);
  if (dtype == 1)
    return rt::dispatch_ssd<__nv_bfloat16>(hp, x, dt, A, Bm, Cm, y, s_chunk,
                                           decay, cum, B, S, nh, N, q, st);
  return -1;
}
