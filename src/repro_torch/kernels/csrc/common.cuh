// Shared pieces of the kernels: element conversion, 16-byte tile loads from
// device memory into f32 shared memory, the mask constants, a one-instruction
// exp2, and the tensor-core building blocks of the bf16 kernels (cp.async,
// ldmatrix, mma.sync m16n8k16, bf16 packing).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// Masked scores are this finite value, not -inf: a fully masked row then
// yields the mean of V, as the reference kernels and oracles do.
constexpr float kNegInf = -1e30f;

template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int kPerVec = 4;  // elements in one 16-byte load
  __device__ static void unpack(const uint4& u, float* dst) {
    dst[0] = __uint_as_float(u.x);
    dst[1] = __uint_as_float(u.y);
    dst[2] = __uint_as_float(u.z);
    dst[3] = __uint_as_float(u.w);
  }
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int kPerVec = 8;
  __device__ static void unpack(const uint4& u, float* dst) {
    // a bf16 is the upper half of an f32
    dst[0] = __uint_as_float(u.x << 16);
    dst[1] = __uint_as_float(u.x & 0xffff0000u);
    dst[2] = __uint_as_float(u.y << 16);
    dst[3] = __uint_as_float(u.y & 0xffff0000u);
    dst[4] = __uint_as_float(u.z << 16);
    dst[5] = __uint_as_float(u.z & 0xffff0000u);
    dst[6] = __uint_as_float(u.w << 16);
    dst[7] = __uint_as_float(u.w & 0xffff0000u);
  }
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// Copy rows [row0, row0 + ROWS) of a [n_rows, D] slice whose rows lie
// `row_stride` elements apart into shared memory as f32 with row stride LDS.
// Rows at or beyond n_rows are filled with zeros (the ragged edge is masked
// by the caller, never padded in device memory).  Every thread of the block
// takes part; 16-byte loads, neighbouring threads on neighbouring addresses.
template <typename T, int D, int ROWS, int LDS, int THREADS>
__device__ __forceinline__ void load_tile(float* __restrict__ smem,
                                          const T* __restrict__ gmem,
                                          int64_t row_stride, int row0,
                                          int n_rows) {
  constexpr int PV = Elem<T>::kPerVec;
  constexpr int VECS_PER_ROW = D / PV;
  constexpr int TOTAL = ROWS * VECS_PER_ROW;
  for (int i = threadIdx.x; i < TOTAL; i += THREADS) {
    const int r = i / VECS_PER_ROW;
    const int c = (i % VECS_PER_ROW) * PV;
    float vals[PV];
    const int row = row0 + r;
    if (row < n_rows) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          gmem + static_cast<int64_t>(row) * row_stride + c);
      Elem<T>::unpack(u, vals);
    } else {
#pragma unroll
      for (int e = 0; e < PV; ++e) vals[e] = 0.f;
    }
    float* dst = smem + r * LDS + c;
#pragma unroll
    for (int e = 0; e < PV; e += 4) {
      *reinterpret_cast<float4*>(dst + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
    }
  }
}

// 2^x in one MUFU.EX2 (exp2f adds a fix-up for results below 2^-126, which
// only round a softmax weight from a denormal to 0).  2^-inf = 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float apply_cap(float s, float cap) {
  return cap > 0.f ? cap * tanhf(s / cap) : s;
}

// ---- tensor-core building blocks (sm_80 and later) ---------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; a source size of 0
// fills the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The same for 8 bytes (cp.async.cg takes 16 only; .ca takes 4, 8 and 16).
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace rt
