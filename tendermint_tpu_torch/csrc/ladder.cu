// Batched cofactorless Ed25519 verify, and the r*B of batched signing, on
// Hopper (sm_90a).
//
// Replaces the three Pallas kernels of tendermint_tpu/ops/ladder_pallas.py:
//   ladder_kernel<true>   <- verify_pallas     (_verify_kernel + _ladder_tail)
//   ladder_kernel<false>  <- verify_pallas_pre (_verify_kernel_pre + tail)
//   sign_rb_kernel        <- sign_pallas_rB    (_sign_kernel)
// The compile-time switch mirrors how the Pallas code shares one tail.
//
// One thread verifies one signature. Inputs are row-major uint8[N, 32]
// (pubkey or cached (-A).x / A.y bytes, R, packed s and h scalars); the
// 4-bit windows are read from the packed scalars in the kernel. Output is
// int32[N] verdicts. The kernel launches on the caller's stream and
// allocates nothing.
//
// Bound: integer multiply-adds. One verify is about 3.4k field products
// of 100 32x32->64-bit multiply-adds each, against 132 bytes of input and
// 4 of output. This first version keeps the 16-entry table of -A
// (2.5 KB) in each thread's local memory; keeping it in shared memory,
// several threads per signature and another radix are later work.
//
// sign_rb_kernel: one thread per scalar, uint8[N, 32] scalars in and
// uint8[N, 32] encodings out. Also bound by integer multiply-adds: about
// 2.5k field products per scalar against 64 bytes moved. It has no table
// of -A, so nothing is indexed by a run-time digit but the s-table rows,
// which it reads from global memory (they stay in L1/L2).

#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void load_row(uint8_t dst[32], const uint8_t *src,
                                         int i) {
  const uint4 *p = reinterpret_cast<const uint4 *>(src + 32 * (size_t)i);
  const uint4 a = p[0], b = p[1];
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int k = 0; k < 32; ++k) dst[k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
}

template <bool FULL>
__global__ void __launch_bounds__(kThreads)
    ladder_kernel(const uint8_t *__restrict__ a0, const uint8_t *__restrict__ a1,
                  const uint8_t *__restrict__ okp, const uint8_t *__restrict__ rb,
                  const uint8_t *__restrict__ sb, const uint8_t *__restrict__ hb,
                  const int32_t *__restrict__ consts, int32_t *__restrict__ out,
                  int n, int n_windows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t r[32], s[32], h[32], x0[32];
  load_row(r, rb, i);
  load_row(s, sb, i);
  load_row(h, hb, i);
  load_row(x0, a0, i);
  bool v;
  if (FULL) {
    v = fe25519::verify_full_one(x0, r, s, h, consts, n_windows);
  } else {
    uint8_t x1[32];
    load_row(x1, a1, i);
    v = fe25519::verify_pre_one(x0, x1, okp[i] != 0, r, s, h, consts,
                                n_windows);
  }
  out[i] = v ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
    sign_rb_kernel(const uint8_t *__restrict__ rs,
                   const int32_t *__restrict__ consts,
                   uint8_t *__restrict__ out, int n, int n_windows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t r[32], enc[32];
  load_row(r, rs, i);
  fe25519::sign_rb_one(r, consts, n_windows, enc);
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] = (uint32_t)enc[4 * k] | ((uint32_t)enc[4 * k + 1] << 8) |
           ((uint32_t)enc[4 * k + 2] << 16) | ((uint32_t)enc[4 * k + 3] << 24);
  uint4 *p = reinterpret_cast<uint4 *>(out + 32 * (size_t)i);
  p[0] = make_uint4(w[0], w[1], w[2], w[3]);
  p[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch: 0 when it was taken.
int tm_ladder_verify(const void *pk, const void *rb, const void *sb,
                     const void *hb, const void *consts, void *out, int n,
                     int n_windows, void *stream) {
  ladder_kernel<true><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)pk, nullptr, nullptr, (const uint8_t *)rb,
      (const uint8_t *)sb, (const uint8_t *)hb, (const int32_t *)consts,
      (int32_t *)out, n, n_windows);
  return (int)cudaGetLastError();
}

int tm_ladder_verify_pre(const void *xnb, const void *yb, const void *ok,
                         const void *rb, const void *sb, const void *hb,
                         const void *consts, void *out, int n, int n_windows,
                         void *stream) {
  ladder_kernel<false><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)xnb, (const uint8_t *)yb, (const uint8_t *)ok,
      (const uint8_t *)rb, (const uint8_t *)sb, (const uint8_t *)hb,
      (const int32_t *)consts, (int32_t *)out, n, n_windows);
  return (int)cudaGetLastError();
}

int tm_ladder_sign_rb(const void *r, const void *consts, void *out, int n,
                      int n_windows, void *stream) {
  sign_rb_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)r, (const int32_t *)consts, (uint8_t *)out, n,
      n_windows);
  return (int)cudaGetLastError();
}

const char *tm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
