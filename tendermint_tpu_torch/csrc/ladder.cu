// Batched cofactorless Ed25519 verify, and the r*B of batched signing, on
// Hopper (sm_90a).
//
// Replaces the three Pallas kernels of tendermint_tpu/ops/ladder_pallas.py:
//   ladder_kernel<true>   <- verify_pallas     (:432, _verify_kernel +
//                            _ladder_tail)
//   ladder_kernel<false>  <- verify_pallas_pre (:511, _verify_kernel_pre +
//                            the same tail)
//   sign_rb_kernel        <- sign_pallas_rB    (:589, _sign_kernel)
// The compile-time switch mirrors how the Pallas code shares one tail.
//
// ladder_kernel: four threads of a warp verify one signature. Inputs are
// row-major uint8[N, 32] (pubkey or cached (-A).x / A.y bytes, R, packed
// s and h scalars), read straight from global memory (the 4-bit windows
// byte by byte, per window); output is int32[N] verdicts, written by lane
// 0 of each group. The kernel launches on the caller's stream and
// allocates nothing.
//
// Bound: one verify is about 3.4k field products (each 100 wide
// multiply-adds, about 216 issue slots of the integer multiply-add pipe)
// against 132 bytes of input and 4 of output, so operations bound it. The one-thread version
// (one thread per signature, 128 a block) left most of the card idle at
// the path's sizes: a chunk of 8192 signatures was 64 blocks on 64 of
// 132 SMs, and its time was one block's time on an SM, the same at 2048
// and twice that at 32768. The design spreads a signature over four
// threads of a warp: each point operation is two rounds of four
// independent products (fe25519.cuh, the 4-lane schedule), lane k of the
// group computes product k and the group all-gathers with __shfl_sync.
// So a window is 12 product latencies instead of about 47, and 4n
// threads put an 8192 chunk on all 132 SMs, two blocks on most. The
// decompression of A and the final inverse stay serial, run by every
// lane alike. Each lane keeps only its column of the table of -A
// (16 x 10 int32, 640 bytes of local memory, L1-resident) instead of the
// whole 2.5 KB table; the same columns in shared memory measured no
// faster.
//
// sign_rb_kernel: one thread per scalar, uint8[N, 32] scalars in and
// uint8[N, 32] encodings out. Also bound by integer multiply-adds, against
// 64 bytes moved. The TPU kernel shares the verify ladder's window loop:
// four doublings and an add a window, 2507 field products, three
// quarters of them doublings, which only the variable base of verify
// needs. B is fixed, so this kernel is a fixed-base comb
// (fe25519.cuh, sign_rb_comb): signed digits in [-8, 7] and, per window,
// one mixed add of an entry of a table of j * 16^w * B, 721 products, of
// which the inverse is 265. At 16384 scalars (the signing chunk) the
// grid is 128 blocks, one an SM. Four lanes a scalar on the add's two
// rounds (each lane running the serial inverse) measured 1.8x slower
// there and 2.3x at 65536, 1.5x faster only at 4096 (PERF.md).
// At window w every thread reads one of the 8 entries of row w (960 B),
// through the read-only path from global memory: they stay in L1, and
// the digit-indexed reads of a warp would serialise in __constant__.

#include <cuda_runtime.h>

#include "fe25519.cuh"

namespace {

using fe25519::fe;

constexpr int kThreads = 128;
// Blocks of the verify kernel an SM must hold at once (__launch_bounds__).
// 2 lets a lane take up to 255 registers: it uses 250-254 and spills
// nothing, and an SM still holds two blocks, all 256 blocks of an
// 8192-signature chunk at once. 4 (128 registers) spills 264-704 bytes
// and is no faster at 8192, slower at 32768; 3 lies between.
constexpr int kVerifyMinBlocks = 2;

// A group of four consecutive threads of a warp: lane k computes product
// k of a round, then the group all-gathers the four.
struct group_lanes {
  int lane;       // 0..3
  unsigned mask;  // the group's four lanes in the warp

  template <class F>
  __device__ __forceinline__ void mul4(F operands, fe out[4]) const {
    fe a, b;
    operands(lane, a, b);
    const fe p = fe25519::fe_mul(a, b);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 10; ++i)
        out[j].v[i] = __shfl_sync(mask, p.v[i], j, 4);
  }

  // this lane's column of the table in cached form (local memory)
  struct table {
    fe c[16];
    int lane;
    __device__ explicit table(const group_lanes &g) : lane(g.lane) {}
    __device__ void set(int e, const fe &c0, const fe &c1, const fe &c2,
                        const fe &c3) {
      c[e] = fe25519::sel4(lane, c0, c1, c2, c3);
    }
    __device__ const fe &col(int e, int) const { return c[e]; }
  };
};

template <bool FULL>
__global__ void __launch_bounds__(kThreads, kVerifyMinBlocks)
    ladder_kernel(const uint8_t *__restrict__ a0, const uint8_t *__restrict__ a1,
                  const uint8_t *__restrict__ okp, const uint8_t *__restrict__ rb,
                  const uint8_t *__restrict__ sb, const uint8_t *__restrict__ hb,
                  const int32_t *__restrict__ consts, int32_t *__restrict__ out,
                  int n, int n_windows) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t >> 2;
  // whole groups leave together, before any shuffle names them
  if (i >= n) return;
  const group_lanes g{t & 3, 0xFu << (threadIdx.x & 28)};
  const size_t row = 32 * (size_t)i;
  bool v;
  if (FULL) {
    v = fe25519::verify4_full(g, a0 + row, rb + row, sb + row, hb + row,
                              consts, n_windows);
  } else {
    v = fe25519::verify4_pre(g, a0 + row, a1 + row, okp[i] != 0, rb + row,
                             sb + row, hb + row, consts, n_windows);
  }
  if (g.lane == 0) out[i] = v ? 1 : 0;
}

__device__ __forceinline__ void load_row(uint8_t dst[32], const uint8_t *src,
                                         int i) {
  const uint4 *p = reinterpret_cast<const uint4 *>(src + 32 * (size_t)i);
  const uint4 a = p[0], b = p[1];
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int k = 0; k < 32; ++k) dst[k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
}

__global__ void __launch_bounds__(kThreads)
    sign_rb_kernel(const uint8_t *__restrict__ rs,
                   const int32_t *__restrict__ comb,
                   uint8_t *__restrict__ out, int n, int n_windows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t r[32], enc[32];
  load_row(r, rs, i);
  fe25519::sign_rb_comb(r, comb, n_windows, enc);
  uint32_t w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] = (uint32_t)enc[4 * k] | ((uint32_t)enc[4 * k + 1] << 8) |
           ((uint32_t)enc[4 * k + 2] << 16) | ((uint32_t)enc[4 * k + 3] << 24);
  uint4 *p = reinterpret_cast<uint4 *>(out + 32 * (size_t)i);
  p[0] = make_uint4(w[0], w[1], w[2], w[3]);
  p[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

int blocks_for(int threads) { return (threads + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch: 0 when it was taken.
int tm_ladder_verify(const void *pk, const void *rb, const void *sb,
                     const void *hb, const void *consts, void *out, int n,
                     int n_windows, void *stream) {
  ladder_kernel<true><<<blocks_for(4 * n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)pk, nullptr, nullptr, (const uint8_t *)rb,
      (const uint8_t *)sb, (const uint8_t *)hb, (const int32_t *)consts,
      (int32_t *)out, n, n_windows);
  return (int)cudaGetLastError();
}

int tm_ladder_verify_pre(const void *xnb, const void *yb, const void *ok,
                         const void *rb, const void *sb, const void *hb,
                         const void *consts, void *out, int n, int n_windows,
                         void *stream) {
  ladder_kernel<false><<<blocks_for(4 * n), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t *)xnb, (const uint8_t *)yb, (const uint8_t *)ok,
      (const uint8_t *)rb, (const uint8_t *)sb, (const uint8_t *)hb,
      (const int32_t *)consts, (int32_t *)out, n, n_windows);
  return (int)cudaGetLastError();
}

// comb: the int32[65, 8, 3, 10] table of sign_rb_comb (ops/ladder.py).
int tm_ladder_sign_rb(const void *r, const void *comb, void *out, int n,
                      int n_windows, void *stream) {
  sign_rb_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)r, (const int32_t *)comb, (uint8_t *)out, n,
      n_windows);
  return (int)cudaGetLastError();
}

// Blocks of 128 threads one SM holds at once: kernel 0 is ladder_kernel<true>,
// 1 ladder_kernel<false>, 2 sign_rb_kernel. Negative on an error.
int tm_ladder_occupancy(int kernel) {
  int blocks = 0;
  cudaError_t err;
  if (kernel == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ladder_kernel<true>, kThreads, 0);
  } else if (kernel == 1) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ladder_kernel<false>, kThreads, 0);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, sign_rb_kernel, kThreads, 0);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

const char *tm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
