// CPU build of the kernel's arithmetic (fe25519.cuh) behind a plain C
// interface, loaded with ctypes by the CPU tests. It runs the same
// functions the CUDA kernel runs, one signature after another, so the
// kernel's own field and ladder code is checked where there is no card.
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libfe25519_cpu.so cpu_shim.cpp

#include "fe25519.cuh"

using namespace fe25519;

extern "C" {

// out[i] = canonical bytes of a[i] * b[i] (inputs: 32-byte little-endian
// field elements, bit 255 dropped, values >= p accepted).
void tm_cpu_fe_mul(const uint8_t *a, const uint8_t *b, uint8_t *out, int n) {
  for (int i = 0; i < n; ++i)
    fe_tobytes(out + 32 * i,
               fe_mul(fe_frombytes(a + 32 * i), fe_frombytes(b + 32 * i)));
}

void tm_cpu_fe_invert(const uint8_t *a, uint8_t *out, int n) {
  for (int i = 0; i < n; ++i)
    fe_tobytes(out + 32 * i, fe_invert(fe_frombytes(a + 32 * i)));
}

// Canonical re-encoding: reduces values in [p, 2^255) below p.
void tm_cpu_fe_canon(const uint8_t *a, uint8_t *out, int n) {
  for (int i = 0; i < n; ++i) fe_tobytes(out + 32 * i, fe_frombytes(a + 32 * i));
}

void tm_cpu_verify(const uint8_t *pk, const uint8_t *rb, const uint8_t *sb,
                   const uint8_t *hb, const int32_t *consts, int32_t *out,
                   int n, int n_windows) {
  for (int i = 0; i < n; ++i)
    out[i] = verify_full_one(pk + 32 * i, rb + 32 * i, sb + 32 * i,
                             hb + 32 * i, consts, n_windows);
}

void tm_cpu_verify_pre(const uint8_t *xnb, const uint8_t *yb,
                       const uint8_t *ok, const uint8_t *rb, const uint8_t *sb,
                       const uint8_t *hb, const int32_t *consts, int32_t *out,
                       int n, int n_windows) {
  for (int i = 0; i < n; ++i)
    out[i] = verify_pre_one(xnb + 32 * i, yb + 32 * i, ok[i] != 0,
                            rb + 32 * i, sb + 32 * i, hb + 32 * i, consts,
                            n_windows);
}

// out[i] = enc(r[i] * B) over the low n_windows 4-bit windows of r[i].
void tm_cpu_sign_rb(const uint8_t *r, const int32_t *consts, uint8_t *out,
                    int n, int n_windows) {
  for (int i = 0; i < n; ++i)
    sign_rb_one(r + 32 * i, consts, n_windows, out + 32 * i);
}

}  // extern "C"
