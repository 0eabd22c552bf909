// CPU build of the kernel's arithmetic (fe25519.cuh) behind a plain C
// interface, loaded with ctypes by the CPU tests. It runs the same
// functions the CUDA kernels run, one signature after another, so the
// kernels' own field and ladder code is checked where there is no card.
// The verify ladder is the 4-lane schedule with the group emulated on
// one thread (group_host): only the card's shuffle is not run here.
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
  const group_host g;
  for (int i = 0; i < n; ++i)
    out[i] = verify4_full(g, pk + 32 * i, rb + 32 * i, sb + 32 * i,
                          hb + 32 * i, consts, n_windows);
}

void tm_cpu_verify_pre(const uint8_t *xnb, const uint8_t *yb,
                       const uint8_t *ok, const uint8_t *rb, const uint8_t *sb,
                       const uint8_t *hb, const int32_t *consts, int32_t *out,
                       int n, int n_windows) {
  const group_host g;
  for (int i = 0; i < n; ++i)
    out[i] = verify4_pre(g, xnb + 32 * i, yb + 32 * i, ok[i] != 0,
                         rb + 32 * i, sb + 32 * i, hb + 32 * i, consts,
                         n_windows);
}

// One point operation on n points, for the tests. p[i] and q[i] are four
// 32-byte field elements each: p = (X, Y, Z, T), q = (X, Y, Z, T*2d);
// out[i] gets the canonical bytes of the result's (X, Y, Z, T). op 0 is
// 2p, op 1 is p + q with q taken as affine (its Z ignored, as Z = 1), op
// 2 is p + q projective. lanes4 = 1 runs the 4-lane schedule (the table
// add through a one-entry cached table), 0 the one-thread pt_double /
// pt_add_tbl.
void tm_cpu_point_op(int op, int lanes4, const uint8_t *p, const uint8_t *q,
                     uint8_t *out, int n) {
  for (int i = 0; i < n; ++i) {
    const uint8_t *pi = p + 128 * i, *qi = q + 128 * i;
    pt4 a, b, r;
    fe *pa[4] = {&a.X, &a.Y, &a.Z, &a.T}, *pb[4] = {&b.X, &b.Y, &b.Z, &b.T};
    for (int c = 0; c < 4; ++c) {
      *pa[c] = fe_frombytes(pi + 32 * c);
      *pb[c] = fe_frombytes(qi + 32 * c);
    }
    if (lanes4) {
      const group_host g;
      r = a;
      if (op == 0) {
        dbl4(g, r);
      } else if (op == 1) {
        add4_affine(g, r, b.X, b.Y, b.T);
      } else {
        group_host::table tbl(g);
        put_cached(tbl, 0, b.X, b.Y, b.Z, b.T);
        add4_cached(g, r, tbl, 0);
      }
    } else if (op == 0) {
      pt_double(r, a.X, a.Y, a.Z, true);
    } else {
      pt_add_tbl(r, a, b.X, b.Y, op == 2 ? &b.Z : nullptr, b.T, true);
    }
    const fe *pr[4] = {&r.X, &r.Y, &r.Z, &r.T};
    for (int c = 0; c < 4; ++c) fe_tobytes(out + 128 * i + 32 * c, *pr[c]);
  }
}

// out[i] = enc(r[i] * B) over the low n_windows 4-bit windows of r[i],
// on the comb of the sign kernel (comb: int32[65, 8, 3, 10]).
void tm_cpu_sign_rb(const uint8_t *r, const int32_t *comb, uint8_t *out,
                    int n, int n_windows) {
  for (int i = 0; i < n; ++i)
    sign_rb_comb(r + 32 * i, comb, n_windows, out + 32 * i);
}

}  // extern "C"
