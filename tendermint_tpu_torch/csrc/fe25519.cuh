// GF(2^255-19), edwards25519 points, the per-signature verify ladder and
// the fixed-base r*B of signing, as __host__ __device__ inline functions:
// nvcc builds them into the Hopper kernels (ladder.cu), g++ builds the
// same source into a CPU shim
// (cpu_shim.cpp) that the CPU tests hold against the plain PyTorch
// version (ops/ladder.py).
//
// Representation: 10 signed 32-bit limbs of radix 2^25.5 (26, 25, 26, ...
// bits; limb i sits at bit ceil(25.5 i)), not the 20 x 13-bit limbs of
// the TPU kernel: the card has a 32x32->64-bit multiply, so a product is
// 100 wide multiply-adds into 64-bit columns instead of 400 narrow ones.
// Every operation ends in a carry, so every limb of every value stays
// below 2^26 in magnitude. Then a product term is at most
// 2 * 19 * 2^26 * 2^26 < 2^57.3 and a column of 10 terms < 2^60.6: exact
// in int64. Only the bytes and verdicts have to match the reference.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FE_HD __host__ __device__ __forceinline__
#define FE_UNROLL _Pragma("unroll")
#else
#define FE_HD inline
#define FE_UNROLL
#endif

namespace fe25519 {

struct fe {
  int32_t v[10];
};

FE_HD int limb_bits(int i) { return (i & 1) ? 25 : 26; }

// Signed carry with rounding: limbs end in [-2^(w-1), 2^(w-1)) except
// limb 1, which takes the last small carry out of limb 0 (|limb| < 2^25).
// The carry out of limb 9 re-enters limb 0 with weight 19 (2^255 = 19).
FE_HD void carry(int64_t h[10], fe &out) {
  FE_UNROLL
  for (int i = 0; i < 10; ++i) {
    const int w = limb_bits(i);
    const int64_t c = (h[i] + ((int64_t)1 << (w - 1))) >> w;
    h[i] -= c * ((int64_t)1 << w);
    if (i < 9) {
      h[i + 1] += c;
    } else {
      h[0] += 19 * c;
    }
  }
  const int64_t c0 = (h[0] + ((int64_t)1 << 25)) >> 26;
  h[0] -= c0 * ((int64_t)1 << 26);
  h[1] += c0;
  FE_UNROLL
  for (int i = 0; i < 10; ++i) out.v[i] = (int32_t)h[i];
}

FE_HD fe fe_zero() {
  fe r;
  FE_UNROLL
  for (int i = 0; i < 10; ++i) r.v[i] = 0;
  return r;
}

FE_HD fe fe_one() {
  fe r = fe_zero();
  r.v[0] = 1;
  return r;
}

FE_HD fe fe_add(const fe &f, const fe &g) {
  int64_t h[10];
  FE_UNROLL
  for (int i = 0; i < 10; ++i) h[i] = (int64_t)f.v[i] + g.v[i];
  fe r;
  carry(h, r);
  return r;
}

FE_HD fe fe_sub(const fe &f, const fe &g) {
  int64_t h[10];
  FE_UNROLL
  for (int i = 0; i < 10; ++i) h[i] = (int64_t)f.v[i] - g.v[i];
  fe r;
  carry(h, r);
  return r;
}

FE_HD fe fe_neg(const fe &f) { return fe_sub(fe_zero(), f); }

// h = f * g. Term f_i g_j lands in column i+j, or in column i+j-10 times
// 19 when i+j >= 10; it is doubled when i and j are both odd, since
// ceil(25.5 i) + ceil(25.5 j) = 25.5 (i+j) + 1 then.
FE_HD fe fe_mul(const fe &f, const fe &g) {
  int32_t g19[10], f2[10];
  FE_UNROLL
  for (int i = 0; i < 10; ++i) {
    g19[i] = 19 * g.v[i];
    f2[i] = 2 * f.v[i];
  }
  int64_t h[10];
  FE_UNROLL
  for (int k = 0; k < 10; ++k) h[k] = 0;
  FE_UNROLL
  for (int i = 0; i < 10; ++i) {
    FE_UNROLL
    for (int j = 0; j < 10; ++j) {
      const int32_t a = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      const int32_t b = (i + j >= 10) ? g19[j] : g.v[j];
      h[(i + j) % 10] += (int64_t)a * b;
    }
  }
  fe r;
  carry(h, r);
  return r;
}

FE_HD fe fe_sq(const fe &f) { return fe_mul(f, f); }

FE_HD fe fe_sqn(fe f, int n) {
  for (int i = 0; i < n; ++i) f = fe_sq(f);
  return f;
}

FE_HD fe fe_select(bool c, const fe &a, const fe &b) { return c ? a : b; }

// Little-endian 32 bytes -> limbs, bit 255 dropped. No range check: a
// value >= p is accepted and reduced by the arithmetic, as in the
// reference.
FE_HD fe fe_frombytes(const uint8_t s[32]) {
  uint64_t w[4];
  FE_UNROLL
  for (int k = 0; k < 4; ++k) {
    uint64_t x = 0;
    FE_UNROLL
    for (int b = 7; b >= 0; --b) x = (x << 8) | s[8 * k + b];
    w[k] = x;
  }
  w[3] &= 0x7fffffffffffffffULL;
  fe r;
  int off = 0;
  FE_UNROLL
  for (int i = 0; i < 10; ++i) {
    const int bits = limb_bits(i);
    const int q = off >> 6, sh = off & 63;
    uint64_t x = w[q] >> sh;
    if (sh + bits > 64) x |= w[q + 1] << (64 - sh);
    r.v[i] = (int32_t)(x & ((1ULL << bits) - 1));
    off += bits;
  }
  return r;
}

// Floor carry: limbs end in [0, 2^w); the carry out of limb 9 re-enters
// limb 0 with weight 19. Returns that carry.
FE_HD int32_t floor_carry(int32_t h[10]) {
  int32_t c = 0;
  FE_UNROLL
  for (int i = 0; i < 10; ++i) {
    const int w = limb_bits(i);
    c = h[i] >> w;  // arithmetic shift: floor division
    h[i] -= c * (1 << w);
    if (i < 9) h[i + 1] += c;
  }
  return c;
}

// Canonical little-endian encoding (fully reduced below p).
FE_HD void fe_tobytes(uint8_t out[32], const fe &f) {
  int32_t h[10];
  FE_UNROLL
  for (int i = 0; i < 10; ++i) h[i] = f.v[i];
  // Three floor passes bring the value into [0, 2^255): the first leaves
  // it in [-38, 2^255 + 19), the second wraps either end, the third is
  // a no-op kept for margin.
  for (int pass = 0; pass < 3; ++pass) h[0] += 19 * floor_carry(h);
  // Subtract p when value + 19 reaches 2^255.
  int32_t t[10];
  FE_UNROLL
  for (int i = 0; i < 10; ++i) t[i] = h[i];
  t[0] += 19;
  const int32_t ge_p = floor_carry(t);  // 0 or 1
  FE_UNROLL
  for (int i = 0; i < 10; ++i) h[i] = ge_p ? t[i] : h[i];
  uint64_t w[4] = {0, 0, 0, 0};
  int off = 0;
  FE_UNROLL
  for (int i = 0; i < 10; ++i) {
    const uint64_t x = (uint64_t)(uint32_t)h[i];
    const int q = off >> 6, sh = off & 63;
    w[q] |= x << sh;
    if (sh + limb_bits(i) > 64) w[q + 1] |= x >> (64 - sh);
    off += limb_bits(i);
  }
  FE_UNROLL
  for (int k = 0; k < 32; ++k) out[k] = (uint8_t)(w[k >> 3] >> (8 * (k & 7)));
}

FE_HD bool bytes_eq(const uint8_t a[32], const uint8_t b[32]) {
  uint8_t d = 0;
  FE_UNROLL
  for (int k = 0; k < 32; ++k) d |= a[k] ^ b[k];
  return d == 0;
}

// (z^(2^250-1), z^11): the shared prefix of the curve25519 chains.
FE_HD void chain_250(const fe &z, fe &z_250_0, fe &z11) {
  const fe z2 = fe_sq(z);
  const fe z9 = fe_mul(z, fe_sqn(z2, 2));
  z11 = fe_mul(z2, z9);
  const fe z_5_0 = fe_mul(z9, fe_sq(z11));
  const fe z_10_0 = fe_mul(fe_sqn(z_5_0, 5), z_5_0);
  const fe z_20_0 = fe_mul(fe_sqn(z_10_0, 10), z_10_0);
  const fe z_40_0 = fe_mul(fe_sqn(z_20_0, 20), z_20_0);
  const fe z_50_0 = fe_mul(fe_sqn(z_40_0, 10), z_10_0);
  const fe z_100_0 = fe_mul(fe_sqn(z_50_0, 50), z_50_0);
  const fe z_200_0 = fe_mul(fe_sqn(z_100_0, 100), z_100_0);
  z_250_0 = fe_mul(fe_sqn(z_200_0, 50), z_50_0);
}

FE_HD fe fe_invert(const fe &z) {  // z^(p-2); 0 maps to 0
  fe z_250_0, z11;
  chain_250(z, z_250_0, z11);
  return fe_mul(fe_sqn(z_250_0, 5), z11);
}

FE_HD fe fe_pow_p58(const fe &z) {  // z^((p-5)/8)
  fe z_250_0, z11;
  chain_250(z, z_250_0, z11);
  return fe_mul(fe_sqn(z_250_0, 2), z);
}

// ---------------------------------------------------------------------------
// Points: extended (X, Y, Z, T); table points keep T pre-multiplied by 2d.
// ---------------------------------------------------------------------------

struct pt3 {  // a point whose T nobody will read
  fe X, Y, Z;
};

struct pt4 {
  fe X, Y, Z, T;
};

// p + q (add-2008-hwcd-3, a = -1) where q.T holds T*2d. `affine` means
// q.Z == 1, so Z1*Z2 is Z1. The output T is computed only when asked.
FE_HD void pt_add_tbl(pt4 &r, const pt4 &p, const fe &qX, const fe &qY,
                      const fe *qZ, const fe &qTd2, bool want_t) {
  const fe A = fe_mul(fe_sub(p.Y, p.X), fe_sub(qY, qX));
  const fe B = fe_mul(fe_add(p.Y, p.X), fe_add(qY, qX));
  const fe C = fe_mul(p.T, qTd2);
  const fe Zp = qZ ? fe_mul(p.Z, *qZ) : p.Z;
  const fe Dv = fe_add(Zp, Zp);
  const fe E = fe_sub(B, A);
  const fe F = fe_sub(Dv, C);
  const fe G = fe_add(Dv, C);
  const fe H = fe_add(B, A);
  r.X = fe_mul(E, F);
  r.Y = fe_mul(G, H);
  r.Z = fe_mul(F, G);
  if (want_t) r.T = fe_mul(E, H);
}

// 2p (dbl-2008-hwcd, a = -1).
FE_HD void pt_double(pt4 &r, const fe &X1, const fe &Y1, const fe &Z1,
                     bool want_t) {
  const fe A = fe_sq(X1);
  const fe B = fe_sq(Y1);
  const fe Zs = fe_sq(Z1);
  const fe C = fe_add(Zs, Zs);
  const fe E = fe_sub(fe_sub(fe_sq(fe_add(X1, Y1)), A), B);
  const fe G = fe_sub(B, A);
  const fe F = fe_sub(G, C);
  const fe H = fe_sub(fe_neg(A), B);
  r.X = fe_mul(E, F);
  r.Y = fe_mul(G, H);
  r.Z = fe_mul(F, G);
  if (want_t) r.T = fe_mul(E, H);
}

// Constants, int32[51][10] in this radix: rows 3k+c are entry k of the
// table of multiples of B (c = 0: X, 1: Y, 2: T*2d; Z == 1), then D, D2,
// SQRT_M1.
enum { K_D = 48, K_D2 = 49, K_SQRT_M1 = 50, K_ROWS = 51 };

FE_HD fe load_const(const int32_t *consts, int row) {
  fe r;
  FE_UNROLL
  for (int i = 0; i < 10; ++i) r.v[i] = consts[10 * row + i];
  return r;
}

FE_HD int digit(const uint8_t s[32], int w) {
  return (s[w >> 1] >> ((w & 1) * 4)) & 15;
}

// Decompress A and return -A's x, with the validity of the encoding.
// Mirrors the TPU kernel's decompress block: sqrt-ratio by the p58
// chain, both candidate roots judged on canonical bytes, x = 0 with the
// sign bit set rejected, the sign of x fixed from bit 255.
FE_HD bool decompress_neg(const uint8_t pk[32], const int32_t *consts,
                          fe &xn, fe &y) {
  y = fe_frombytes(pk);
  const int sign = pk[31] >> 7;
  const fe one = fe_one();
  const fe y2 = fe_sq(y);
  const fe u = fe_sub(y2, one);
  const fe v = fe_add(fe_mul(y2, load_const(consts, K_D)), one);
  const fe v3 = fe_mul(fe_sq(v), v);
  const fe v7 = fe_mul(fe_sq(v3), v);
  const fe r = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)));
  uint8_t check_b[32], u_b[32], nu_b[32], x_b[32];
  fe_tobytes(check_b, fe_mul(v, fe_sq(r)));
  fe_tobytes(u_b, u);
  fe_tobytes(nu_b, fe_neg(u));
  const bool ok_direct = bytes_eq(check_b, u_b);
  const bool ok_flipped = bytes_eq(check_b, nu_b);
  fe x = fe_select(ok_flipped && !ok_direct,
                   fe_mul(r, load_const(consts, K_SQRT_M1)), r);
  bool ok = ok_direct || ok_flipped;
  fe_tobytes(x_b, x);
  uint8_t nz = 0;
  FE_UNROLL
  for (int k = 0; k < 32; ++k) nz |= x_b[k];
  ok = ok && !(nz == 0 && sign == 1);
  const bool flip = (x_b[0] & 1) != sign;
  x = fe_select(flip, fe_neg(x), x);
  xn = fe_neg(x);
  return ok;
}

// The ladder after decompression: table of -A, Straus-w4 over the low
// n_windows windows, affine conversion, canonical encode, compare with R.
FE_HD bool ladder_tail(bool ok, const fe &xn, const fe &y,
                       const uint8_t rb[32], const uint8_t sb[32],
                       const uint8_t hb[32], const int32_t *consts,
                       int n_windows) {
  const fe d2 = load_const(consts, K_D2);
  const fe one = fe_one();
  const fe t = fe_mul(xn, y);
  // h_table[k] = k * (-A) with T*2d; indexed by the digit at run time,
  // so it lives in local memory.
  pt4 tbl[16];
  tbl[0].X = fe_zero();
  tbl[0].Y = one;
  tbl[0].Z = one;
  tbl[0].T = fe_zero();
  tbl[1].X = xn;
  tbl[1].Y = y;
  tbl[1].Z = one;
  tbl[1].T = fe_mul(t, d2);
  for (int k = 2; k < 16; ++k) {
    pt4 r;
    if ((k & 1) == 0) {
      pt_double(r, tbl[k >> 1].X, tbl[k >> 1].Y, tbl[k >> 1].Z, true);
    } else {
      pt_add_tbl(r, tbl[k - 1], xn, y, nullptr, t, true);
    }
    r.T = fe_mul(r.T, d2);
    tbl[k] = r;
  }
  pt4 acc;
  acc.X = fe_zero();
  acc.Y = one;
  acc.Z = one;
  for (int w = n_windows - 1; w >= 0; --w) {
    const int ds = ok ? digit(sb, w) : 0;
    const int dh = ok ? digit(hb, w) : 0;
    for (int i = 0; i < 3; ++i) pt_double(acc, acc.X, acc.Y, acc.Z, false);
    pt_double(acc, acc.X, acc.Y, acc.Z, true);
    pt4 r;
    pt_add_tbl(r, acc, load_const(consts, 3 * ds), load_const(consts, 3 * ds + 1),
               nullptr, load_const(consts, 3 * ds + 2), true);
    const pt4 &q = tbl[dh];
    pt_add_tbl(acc, r, q.X, q.Y, &q.Z, q.T, false);
  }
  const fe zi = fe_invert(acc.Z);
  uint8_t enc[32], xb[32];
  fe_tobytes(enc, fe_mul(acc.Y, zi));
  fe_tobytes(xb, fe_mul(acc.X, zi));
  enc[31] |= (uint8_t)((xb[0] & 1) << 7);
  return ok && bytes_eq(enc, rb);
}

FE_HD bool verify_full_one(const uint8_t pk[32], const uint8_t rb[32],
                           const uint8_t sb[32], const uint8_t hb[32],
                           const int32_t *consts, int n_windows) {
  fe xn, y;
  const bool ok = decompress_neg(pk, consts, xn, y);
  return ladder_tail(ok, xn, y, rb, sb, hb, consts, n_windows);
}

FE_HD bool verify_pre_one(const uint8_t xnb[32], const uint8_t yb[32],
                          bool ok, const uint8_t rb[32], const uint8_t sb[32],
                          const uint8_t hb[32], const int32_t *consts,
                          int n_windows) {
  return ladder_tail(ok, fe_frombytes(xnb), fe_frombytes(yb), rb, sb, hb,
                     consts, n_windows);
}

// enc(r*B) for a little-endian scalar r: the fixed-base subset of
// ladder_tail (no table of -A, no decompress). Per window, msb first:
// three doublings without T, one with T, then the affine add of
// digit * B from the s-table rows of consts, whose T nobody reads.
FE_HD void sign_rb_one(const uint8_t r[32], const int32_t *consts,
                       int n_windows, uint8_t out[32]) {
  pt4 acc;
  acc.X = fe_zero();
  acc.Y = fe_one();
  acc.Z = fe_one();
  for (int w = n_windows - 1; w >= 0; --w) {
    const int d = digit(r, w);
    for (int i = 0; i < 3; ++i) pt_double(acc, acc.X, acc.Y, acc.Z, false);
    pt_double(acc, acc.X, acc.Y, acc.Z, true);
    pt4 s;
    pt_add_tbl(s, acc, load_const(consts, 3 * d), load_const(consts, 3 * d + 1),
               nullptr, load_const(consts, 3 * d + 2), false);
    acc.X = s.X;
    acc.Y = s.Y;
    acc.Z = s.Z;
  }
  const fe zi = fe_invert(acc.Z);
  uint8_t xb[32];
  fe_tobytes(out, fe_mul(acc.Y, zi));
  fe_tobytes(xb, fe_mul(acc.X, zi));
  out[31] |= (uint8_t)((xb[0] & 1) << 7);
}

}  // namespace fe25519
