// GF(2^255-19), edwards25519 points, the per-signature verify ladder and
// the fixed-base r*B of signing, as __host__ __device__ inline functions:
// nvcc builds them into the Hopper kernels (ladder.cu), g++ builds the
// same source into a CPU shim
// (cpu_shim.cpp) that the CPU tests hold against the plain PyTorch
// version (ops/ladder.py).
//
// B1/B2 run four lanes per signature (the 4-lane schedule below); B3
// runs one thread per scalar on the fixed-base comb (sign_rb_comb).
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

// ---------------------------------------------------------------------------
// Four lanes per signature. The extended-coordinates formulas do each
// point operation in two rounds of four independent field products
// (Hisil, Wong, Carter, Dawson, "Twisted Edwards curves revisited",
// 2008): a doubling is X^2, Y^2, Z^2, (X+Y)^2, then E F, G H, F G, E H.
// A group of four lanes verifies one signature: in each round lane k
// computes product k, and the group exchanges the four, so every lane
// holds the whole point and runs the same instructions.
//
// The schedule is written once, over a group type G that supplies the
// exchange:
//   g.mul4(operands, out)   out[k] = a_k * b_k for k = 0..3, where
//                           operands(k, a, b) sets product k's factors;
//   typename G::table       the table of -A in cached form, of which a
//                           lane needs only its own column.
// group_host (below) stands for a group on one host thread: it computes
// the four products in turn and keeps all four columns. The card's group
// (ladder.cu) computes one product per lane and shuffles.
// ---------------------------------------------------------------------------

// x_k by selects: an array indexed by a run-time k would go to local
// memory on the card.
FE_HD fe sel4(int k, const fe &a0, const fe &a1, const fe &a2,
              const fe &a3) {
  fe r;
  FE_UNROLL
  for (int i = 0; i < 10; ++i)
    r.v[i] = k == 0 ? a0.v[i] : k == 1 ? a1.v[i] : k == 2 ? a2.v[i] : a3.v[i];
  return r;
}

struct group_host {
  template <class F>
  FE_HD void mul4(F operands, fe out[4]) const {
    for (int k = 0; k < 4; ++k) {
      fe a, b;
      operands(k, a, b);
      out[k] = fe_mul(a, b);
    }
  }
  struct table {
    fe c[16][4];
    FE_HD explicit table(const group_host &) {}
    FE_HD void set(int e, const fe &c0, const fe &c1, const fe &c2,
                   const fe &c3) {
      c[e][0] = c0;
      c[e][1] = c1;
      c[e][2] = c2;
      c[e][3] = c3;
    }
    FE_HD const fe &col(int e, int k) const { return c[e][k]; }
  };
};

// Round 2 of every operation: (X, Y, Z, T) = (E F, G H, F G, E H).
template <class G>
FE_HD void round2(const G &g, const fe &E, const fe &F, const fe &Gv,
                  const fe &H, pt4 &r) {
  fe o[4];
  g.mul4([&](int k, fe &a, fe &b) {
    a = sel4(k, E, Gv, F, E);
    b = sel4(k, F, H, Gv, H);
  }, o);
  r.X = o[0];
  r.Y = o[1];
  r.Z = o[2];
  r.T = o[3];
}

// p = 2p (dbl-2008-hwcd, a = -1), the same field operations as
// pt_double; T is always computed.
template <class G>
FE_HD void dbl4(const G &g, pt4 &p) {
  const fe s = fe_add(p.X, p.Y);
  fe q[4];
  g.mul4([&](int k, fe &a, fe &b) {
    a = sel4(k, p.X, p.Y, p.Z, s);
    b = a;
  }, q);
  const fe C = fe_add(q[2], q[2]);
  const fe E = fe_sub(fe_sub(q[3], q[0]), q[1]);
  const fe Gv = fe_sub(q[1], q[0]);
  const fe F = fe_sub(Gv, C);
  const fe H = fe_sub(fe_neg(q[0]), q[1]);
  round2(g, E, F, Gv, H, p);
}

// Round 1 of an add gave q = (A, B, C, .); Dv is 2 Z1 Z2.
template <class G>
FE_HD void add4_finish(const G &g, const fe q[4], const fe &Dv, pt4 &p) {
  const fe E = fe_sub(q[1], q[0]);
  const fe F = fe_sub(Dv, q[2]);
  const fe Gv = fe_add(Dv, q[2]);
  const fe H = fe_add(q[1], q[0]);
  round2(g, E, F, Gv, H, p);
}

// p = p + q for an affine q = (X2, Y2, T2*2d) (add-2008-hwcd-3, a = -1,
// the same field operations as pt_add_tbl with qZ null). Round 1 is
// (Y1-X1)(Y2-X2), (Y1+X1)(Y2+X2), T1 T2d; lane 3's product is not used,
// since Z1 Z2 = Z1.
template <class G>
FE_HD void add4_affine(const G &g, pt4 &p, const fe &qX, const fe &qY,
                       const fe &qTd2) {
  const fe ymx = fe_sub(p.Y, p.X), ypx = fe_add(p.Y, p.X);
  const fe qymx = fe_sub(qY, qX), qypx = fe_add(qY, qX);
  fe q[4];
  g.mul4([&](int k, fe &a, fe &b) {
    a = sel4(k, ymx, ypx, p.T, p.Z);
    b = sel4(k, qymx, qypx, qTd2, qTd2);
  }, q);
  add4_finish(g, q, fe_add(p.Z, p.Z), p);
}

// p = p + entry e of a table in cached form (Y2-X2, Y2+X2, T2*2d, Z2),
// the same field operations as pt_add_tbl with qZ set. Lane k reads only
// column k: round 1 is (Y1-X1) c0, (Y1+X1) c1, T1 c2, Z1 c3.
template <class G>
FE_HD void add4_cached(const G &g, pt4 &p, const typename G::table &tbl,
                       int e) {
  const fe ymx = fe_sub(p.Y, p.X), ypx = fe_add(p.Y, p.X);
  fe q[4];
  g.mul4([&](int k, fe &a, fe &b) {
    a = sel4(k, ymx, ypx, p.T, p.Z);
    b = tbl.col(e, k);
  }, q);
  add4_finish(g, q, fe_add(q[3], q[3]), p);
}

// Store (X, Y, Z, T) as entry e of a cached table; Td2 is T*2d.
template <class Table>
FE_HD void put_cached(Table &tbl, int e, const fe &X, const fe &Y,
                      const fe &Z, const fe &Td2) {
  tbl.set(e, fe_sub(Y, X), fe_add(Y, X), Td2, Z);
}

// The table of k * (-A), k = 0..15, each entry one add of -A to the one
// before (complete formulas, so 2 * (-A) too). Entries are other
// projective representatives than the one-thread schedule's (which
// doubles the even ones); the ladder's affine result is the same.
template <class G>
FE_HD void build_table4(const G &g, const fe &xn, const fe &y,
                        const fe &d2, typename G::table &tbl) {
  const fe zero = fe_zero(), one = fe_one();
  pt4 p;
  p.X = xn;
  p.Y = y;
  p.Z = one;
  p.T = fe_mul(xn, y);
  const fe td2 = fe_mul(p.T, d2);
  put_cached(tbl, 0, zero, one, one, zero);
  put_cached(tbl, 1, xn, y, one, td2);
  for (int e = 2; e < 16; ++e) {
    add4_affine(g, p, xn, y, td2);
    put_cached(tbl, e, p.X, p.Y, p.Z, fe_mul(p.T, d2));
  }
}

// The ladder after decompression: table of -A, Straus-w4 over the low
// n_windows windows (msb first: four doublings, the affine add of
// digit_s * B from the rows of consts, the add of digit_h * (-A)),
// affine conversion, canonical encode, compare with R. The inverse and
// the encode are one serial chain, run by every lane of a group alike.
template <class G>
FE_HD bool ladder4(const G &g, bool ok, const fe &xn, const fe &y,
                   const uint8_t rb[32], const uint8_t sb[32],
                   const uint8_t hb[32], const int32_t *consts,
                   int n_windows) {
  typename G::table tbl(g);
  build_table4(g, xn, y, load_const(consts, K_D2), tbl);
  pt4 acc;
  acc.X = fe_zero();
  acc.Y = fe_one();
  acc.Z = fe_one();
  acc.T = fe_zero();
  for (int w = n_windows - 1; w >= 0; --w) {
    const int ds = ok ? digit(sb, w) : 0;
    const int dh = ok ? digit(hb, w) : 0;
    for (int i = 0; i < 4; ++i) dbl4(g, acc);
    add4_affine(g, acc, load_const(consts, 3 * ds),
                load_const(consts, 3 * ds + 1), load_const(consts, 3 * ds + 2));
    add4_cached(g, acc, tbl, dh);
  }
  const fe zi = fe_invert(acc.Z);
  uint8_t enc[32], xb[32];
  fe_tobytes(enc, fe_mul(acc.Y, zi));
  fe_tobytes(xb, fe_mul(acc.X, zi));
  enc[31] |= (uint8_t)((xb[0] & 1) << 7);
  return ok && bytes_eq(enc, rb);
}

// The fused verify (B1): decompression of A, serial on every lane, then
// the 4-lane ladder.
template <class G>
FE_HD bool verify4_full(const G &g, const uint8_t pk[32],
                        const uint8_t rb[32], const uint8_t sb[32],
                        const uint8_t hb[32], const int32_t *consts,
                        int n_windows) {
  fe xn, y;
  const bool ok = decompress_neg(pk, consts, xn, y);
  return ladder4(g, ok, xn, y, rb, sb, hb, consts, n_windows);
}

// The predecompressed verify (B2): cached bytes of (-A).x and A.y.
template <class G>
FE_HD bool verify4_pre(const G &g, const uint8_t xnb[32],
                       const uint8_t yb[32], bool ok, const uint8_t rb[32],
                       const uint8_t sb[32], const uint8_t hb[32],
                       const int32_t *consts, int n_windows) {
  return ladder4(g, ok, fe_frombytes(xnb), fe_frombytes(yb), rb, sb, hb,
                 consts, n_windows);
}

// ---------------------------------------------------------------------------
// Signing's r*B: the fixed-base comb (ref10's ge_scalarmult_base). B is
// fixed, so instead of doubling between windows, window w adds a multiple
// of 16^w * B read from a table: the comb, int32[65][COMB_J][3][10],
// entry [w][j-1] = j * 16^w * B, affine, as (y - x, y + x, 2d x y)
// (ops/ladder.py derives it from the installed s-table). Row 64 holds
// the multiples of 2^256 * B, for the carry out of a 64th window.
// ---------------------------------------------------------------------------

enum { COMB_J = 8 };

// p = p + sign * comb[w][|d| - 1], or p itself for d = 0 (madd-2008-hwcd-3,
// a = -1, Z2 = 1): A, B, C, then X, Y, Z and, when asked, T. Negating the
// entry swaps y - x with y + x and negates 2dxy, which swaps F with G.
FE_HD void add_comb(pt4 &p, const int32_t *comb, int w, int d, bool want_t) {
  const int j = d < 0 ? -d : d;
  const int row = 3 * (COMB_J * w + (j > 0 ? j - 1 : 0));
  const bool neg = d < 0, zero = j == 0;
  // d = 0 adds the identity, (1, 1, 0) in this form
  const fe ymx = fe_select(zero, fe_one(), load_const(comb, row));
  const fe ypx = fe_select(zero, fe_one(), load_const(comb, row + 1));
  const fe t2d = fe_select(zero, fe_zero(), load_const(comb, row + 2));
  const fe A = fe_mul(fe_sub(p.Y, p.X), fe_select(neg, ypx, ymx));
  const fe B = fe_mul(fe_add(p.Y, p.X), fe_select(neg, ymx, ypx));
  const fe C = fe_mul(p.T, t2d);
  const fe Dv = fe_add(p.Z, p.Z);
  const fe E = fe_sub(B, A);
  const fe H = fe_add(B, A);
  const fe Dm = fe_sub(Dv, C), Dp = fe_add(Dv, C);
  const fe F = fe_select(neg, Dp, Dm);
  const fe G = fe_select(neg, Dm, Dp);
  p.X = fe_mul(E, F);
  p.Y = fe_mul(G, H);
  p.Z = fe_mul(F, G);
  if (want_t) p.T = fe_mul(E, H);
}

// enc(r*B) for a little-endian scalar r over its low n_windows 4-bit
// windows, one thread per scalar. The windows are recoded lsb first into
// signed digits in [-8, 7] (a window that reaches 8 with the carry in
// becomes itself minus 16 and carries 1 into the next); each adds its
// comb entry, and the carry out of window n_windows - 1 adds
// 16^n_windows * B (comb row n_windows, digit 0 or 1). So r may be any 32
// bytes, unreduced: the result is (r mod 16^n_windows) * B. Then the
// inverse and the encode.
FE_HD void sign_rb_comb(const uint8_t r[32], const int32_t *comb,
                        int n_windows, uint8_t out[32]) {
  pt4 acc;
  acc.X = fe_zero();
  acc.Y = fe_one();
  acc.Z = fe_one();
  acc.T = fe_zero();
  int carry = 0;
  for (int w = 0; w < n_windows; ++w) {
    const int e = digit(r, w) + carry;  // 0..16
    carry = (e + 8) >> 4;
    add_comb(acc, comb, w, e - 16 * carry, true);
  }
  add_comb(acc, comb, n_windows, carry, false);
  const fe zi = fe_invert(acc.Z);
  uint8_t xb[32];
  fe_tobytes(out, fe_mul(acc.Y, zi));
  fe_tobytes(xb, fe_mul(acc.X, zi));
  out[31] |= (uint8_t)((xb[0] & 1) << 7);
}

}  // namespace fe25519
