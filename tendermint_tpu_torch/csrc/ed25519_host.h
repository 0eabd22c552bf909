// Host half of batched Ed25519 for the port: a portable SHA-512, the
// reduction of a 512-bit digest mod L, the s < L check, and the one-call
// verify prep tm_ed25519_prepare (plain C ABI, loaded with ctypes).
//
// Verify prep: h = SHA512(R || A || M) mod L per signature, a 32-byte
// little-endian scalar, and the s < L malleability precheck. Signing
// uses the same reduction for its nonces and challenges (prep.cpp).
//
// prep.cpp includes this header; the two build into one library.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Sha512 {
  uint64_t h[8];
  uint64_t len = 0;
  uint8_t buf[128];
  size_t buf_len = 0;

  Sha512() {
    static const uint64_t init[8] = {
        0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
        0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
        0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
    std::memcpy(h, init, sizeof(h));
  }

  static inline uint64_t rotr(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
  }

  void compress(const uint8_t *p) {
    static const uint64_t K[80] = {
        0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
        0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
        0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
        0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
        0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
        0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
        0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
        0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
        0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
        0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
        0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
        0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
        0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
        0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
        0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
        0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
        0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
        0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
        0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
        0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
        0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
        0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
        0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
        0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
        0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
        0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
        0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};
    uint64_t w[80];
    for (int i = 0; i < 16; i++) {
      uint64_t v = 0;
      for (int j = 0; j < 8; j++) v = (v << 8) | p[8 * i + j];
      w[i] = v;
    }
    for (int i = 16; i < 80; i++) {
      uint64_t s0 = rotr(w[i - 15], 1) ^ rotr(w[i - 15], 8) ^ (w[i - 15] >> 7);
      uint64_t s1 = rotr(w[i - 2], 19) ^ rotr(w[i - 2], 61) ^ (w[i - 2] >> 6);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint64_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 80; i++) {
      uint64_t S1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
      uint64_t ch = (e & f) ^ (~e & g);
      uint64_t t1 = hh + S1 + ch + K[i] + w[i];
      uint64_t S0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
      uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint64_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t *data, size_t n) {
    len += n;
    if (buf_len) {
      size_t take = 128 - buf_len;
      if (take > n) take = n;
      std::memcpy(buf + buf_len, data, take);
      buf_len += take;
      data += take;
      n -= take;
      if (buf_len == 128) {
        compress(buf);
        buf_len = 0;
      }
    }
    while (n >= 128) {
      compress(data);
      data += 128;
      n -= 128;
    }
    if (n) {
      std::memcpy(buf, data, n);
      buf_len = n;
    }
  }

  void final(uint8_t out[64]) {
    uint64_t bits = len * 8;  // messages here are far below 2^61 bytes
    size_t bl = buf_len;
    buf[bl++] = 0x80;
    if (bl > 112) {
      std::memset(buf + bl, 0, 128 - bl);
      compress(buf);
      bl = 0;
    }
    std::memset(buf + bl, 0, 120 - bl);
    for (int i = 0; i < 8; i++) buf[120 + i] = uint8_t(bits >> (56 - 8 * i));
    compress(buf);
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++)
        out[8 * i + j] = uint8_t(h[i] >> (56 - 8 * j));
  }
};

// Group order L = 2^252 + 27742317777372353535851937790883648493, as five
// 64-bit little-endian limbs (top limb holds bit 252).
static const uint64_t L_LIMBS[5] = {0x5812631a5cf5d3edULL,
                                    0x14def9dea2f79cd6ULL, 0ULL,
                                    0x1000000000000000ULL, 0ULL};

// acc (5 limbs, < 2^253-ish) = acc * 2^48 + chunk, then reduce below L:
// q = acc >> 252, acc -= q*L; the remainder may be negative by
// < q*c, so at most one add-back of L restores the range.
struct Acc320 {
  uint64_t v[5] = {0, 0, 0, 0, 0};

  void push_u48(uint64_t b) {
    // multiply by 2^48: shift left across limbs (acc < 2^253 after the
    // previous reduce, so the result fits 301 bits < 320)
    uint64_t carry = b;
    for (int i = 0; i < 5; i++) {
      unsigned __int128 t = ((unsigned __int128)v[i] << 48) | carry;
      v[i] = (uint64_t)t;
      carry = (uint64_t)(t >> 64);
    }
    // reduce: q = bits above 252 (< 2^49; q*L limb products fit u128,
    // and the post-subtract deficit is < q*c < 2^174 << L, so one
    // add-back still restores the range)
    uint64_t q = v[3] >> 60 | (v[4] << 4);  // acc >> 252, fits well in 64
    if (q) {
      // acc -= q * L  (borrow-propagating)
      unsigned __int128 borrow = 0;
      for (int i = 0; i < 5; i++) {
        unsigned __int128 sub =
            (unsigned __int128)q * L_LIMBS[i] + borrow;
        uint64_t s_lo = (uint64_t)sub;
        borrow = sub >> 64;
        if (v[i] < s_lo) borrow++;
        v[i] -= s_lo;
      }
      // negative (borrow out) => add L back once
      if (borrow) {
        unsigned __int128 carry2 = 0;
        for (int i = 0; i < 5; i++) {
          carry2 += (unsigned __int128)v[i] + L_LIMBS[i];
          v[i] = (uint64_t)carry2;
          carry2 >>= 64;
        }
      }
    }
  }

  // final canonical reduction below L (value is < 2^253 here)
  void canonicalize() {
    // subtract L while >= L (at most twice)
    for (int rep = 0; rep < 2; rep++) {
      uint64_t t[5];
      unsigned __int128 borrow = 0;
      for (int i = 0; i < 5; i++) {
        unsigned __int128 sub = (unsigned __int128)L_LIMBS[i] + borrow;
        uint64_t s_lo = (uint64_t)sub;
        borrow = sub >> 64;
        if (v[i] < s_lo) borrow++;
        t[i] = v[i] - s_lo;
      }
      if (!borrow) std::memcpy(v, t, sizeof(t));
    }
  }

  void to_bytes_le(uint8_t out[32]) {
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 8; j++) out[8 * i + j] = uint8_t(v[i] >> (8 * j));
  }
};

// digest (64 bytes little-endian integer) mod L -> 32 bytes little-endian.
// 48-bit chunks land on whole bytes (6 each): 11 chunks cover 528 >= 512
// bits, MSB chunk first; the top chunk only has 4 real bytes.
inline void reduce512_mod_l(const uint8_t digest[64], uint8_t out[32]) {
  Acc320 acc;
  for (int k = 10; k >= 0; k--) {
    uint64_t w = 0;
    int base = 6 * k, nb = (k == 10) ? 4 : 6;
    for (int j = nb - 1; j >= 0; j--) w = (w << 8) | digest[base + j];
    acc.push_u48(w);
  }
  acc.canonicalize();
  acc.to_bytes_le(out);
}

// s (32 bytes LE) < L ?
inline bool scalar_below_l(const uint8_t s[32]) {
  uint8_t l_bytes[32];
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 8; j++)
      l_bytes[8 * i + j] = uint8_t(L_LIMBS[i] >> (8 * j));
  for (int i = 31; i >= 0; i--) {
    if (s[i] < l_bytes[i]) return true;
    if (s[i] > l_bytes[i]) return false;
  }
  return false;  // s == L
}

}  // namespace

extern "C" {

// Ed25519 batch host-prep (ops/ed25519.py prepare_batch_bytes):
// pk[n*32], sigs[n*64], msgs concatenated with bounds in offsets[n+1].
// Writes h_out[n*32] = SHA512(R||A||M) mod L (little-endian) and
// pre_out[n] = 1 when the signature passes the s < L precheck (pk/sig
// lengths are fixed by the caller's layout). Entries failing the
// precheck get h = 0 so the device batch shape stays static.
void tm_ed25519_prepare(const uint8_t *pk, const uint8_t *sigs,
                        const uint8_t *msgs, const uint64_t *offsets,
                        uint64_t n, uint8_t *h_out, uint8_t *pre_out) {
  for (uint64_t i = 0; i < n; i++) {
    const uint8_t *sig = sigs + 64 * i;
    if (!scalar_below_l(sig + 32)) {
      std::memset(h_out + 32 * i, 0, 32);
      pre_out[i] = 0;
      continue;
    }
    Sha512 s;
    s.update(sig, 32);             // R
    s.update(pk + 32 * i, 32);     // A
    s.update(msgs + offsets[i], offsets[i + 1] - offsets[i]);
    uint8_t digest[64];
    s.final(digest);
    // digest bytes are a little-endian integer; reduce mod L
    reduce512_mod_l(digest, h_out + 32 * i);
    pre_out[i] = 1;
  }
}

}  // extern "C"
