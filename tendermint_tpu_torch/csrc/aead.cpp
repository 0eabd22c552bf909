// ChaCha20-Poly1305 AEAD (RFC 8439) for the p2p SecretConnection frame
// plane: the port's copy of the JAX package's host AEAD
// (tendermint_tpu/native/hostops.cpp, its ChaCha20, Poly1305 and AEAD tag
// and the tm_aead_* entries).
//
// SecretConnection frames are <= 1042-byte ciphertexts sealed with a
// little-endian 96-bit counter nonce and empty aad. The burst entries
// seal or open a whole burst of frames in one C call (ctypes releases the
// GIL around it), with the same bytes a per-frame AEAD gives.
//
// Built with g++ at first use by tendermint_tpu_torch/native.py; the
// loader holds it to the RFC 8439 section 2.8.2 vector, a burst round
// trip and a tamper rejection before any frame goes through it.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

inline uint32_t le32(const uint8_t *p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

inline void st32(uint8_t *p, uint32_t v) {
  p[0] = uint8_t(v); p[1] = uint8_t(v >> 8);
  p[2] = uint8_t(v >> 16); p[3] = uint8_t(v >> 24);
}

inline uint32_t rotl32(uint32_t x, int n) {
  return (x << n) | (x >> (32 - n));
}

#define CHACHA_QR(a, b, c, d)                                  \
  a += b; d ^= a; d = rotl32(d, 16);                           \
  c += d; b ^= c; b = rotl32(b, 12);                           \
  a += b; d ^= a; d = rotl32(d, 8);                            \
  c += d; b ^= c; b = rotl32(b, 7);

// One 64-byte keystream block: state = consts || key || counter || nonce.
void chacha20_block(const uint32_t key[8], uint32_t counter,
                    const uint32_t nonce[3], uint8_t out[64]) {
  uint32_t s[16] = {0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
                    key[0], key[1], key[2], key[3],
                    key[4], key[5], key[6], key[7],
                    counter, nonce[0], nonce[1], nonce[2]};
  uint32_t w[16];
  std::memcpy(w, s, sizeof(w));
  for (int i = 0; i < 10; i++) {
    CHACHA_QR(w[0], w[4], w[8], w[12]);
    CHACHA_QR(w[1], w[5], w[9], w[13]);
    CHACHA_QR(w[2], w[6], w[10], w[14]);
    CHACHA_QR(w[3], w[7], w[11], w[15]);
    CHACHA_QR(w[0], w[5], w[10], w[15]);
    CHACHA_QR(w[1], w[6], w[11], w[12]);
    CHACHA_QR(w[2], w[7], w[8], w[13]);
    CHACHA_QR(w[3], w[4], w[9], w[14]);
  }
  for (int i = 0; i < 16; i++) st32(out + 4 * i, w[i] + s[i]);
}

// XOR `n` bytes of keystream starting at block `counter` into dst.
void chacha20_xor(const uint32_t key[8], uint32_t counter,
                  const uint32_t nonce[3], const uint8_t *src, size_t n,
                  uint8_t *dst) {
  uint8_t ks[64];
  while (n >= 64) {
    chacha20_block(key, counter++, nonce, ks);
    for (int i = 0; i < 64; i++) dst[i] = src[i] ^ ks[i];
    src += 64; dst += 64; n -= 64;
  }
  if (n) {
    chacha20_block(key, counter, nonce, ks);
    for (size_t i = 0; i < n; i++) dst[i] = src[i] ^ ks[i];
  }
}

// Poly1305 (poly1305-donna-32 limb schedule: 5 x 26-bit limbs).
struct Poly1305 {
  uint32_t r[5], h[5], pad[4];
  uint8_t buf[16];
  size_t buf_len = 0;

  explicit Poly1305(const uint8_t key[32]) {
    r[0] = (le32(key + 0)) & 0x3ffffff;
    r[1] = (le32(key + 3) >> 2) & 0x3ffff03;
    r[2] = (le32(key + 6) >> 4) & 0x3ffc0ff;
    r[3] = (le32(key + 9) >> 6) & 0x3f03fff;
    r[4] = (le32(key + 12) >> 8) & 0x00fffff;
    for (int i = 0; i < 5; i++) h[i] = 0;
    for (int i = 0; i < 4; i++) pad[i] = le32(key + 16 + 4 * i);
  }

  void blocks(const uint8_t *m, size_t n, uint32_t hibit) {
    const uint32_t s1 = r[1] * 5, s2 = r[2] * 5, s3 = r[3] * 5,
                   s4 = r[4] * 5;
    uint32_t h0 = h[0], h1 = h[1], h2 = h[2], h3 = h[3], h4 = h[4];
    while (n >= 16) {
      h0 += (le32(m + 0)) & 0x3ffffff;
      h1 += (le32(m + 3) >> 2) & 0x3ffffff;
      h2 += (le32(m + 6) >> 4) & 0x3ffffff;
      h3 += (le32(m + 9) >> 6) & 0x3ffffff;
      h4 += (le32(m + 12) >> 8) | hibit;
      uint64_t d0 = (uint64_t)h0 * r[0] + (uint64_t)h1 * s4 +
                    (uint64_t)h2 * s3 + (uint64_t)h3 * s2 +
                    (uint64_t)h4 * s1;
      uint64_t d1 = (uint64_t)h0 * r[1] + (uint64_t)h1 * r[0] +
                    (uint64_t)h2 * s4 + (uint64_t)h3 * s3 +
                    (uint64_t)h4 * s2;
      uint64_t d2 = (uint64_t)h0 * r[2] + (uint64_t)h1 * r[1] +
                    (uint64_t)h2 * r[0] + (uint64_t)h3 * s4 +
                    (uint64_t)h4 * s3;
      uint64_t d3 = (uint64_t)h0 * r[3] + (uint64_t)h1 * r[2] +
                    (uint64_t)h2 * r[1] + (uint64_t)h3 * r[0] +
                    (uint64_t)h4 * s4;
      uint64_t d4 = (uint64_t)h0 * r[4] + (uint64_t)h1 * r[3] +
                    (uint64_t)h2 * r[2] + (uint64_t)h3 * r[1] +
                    (uint64_t)h4 * r[0];
      uint64_t c;
      c = d0 >> 26; h0 = uint32_t(d0) & 0x3ffffff; d1 += c;
      c = d1 >> 26; h1 = uint32_t(d1) & 0x3ffffff; d2 += c;
      c = d2 >> 26; h2 = uint32_t(d2) & 0x3ffffff; d3 += c;
      c = d3 >> 26; h3 = uint32_t(d3) & 0x3ffffff; d4 += c;
      c = d4 >> 26; h4 = uint32_t(d4) & 0x3ffffff;
      h0 += uint32_t(c) * 5;
      c = h0 >> 26; h0 &= 0x3ffffff; h1 += uint32_t(c);
      m += 16; n -= 16;
    }
    h[0] = h0; h[1] = h1; h[2] = h2; h[3] = h3; h[4] = h4;
  }

  void update(const uint8_t *m, size_t n) {
    if (buf_len) {
      size_t take = 16 - buf_len;
      if (take > n) take = n;
      std::memcpy(buf + buf_len, m, take);
      buf_len += take; m += take; n -= take;
      if (buf_len == 16) { blocks(buf, 16, 1u << 24); buf_len = 0; }
    }
    size_t full = n & ~size_t(15);
    if (full) { blocks(m, full, 1u << 24); m += full; n -= full; }
    if (n) { std::memcpy(buf, m, n); buf_len = n; }
  }

  void final(uint8_t tag[16]) {
    if (buf_len) {  // final partial block: append 0x01, zero-fill, no hibit
      buf[buf_len] = 1;
      for (size_t i = buf_len + 1; i < 16; i++) buf[i] = 0;
      blocks(buf, 16, 0);
    }
    uint32_t h0 = h[0], h1 = h[1], h2 = h[2], h3 = h[3], h4 = h[4], c;
    c = h1 >> 26; h1 &= 0x3ffffff; h2 += c;
    c = h2 >> 26; h2 &= 0x3ffffff; h3 += c;
    c = h3 >> 26; h3 &= 0x3ffffff; h4 += c;
    c = h4 >> 26; h4 &= 0x3ffffff; h0 += c * 5;
    c = h0 >> 26; h0 &= 0x3ffffff; h1 += c;
    // select h or h - (2^130 - 5)
    uint32_t g0 = h0 + 5; c = g0 >> 26; g0 &= 0x3ffffff;
    uint32_t g1 = h1 + c; c = g1 >> 26; g1 &= 0x3ffffff;
    uint32_t g2 = h2 + c; c = g2 >> 26; g2 &= 0x3ffffff;
    uint32_t g3 = h3 + c; c = g3 >> 26; g3 &= 0x3ffffff;
    uint32_t g4 = h4 + c - (1u << 26);
    uint32_t mask = (g4 >> 31) - 1;  // all-ones when no borrow (h >= p)
    h0 = (h0 & ~mask) | (g0 & mask);
    h1 = (h1 & ~mask) | (g1 & mask);
    h2 = (h2 & ~mask) | (g2 & mask);
    h3 = (h3 & ~mask) | (g3 & mask);
    h4 = (h4 & ~mask) | (g4 & mask);
    // h mod 2^128 + pad
    h0 = (h0 | (h1 << 26));
    h1 = ((h1 >> 6) | (h2 << 20));
    h2 = ((h2 >> 12) | (h3 << 14));
    h3 = ((h3 >> 18) | (h4 << 8));
    uint64_t f;
    f = (uint64_t)h0 + pad[0]; h0 = uint32_t(f);
    f = (uint64_t)h1 + pad[1] + (f >> 32); h1 = uint32_t(f);
    f = (uint64_t)h2 + pad[2] + (f >> 32); h2 = uint32_t(f);
    f = (uint64_t)h3 + pad[3] + (f >> 32); h3 = uint32_t(f);
    st32(tag + 0, h0); st32(tag + 4, h1);
    st32(tag + 8, h2); st32(tag + 12, h3);
  }
};

const uint8_t kZeros16[16] = {0};

// RFC 8439 §2.8 tag: Poly1305(otk, aad || pad16 || ct || pad16 ||
// le64(aadlen) || le64(ctlen)), otk = first 32 keystream bytes of
// block 0.
void aead_tag(const uint32_t key[8], const uint32_t nonce[3],
              const uint8_t *aad, size_t aadlen, const uint8_t *ct,
              size_t ctlen, uint8_t tag[16]) {
  uint8_t block0[64];
  chacha20_block(key, 0, nonce, block0);
  Poly1305 poly(block0);
  if (aadlen) {
    poly.update(aad, aadlen);
    if (aadlen % 16) poly.update(kZeros16, 16 - aadlen % 16);
  }
  if (ctlen) {
    poly.update(ct, ctlen);
    if (ctlen % 16) poly.update(kZeros16, 16 - ctlen % 16);
  }
  uint8_t lens[16];
  for (int i = 0; i < 8; i++) {
    lens[i] = uint8_t(uint64_t(aadlen) >> (8 * i));
    lens[8 + i] = uint8_t(uint64_t(ctlen) >> (8 * i));
  }
  poly.update(lens, 16);
  poly.final(tag);
}

inline void load_key(const uint8_t key[32], uint32_t kw[8]) {
  for (int i = 0; i < 8; i++) kw[i] = le32(key + 4 * i);
}

// SecretConnection counter nonce: 96-bit little-endian frame counter.
inline void counter_nonce(uint64_t lo, uint32_t hi, uint32_t nonce[3]) {
  nonce[0] = uint32_t(lo);
  nonce[1] = uint32_t(lo >> 32);
  nonce[2] = hi;
}

}  // namespace

// --------------------------------------------------------------------------
// C ABI
// --------------------------------------------------------------------------

extern "C" {

// Single AEAD seal with an arbitrary 12-byte nonce and aad — exists so
// the loader can self-check against the RFC 8439 §2.8.2 vector before
// trusting the burst kernels. out = ct(ptlen) || tag(16).
void tm_aead_seal_one(const uint8_t *key, const uint8_t *nonce12,
                      const uint8_t *aad, uint64_t aadlen,
                      const uint8_t *pt, uint64_t ptlen, uint8_t *out) {
  uint32_t kw[8], nw[3];
  load_key(key, kw);
  for (int i = 0; i < 3; i++) nw[i] = le32(nonce12 + 4 * i);
  chacha20_xor(kw, 1, nw, pt, ptlen, out);
  aead_tag(kw, nw, aad, aadlen, out, ptlen, out + ptlen);
}

// Burst seal of SecretConnection frames. Inputs: chunk plaintexts
// concatenated in `data` with bounds in offsets[n+1] (each chunk is the
// <=1024-byte payload BEFORE the 2-byte length header). Frame i is
// sealed with nonce counter (nonce_lo + i, carrying into nonce_hi) and
// empty aad, and written to `out` as the exact wire bytes the per-frame
// path produces: be32(clen) || ct(2 + len) || tag(16). Total output is
// sum(len_i) + 22*n — fully determined by the offsets, so the caller
// allocates once and a single sendall pushes the whole burst.
void tm_aead_seal_burst(const uint8_t *key, uint64_t nonce_lo,
                        uint32_t nonce_hi, const uint8_t *data,
                        const uint64_t *offsets, uint64_t n,
                        uint8_t *out) {
  uint32_t kw[8];
  load_key(key, kw);
  uint8_t frame[2 + 1024 + 8];  // len header + max payload (+ slack)
  for (uint64_t i = 0; i < n; i++) {
    uint64_t len = offsets[i + 1] - offsets[i];
    uint64_t lo = nonce_lo + i;
    uint32_t hi = nonce_hi + (lo < nonce_lo ? 1 : 0);
    uint32_t nw[3];
    counter_nonce(lo, hi, nw);
    uint64_t ptlen = 2 + len;
    frame[0] = uint8_t(len >> 8);  // big-endian length header
    frame[1] = uint8_t(len);
    std::memcpy(frame + 2, data + offsets[i], len);
    uint32_t clen = uint32_t(ptlen + 16);
    out[0] = uint8_t(clen >> 24); out[1] = uint8_t(clen >> 16);
    out[2] = uint8_t(clen >> 8);  out[3] = uint8_t(clen);
    chacha20_xor(kw, 1, nw, frame, ptlen, out + 4);
    aead_tag(kw, nw, nullptr, 0, out + 4, ptlen, out + 4 + ptlen);
    out += 4 + clen;
  }
}

// Burst open. Inputs: sealed frames (ct || tag, WITHOUT the 4-byte wire
// length prefix) concatenated in `data` with bounds in offsets[n+1].
// Frame i opens with counter nonce (nonce_lo + i); plaintexts (still
// carrying their 2-byte length header) are written back-to-back into
// `out` (sum of (clen_i - 16) bytes). Returns n when every tag
// verifies, else the index of the first failing frame — opening stops
// there, matching the per-frame path where the connection dies on the
// first InvalidTag.
int64_t tm_aead_open_burst(const uint8_t *key, uint64_t nonce_lo,
                           uint32_t nonce_hi, const uint8_t *data,
                           const uint64_t *offsets, uint64_t n,
                           uint8_t *out) {
  uint32_t kw[8];
  load_key(key, kw);
  for (uint64_t i = 0; i < n; i++) {
    uint64_t clen = offsets[i + 1] - offsets[i];
    if (clen < 16) return int64_t(i);
    const uint8_t *ct = data + offsets[i];
    uint64_t ptlen = clen - 16;
    uint64_t lo = nonce_lo + i;
    uint32_t hi = nonce_hi + (lo < nonce_lo ? 1 : 0);
    uint32_t nw[3];
    counter_nonce(lo, hi, nw);
    uint8_t tag[16];
    aead_tag(kw, nw, nullptr, 0, ct, ptlen, tag);
    uint8_t diff = 0;  // constant-time-ish compare before decrypting
    for (int j = 0; j < 16; j++) diff |= tag[j] ^ ct[ptlen + j];
    if (diff) return int64_t(i);
    chacha20_xor(kw, 1, nw, ct, ptlen, out);
    out += ptlen;
  }
  return int64_t(n);
}

}  // extern "C"
