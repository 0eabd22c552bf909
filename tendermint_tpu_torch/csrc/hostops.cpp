// Native host ops of the port: SHA-256, Merkle trees and part sets.
//
// The port's copy of the parts of tendermint_tpu/native/hostops.cpp that
// its host Merkle plane needs: SHA-256 with the SHA-NI compress and its
// CPUID probe, the zero-padding chain and root_from_digests, and the C
// entries tm_sha256_batch, tm_merkle_root, tm_merkle_root_from_digests,
// tm_merkle_proof, tm_merkle_tree_proofs and tm_partset_build; and, for
// the async RPC front door, tm_sendmany (one tick's socket writes in one
// call). The
// Ed25519 prep lives in prep.cpp / ed25519_host.h and the AEAD in
// aead.cpp. kvcore.cpp includes this file for its SHA-256 and bucket
// root.
//
// Spec, bit-identical to ops/merkle.py's plain host functions:
//   leaf  = SHA256(0x00 || item)
//   node  = SHA256(0x01 || left || right)
//   pad   = 32 zero bytes
//   root  = SHA256(0x02 || uint64_le(n) || tree_root)
//
// Built with g++ by tendermint_tpu_torch/native.py (plain C ABI, loaded
// with ctypes). -DTM_SHA256_PORTABLE compiles the SHA-NI route out, so
// that the portable compress can be tested on a CPU that has SHA-NI.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <vector>

#include <sys/socket.h>

#if defined(__x86_64__) && !defined(TM_SHA256_PORTABLE)
#define TM_SHANI 1
#endif

#if defined(TM_SHANI)
#include <cpuid.h>
#include <immintrin.h>
#endif

// --------------------------------------------------------------------------
// SHA-256 (FIPS 180-4) — portable compress + SHA-NI hardware compress with
// runtime dispatch (the merkle tree is thousands of small hashes; SHA-NI
// is ~5x the portable path)
// --------------------------------------------------------------------------

namespace {

#if defined(TM_SHANI)
__attribute__((target("sha,sse4.1,ssse3")))
void compress_shani(uint32_t state[8], const uint8_t *data) {
  // Intel's canonical one-block SHA-NI schedule.
  __m128i STATE0, STATE1, MSG, TMP, MSG0, MSG1, MSG2, MSG3;
  __m128i ABEF_SAVE, CDGH_SAVE;
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);

  TMP = _mm_loadu_si128((const __m128i *)&state[0]);
  STATE1 = _mm_loadu_si128((const __m128i *)&state[4]);
  TMP = _mm_shuffle_epi32(TMP, 0xB1);
  STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);
  STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);
  STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);

  ABEF_SAVE = STATE0;
  CDGH_SAVE = STATE1;

#define QROUND(MSGV, K_HI, K_LO)                                     \
  MSG = _mm_add_epi32(MSGV, _mm_set_epi64x(K_HI, K_LO));             \
  STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);               \
  MSG = _mm_shuffle_epi32(MSG, 0x0E);                                \
  STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);

  MSG0 = _mm_shuffle_epi8(
      _mm_loadu_si128((const __m128i *)(data + 0)), MASK);
  QROUND(MSG0, 0xE9B5DBA5B5C0FBCFULL, 0x71374491428A2F98ULL);

  MSG1 = _mm_shuffle_epi8(
      _mm_loadu_si128((const __m128i *)(data + 16)), MASK);
  QROUND(MSG1, 0xAB1C5ED5923F82A4ULL, 0x59F111F13956C25BULL);
  MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);

  MSG2 = _mm_shuffle_epi8(
      _mm_loadu_si128((const __m128i *)(data + 32)), MASK);
  QROUND(MSG2, 0x550C7DC3243185BEULL, 0x12835B01D807AA98ULL);
  MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);

  MSG3 = _mm_shuffle_epi8(
      _mm_loadu_si128((const __m128i *)(data + 48)), MASK);
  QROUND(MSG3, 0xC19BF1749BDC06A7ULL, 0x80DEB1FE72BE5D74ULL);
  TMP = _mm_alignr_epi8(MSG3, MSG2, 4);
  MSG0 = _mm_add_epi32(MSG0, TMP);
  MSG0 = _mm_sha256msg2_epu32(MSG0, MSG3);
  MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);

  QROUND(MSG0, 0x240CA1CC0FC19DC6ULL, 0xEFBE4786E49B69C1ULL);
  TMP = _mm_alignr_epi8(MSG0, MSG3, 4);
  MSG1 = _mm_add_epi32(MSG1, TMP);
  MSG1 = _mm_sha256msg2_epu32(MSG1, MSG0);
  MSG3 = _mm_sha256msg1_epu32(MSG3, MSG0);

  QROUND(MSG1, 0x76F988DA5CB0A9DCULL, 0x4A7484AA2DE92C6FULL);
  TMP = _mm_alignr_epi8(MSG1, MSG0, 4);
  MSG2 = _mm_add_epi32(MSG2, TMP);
  MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);
  MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);

  QROUND(MSG2, 0xBF597FC7B00327C8ULL, 0xA831C66D983E5152ULL);
  TMP = _mm_alignr_epi8(MSG2, MSG1, 4);
  MSG3 = _mm_add_epi32(MSG3, TMP);
  MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);
  MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);

  QROUND(MSG3, 0x1429296706CA6351ULL, 0xD5A79147C6E00BF3ULL);
  TMP = _mm_alignr_epi8(MSG3, MSG2, 4);
  MSG0 = _mm_add_epi32(MSG0, TMP);
  MSG0 = _mm_sha256msg2_epu32(MSG0, MSG3);
  MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);

  QROUND(MSG0, 0x53380D134D2C6DFCULL, 0x2E1B213827B70A85ULL);
  TMP = _mm_alignr_epi8(MSG0, MSG3, 4);
  MSG1 = _mm_add_epi32(MSG1, TMP);
  MSG1 = _mm_sha256msg2_epu32(MSG1, MSG0);
  MSG3 = _mm_sha256msg1_epu32(MSG3, MSG0);

  QROUND(MSG1, 0x92722C8581C2C92EULL, 0x766A0ABB650A7354ULL);
  TMP = _mm_alignr_epi8(MSG1, MSG0, 4);
  MSG2 = _mm_add_epi32(MSG2, TMP);
  MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);
  MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);

  QROUND(MSG2, 0xC76C51A3C24B8B70ULL, 0xA81A664BA2BFE8A1ULL);
  TMP = _mm_alignr_epi8(MSG2, MSG1, 4);
  MSG3 = _mm_add_epi32(MSG3, TMP);
  MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);
  MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);

  QROUND(MSG3, 0x106AA070F40E3585ULL, 0xD6990624D192E819ULL);
  TMP = _mm_alignr_epi8(MSG3, MSG2, 4);
  MSG0 = _mm_add_epi32(MSG0, TMP);
  MSG0 = _mm_sha256msg2_epu32(MSG0, MSG3);
  MSG2 = _mm_sha256msg1_epu32(MSG2, MSG3);

  QROUND(MSG0, 0x34B0BCB52748774CULL, 0x1E376C0819A4C116ULL);
  TMP = _mm_alignr_epi8(MSG0, MSG3, 4);
  MSG1 = _mm_add_epi32(MSG1, TMP);
  MSG1 = _mm_sha256msg2_epu32(MSG1, MSG0);
  MSG3 = _mm_sha256msg1_epu32(MSG3, MSG0);

  QROUND(MSG1, 0x682E6FF35B9CCA4FULL, 0x4ED8AA4A391C0CB3ULL);
  TMP = _mm_alignr_epi8(MSG1, MSG0, 4);
  MSG2 = _mm_add_epi32(MSG2, TMP);
  MSG2 = _mm_sha256msg2_epu32(MSG2, MSG1);

  QROUND(MSG2, 0x8CC7020884C87814ULL, 0x78A5636F748F82EEULL);
  TMP = _mm_alignr_epi8(MSG2, MSG1, 4);
  MSG3 = _mm_add_epi32(MSG3, TMP);
  MSG3 = _mm_sha256msg2_epu32(MSG3, MSG2);

  QROUND(MSG3, 0xC67178F2BEF9A3F7ULL, 0xA4506CEB90BEFFFAULL);
#undef QROUND

  STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
  STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);

  TMP = _mm_shuffle_epi32(STATE0, 0x1B);
  STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);
  STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0);
  STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);

  _mm_storeu_si128((__m128i *)&state[0], STATE0);
  _mm_storeu_si128((__m128i *)&state[4], STATE1);
}

// Two independent blocks interleaved through one pass: sha256rnds2 is
// latency-bound (~6 cycles) but pipelined (~1/cycle throughput), so a
// second independent stream rides in the bubbles — measured ~1.7x over
// two sequential one-block calls. Used for tree levels / leaf batches /
// pair-digest batches, which are embarrassingly independent.
__attribute__((target("sha,sse4.1,ssse3")))
void compress_shani_x2(uint32_t stateA[8], const uint8_t *dataA,
                       uint32_t stateB[8], const uint8_t *dataB) {
  __m128i S0A, S1A, MSGA, M0A, M1A, M2A, M3A;
  __m128i S0B, S1B, MSGB, M0B, M1B, M2B, M3B;
  __m128i TMP, ABEFA, CDGHA, ABEFB, CDGHB;
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);

  TMP = _mm_loadu_si128((const __m128i *)&stateA[0]);
  S1A = _mm_loadu_si128((const __m128i *)&stateA[4]);
  TMP = _mm_shuffle_epi32(TMP, 0xB1);
  S1A = _mm_shuffle_epi32(S1A, 0x1B);
  S0A = _mm_alignr_epi8(TMP, S1A, 8);
  S1A = _mm_blend_epi16(S1A, TMP, 0xF0);
  TMP = _mm_loadu_si128((const __m128i *)&stateB[0]);
  S1B = _mm_loadu_si128((const __m128i *)&stateB[4]);
  TMP = _mm_shuffle_epi32(TMP, 0xB1);
  S1B = _mm_shuffle_epi32(S1B, 0x1B);
  S0B = _mm_alignr_epi8(TMP, S1B, 8);
  S1B = _mm_blend_epi16(S1B, TMP, 0xF0);

  ABEFA = S0A;
  CDGHA = S1A;
  ABEFB = S0B;
  CDGHB = S1B;

#define QROUND2(MA, MB, K_HI, K_LO)                                  \
  MSGA = _mm_add_epi32(MA, _mm_set_epi64x(K_HI, K_LO));              \
  MSGB = _mm_add_epi32(MB, _mm_set_epi64x(K_HI, K_LO));              \
  S1A = _mm_sha256rnds2_epu32(S1A, S0A, MSGA);                       \
  S1B = _mm_sha256rnds2_epu32(S1B, S0B, MSGB);                       \
  MSGA = _mm_shuffle_epi32(MSGA, 0x0E);                              \
  MSGB = _mm_shuffle_epi32(MSGB, 0x0E);                              \
  S0A = _mm_sha256rnds2_epu32(S0A, S1A, MSGA);                       \
  S0B = _mm_sha256rnds2_epu32(S0B, S1B, MSGB);
#define SCHED2(MX, MY, MZ)                                           \
  TMP = _mm_alignr_epi8(MZ##A, MY##A, 4);                            \
  MX##A = _mm_add_epi32(MX##A, TMP);                                 \
  MX##A = _mm_sha256msg2_epu32(MX##A, MZ##A);                        \
  MY##A = _mm_sha256msg1_epu32(MY##A, MZ##A);                        \
  TMP = _mm_alignr_epi8(MZ##B, MY##B, 4);                            \
  MX##B = _mm_add_epi32(MX##B, TMP);                                 \
  MX##B = _mm_sha256msg2_epu32(MX##B, MZ##B);                        \
  MY##B = _mm_sha256msg1_epu32(MY##B, MZ##B);

  M0A = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)dataA), MASK);
  M0B = _mm_shuffle_epi8(_mm_loadu_si128((const __m128i *)dataB), MASK);
  QROUND2(M0A, M0B, 0xE9B5DBA5B5C0FBCFULL, 0x71374491428A2F98ULL);

  M1A = _mm_shuffle_epi8(
      _mm_loadu_si128((const __m128i *)(dataA + 16)), MASK);
  M1B = _mm_shuffle_epi8(
      _mm_loadu_si128((const __m128i *)(dataB + 16)), MASK);
  QROUND2(M1A, M1B, 0xAB1C5ED5923F82A4ULL, 0x59F111F13956C25BULL);
  M0A = _mm_sha256msg1_epu32(M0A, M1A);
  M0B = _mm_sha256msg1_epu32(M0B, M1B);

  M2A = _mm_shuffle_epi8(
      _mm_loadu_si128((const __m128i *)(dataA + 32)), MASK);
  M2B = _mm_shuffle_epi8(
      _mm_loadu_si128((const __m128i *)(dataB + 32)), MASK);
  QROUND2(M2A, M2B, 0x550C7DC3243185BEULL, 0x12835B01D807AA98ULL);
  M1A = _mm_sha256msg1_epu32(M1A, M2A);
  M1B = _mm_sha256msg1_epu32(M1B, M2B);

  M3A = _mm_shuffle_epi8(
      _mm_loadu_si128((const __m128i *)(dataA + 48)), MASK);
  M3B = _mm_shuffle_epi8(
      _mm_loadu_si128((const __m128i *)(dataB + 48)), MASK);
  QROUND2(M3A, M3B, 0xC19BF1749BDC06A7ULL, 0x80DEB1FE72BE5D74ULL);
  SCHED2(M0, M2, M3);

  QROUND2(M0A, M0B, 0x240CA1CC0FC19DC6ULL, 0xEFBE4786E49B69C1ULL);
  SCHED2(M1, M3, M0);
  QROUND2(M1A, M1B, 0x76F988DA5CB0A9DCULL, 0x4A7484AA2DE92C6FULL);
  SCHED2(M2, M0, M1);
  QROUND2(M2A, M2B, 0xBF597FC7B00327C8ULL, 0xA831C66D983E5152ULL);
  SCHED2(M3, M1, M2);
  QROUND2(M3A, M3B, 0x1429296706CA6351ULL, 0xD5A79147C6E00BF3ULL);
  SCHED2(M0, M2, M3);
  QROUND2(M0A, M0B, 0x53380D134D2C6DFCULL, 0x2E1B213827B70A85ULL);
  SCHED2(M1, M3, M0);
  QROUND2(M1A, M1B, 0x92722C8581C2C92EULL, 0x766A0ABB650A7354ULL);
  SCHED2(M2, M0, M1);
  QROUND2(M2A, M2B, 0xC76C51A3C24B8B70ULL, 0xA81A664BA2BFE8A1ULL);
  SCHED2(M3, M1, M2);
  QROUND2(M3A, M3B, 0x106AA070F40E3585ULL, 0xD6990624D192E819ULL);
  SCHED2(M0, M2, M3);
  QROUND2(M0A, M0B, 0x34B0BCB52748774CULL, 0x1E376C0819A4C116ULL);
  SCHED2(M1, M3, M0);
  QROUND2(M1A, M1B, 0x682E6FF35B9CCA4FULL, 0x4ED8AA4A391C0CB3ULL);
  TMP = _mm_alignr_epi8(M1A, M0A, 4);
  M2A = _mm_add_epi32(M2A, TMP);
  M2A = _mm_sha256msg2_epu32(M2A, M1A);
  TMP = _mm_alignr_epi8(M1B, M0B, 4);
  M2B = _mm_add_epi32(M2B, TMP);
  M2B = _mm_sha256msg2_epu32(M2B, M1B);
  QROUND2(M2A, M2B, 0x8CC7020884C87814ULL, 0x78A5636F748F82EEULL);
  TMP = _mm_alignr_epi8(M2A, M1A, 4);
  M3A = _mm_add_epi32(M3A, TMP);
  M3A = _mm_sha256msg2_epu32(M3A, M2A);
  TMP = _mm_alignr_epi8(M2B, M1B, 4);
  M3B = _mm_add_epi32(M3B, TMP);
  M3B = _mm_sha256msg2_epu32(M3B, M2B);
  QROUND2(M3A, M3B, 0xC67178F2BEF9A3F7ULL, 0xA4506CEB90BEFFFAULL);
#undef QROUND2
#undef SCHED2

  S0A = _mm_add_epi32(S0A, ABEFA);
  S1A = _mm_add_epi32(S1A, CDGHA);
  S0B = _mm_add_epi32(S0B, ABEFB);
  S1B = _mm_add_epi32(S1B, CDGHB);

  TMP = _mm_shuffle_epi32(S0A, 0x1B);
  S1A = _mm_shuffle_epi32(S1A, 0xB1);
  S0A = _mm_blend_epi16(TMP, S1A, 0xF0);
  S1A = _mm_alignr_epi8(S1A, TMP, 8);
  _mm_storeu_si128((__m128i *)&stateA[0], S0A);
  _mm_storeu_si128((__m128i *)&stateA[4], S1A);
  TMP = _mm_shuffle_epi32(S0B, 0x1B);
  S1B = _mm_shuffle_epi32(S1B, 0xB1);
  S0B = _mm_blend_epi16(TMP, S1B, 0xF0);
  S1B = _mm_alignr_epi8(S1B, TMP, 8);
  _mm_storeu_si128((__m128i *)&stateB[0], S0B);
  _mm_storeu_si128((__m128i *)&stateB[4], S1B);
}

bool has_shani_probe() {
  // raw CPUID instead of __builtin_cpu_supports("sha"): the feature
  // string is only known to gcc >= 11, and an unknown string is a
  // COMPILE error — which silently killed the whole hostops build (and
  // every native fast path with it) on g++ 10 images.
  unsigned eax, ebx, ecx, edx;
  if (!__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx)) return false;
  bool sha = (ebx >> 29) & 1;
  if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
  bool sse41 = (ecx >> 19) & 1, ssse3 = (ecx >> 9) & 1;
  return sha && sse41 && ssse3;
}

bool has_shani() {
  static const bool ok = has_shani_probe();
  return ok;
}
#endif  // TM_SHANI

struct Sha256 {
  uint32_t h[8];
  uint64_t len = 0;
  uint8_t buf[64];
  size_t buf_len = 0;

  Sha256() {
    static const uint32_t init[8] = {
        0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
        0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    std::memcpy(h, init, sizeof(h));
  }

  static inline uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
  }

  void compress(const uint8_t *p) {
#if defined(TM_SHANI)
    if (has_shani()) {
      compress_shani(h, p);
      return;
    }
#endif
    compress_portable(p);
  }

  void compress_portable(const uint8_t *p) {
    static const uint32_t K[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
        0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
        0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
        0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
        0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
        0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
        0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
        0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
        0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
        0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
        0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t *data, size_t n) {
    len += n;
    if (buf_len) {
      size_t take = 64 - buf_len;
      if (take > n) take = n;
      std::memcpy(buf + buf_len, data, take);
      buf_len += take;
      data += take;
      n -= take;
      if (buf_len == 64) {
        compress(buf);
        buf_len = 0;
      }
    }
    while (n >= 64) {
      compress(data);
      data += 64;
      n -= 64;
    }
    if (n) {
      std::memcpy(buf, data, n);
      buf_len = n;
    }
  }

  void final(uint8_t out[32]) {
    // padding built in place (0x80, zero-fill, 8-byte BE bit length) —
    // the one-byte-at-a-time update() loop this replaces cost more
    // than the compression itself on sub-block messages
    uint64_t bits = len * 8;
    size_t bl = buf_len;
    buf[bl++] = 0x80;
    if (bl > 56) {
      std::memset(buf + bl, 0, 64 - bl);
      compress(buf);
      bl = 0;
    }
    std::memset(buf + bl, 0, 56 - bl);
    for (int i = 0; i < 8; i++) buf[56 + i] = uint8_t(bits >> (56 - 8 * i));
    compress(buf);
    for (int i = 0; i < 8; i++) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

// One-shot paths below build their padded message blocks directly and
// call compress() on them — the generic update()/final() streaming
// machinery costs more than the compression for the sub-block inputs
// (tree leaves, inner nodes, pair digests) that dominate the hot loops.

inline void sha256_state_out(const uint32_t h[8], uint8_t out[32]) {
  for (int i = 0; i < 8; i++) {
    out[4 * i] = uint8_t(h[i] >> 24);
    out[4 * i + 1] = uint8_t(h[i] >> 16);
    out[4 * i + 2] = uint8_t(h[i] >> 8);
    out[4 * i + 3] = uint8_t(h[i]);
  }
}

static const uint32_t SHA256_INIT[8] = {
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};

inline void sha256_compress_dispatch(uint32_t h[8], const uint8_t *p) {
#if defined(TM_SHANI)
  if (has_shani()) {
    compress_shani(h, p);
    return;
  }
#endif
  Sha256 tmp;
  std::memcpy(tmp.h, h, 32);
  tmp.compress_portable(p);
  std::memcpy(h, tmp.h, 32);
}

// single-block one-shot: total message length <= 55 bytes
inline void sha256_single_block(const uint8_t *data, size_t n,
                                uint8_t out[32]) {
  uint8_t blk[64];
  std::memcpy(blk, data, n);
  blk[n] = 0x80;
  std::memset(blk + n + 1, 0, 56 - (n + 1));
  uint64_t bits = uint64_t(n) * 8;
  for (int i = 0; i < 8; i++) blk[56 + i] = uint8_t(bits >> (56 - 8 * i));
  uint32_t h[8];
  std::memcpy(h, SHA256_INIT, sizeof(h));
  sha256_compress_dispatch(h, blk);
  sha256_state_out(h, out);
}

inline void sha256_one(const uint8_t *data, size_t n, uint8_t out[32]) {
  if (n <= 55) {
    sha256_single_block(data, n, out);
    return;
  }
  Sha256 s;
  s.update(data, n);
  s.final(out);
}

inline void pad_single_block(const uint8_t *data, size_t n,
                             uint8_t blk[64]) {
  std::memcpy(blk, data, n);
  blk[n] = 0x80;
  std::memset(blk + n + 1, 0, 56 - (n + 1));
  uint64_t bits = uint64_t(n) * 8;
  for (int i = 0; i < 8; i++) blk[56 + i] = uint8_t(bits >> (56 - 8 * i));
}

// two independent single-block messages (<= 55 bytes each), hashed
// through the interleaved SHA-NI pass when available
inline void sha256_single_block_x2(const uint8_t *a, size_t na,
                                   uint8_t outA[32], const uint8_t *b,
                                   size_t nb, uint8_t outB[32]) {
#if defined(TM_SHANI)
  if (has_shani()) {
    uint8_t blkA[64], blkB[64];
    pad_single_block(a, na, blkA);
    pad_single_block(b, nb, blkB);
    uint32_t hA[8], hB[8];
    std::memcpy(hA, SHA256_INIT, sizeof(hA));
    std::memcpy(hB, SHA256_INIT, sizeof(hB));
    compress_shani_x2(hA, blkA, hB, blkB);
    sha256_state_out(hA, outA);
    sha256_state_out(hB, outB);
    return;
  }
#endif
  sha256_single_block(a, na, outA);
  sha256_single_block(b, nb, outB);
}

inline void leaf_hash(const uint8_t *item, size_t n, uint8_t out[32]) {
  if (n <= 54) {
    uint8_t msg[55];
    msg[0] = 0x00;
    std::memcpy(msg + 1, item, n);
    sha256_single_block(msg, n + 1, out);
    return;
  }
  Sha256 s;
  uint8_t p = 0x00;
  s.update(&p, 1);
  s.update(item, n);
  s.final(out);
}

inline void leaf_hash_x2(const uint8_t *a, size_t na, uint8_t *outA,
                         const uint8_t *b, size_t nb, uint8_t *outB);

// hash a row of leaves, pairing short ones through the interleaved pass
inline void leaf_hash_row(const uint8_t *data, const uint64_t *offsets,
                          uint64_t n, uint8_t *out) {
  uint64_t i = 0;
  for (; i + 1 < n; i += 2)
    leaf_hash_x2(data + offsets[i], offsets[i + 1] - offsets[i],
                 out + 32 * i, data + offsets[i + 1],
                 offsets[i + 2] - offsets[i + 1], out + 32 * (i + 1));
  if (i < n)
    leaf_hash(data + offsets[i], offsets[i + 1] - offsets[i],
              out + 32 * i);
}

inline void leaf_hash_x2(const uint8_t *a, size_t na, uint8_t *outA,
                         const uint8_t *b, size_t nb, uint8_t *outB) {
#if defined(TM_SHANI)
  if (na <= 54 && nb <= 54 && has_shani()) {
    uint8_t mA[55], mB[55];
    mA[0] = 0x00;
    std::memcpy(mA + 1, a, na);
    mB[0] = 0x00;
    std::memcpy(mB + 1, b, nb);
    sha256_single_block_x2(mA, na + 1, outA, mB, nb + 1, outB);
    return;
  }
#endif
  leaf_hash(a, na, outA);
  leaf_hash(b, nb, outB);
}

inline void fill_node_blocks(const uint8_t *l, const uint8_t *r,
                             uint8_t b1[64], uint8_t b2[64]) {
  // fixed 65-byte message (0x01 || left || right): exactly two blocks,
  // second block is one payload byte + padding + the constant length
  b1[0] = 0x01;
  std::memcpy(b1 + 1, l, 32);
  std::memcpy(b1 + 33, r, 31);
  std::memset(b2, 0, 64);
  b2[0] = r[31];
  b2[1] = 0x80;
  b2[62] = 0x02;  // 520 bits, big-endian
  b2[63] = 0x08;
}

inline void node_hash(const uint8_t *l, const uint8_t *r, uint8_t out[32]) {
  uint8_t b1[64], b2[64];
  fill_node_blocks(l, r, b1, b2);
  uint32_t h[8];
  std::memcpy(h, SHA256_INIT, sizeof(h));
  sha256_compress_dispatch(h, b1);
  sha256_compress_dispatch(h, b2);
  sha256_state_out(h, out);
}

// two independent inner nodes through the interleaved pass
inline void node_hash_x2(const uint8_t *l1, const uint8_t *r1,
                         uint8_t *out1, const uint8_t *l2,
                         const uint8_t *r2, uint8_t *out2) {
#if defined(TM_SHANI)
  if (has_shani()) {
    uint8_t a1[64], a2[64], b1[64], b2[64];
    fill_node_blocks(l1, r1, a1, a2);
    fill_node_blocks(l2, r2, b1, b2);
    uint32_t hA[8], hB[8];
    std::memcpy(hA, SHA256_INIT, sizeof(hA));
    std::memcpy(hB, SHA256_INIT, sizeof(hB));
    compress_shani_x2(hA, a1, hB, b1);
    compress_shani_x2(hA, a2, hB, b2);
    sha256_state_out(hA, out1);
    sha256_state_out(hB, out2);
    return;
  }
#endif
  node_hash(l1, r1, out1);
  node_hash(l2, r2, out2);
}

// one tree level over a contiguous digest row: dst[i] = node(src[2i],
// src[2i+1]), nodes interleaved pairwise. src/dst may alias (in-place
// halving writes dst[i] at or before src[2i]).
inline void level_hash_row(const uint8_t *src, size_t n_pairs,
                           uint8_t *dst) {
  size_t i = 0;
  for (; i + 1 < n_pairs; i += 2)
    node_hash_x2(src + 64 * i, src + 64 * i + 32, dst + 32 * i,
                 src + 64 * (i + 1), src + 64 * (i + 1) + 32,
                 dst + 32 * (i + 1));
  if (i < n_pairs)
    node_hash(src + 64 * i, src + 64 * i + 32, dst + 32 * i);
}

inline void final_hash(uint64_t n, const uint8_t *tree_root,
                       uint8_t out[32]) {
  uint8_t msg[41];
  msg[0] = 0x02;
  for (int i = 0; i < 8; i++) msg[1 + i] = uint8_t(n >> (8 * i));  // LE
  std::memcpy(msg + 9, tree_root, 32);
  sha256_single_block(msg, 41, out);
}

size_t padded_size(size_t n) {
  size_t m = 1;
  while (m < n) m *= 2;
  return m;
}

// Digest chain of pure-zero subtrees: z[0] = 32 zero bytes (the padding
// digest), z[l+1] = node(z[l], z[l]). Trees pad the leaf count to a
// power of two with zero digests, so every node whose subtree is all
// padding equals z[level] — computed once here instead of per tree
// (a 5,000-leaf tree pads to 8,192: 3,191 of its 8,191 inner nodes
// were pure-padding rehashes of the same few values).
const uint8_t *zero_chain() {
  static uint8_t z[64 * 32] = {0};  // magic static: thread-safe init
  static bool init = [] {
    for (int l = 0; l + 1 < 64; l++)
      node_hash(z + 32 * l, z + 32 * l, z + 32 * (l + 1));
    return true;
  }();
  (void)init;
  return z;
}

void root_from_digests(std::vector<uint8_t> &level, size_t n_real,
                       uint8_t out[32]) {
  // level holds padded digests contiguously (k * 32 bytes, k power of 2)
  size_t k = level.size() / 32;
  const uint8_t *zc = zero_chain();
  size_t r = n_real ? n_real : 1;  // live prefix at the current depth
  size_t depth = 0;
  while (k > 1) {
    size_t r2 = (r + 1) / 2;  // nodes with at least one live child
    level_hash_row(level.data(), r / 2, level.data());
    if (r & 1)  // odd tail pairs with a pure-zero sibling
      node_hash(&level[32 * (r - 1)], zc + 32 * depth,
                &level[32 * (r2 - 1)]);
    depth++;
    k /= 2;
    if (r2 < k)  // the live prefix's right neighbour is the zero node
      std::memcpy(&level[32 * r2], zc + 32 * depth, 32);
    r = r2;
  }
  final_hash(n_real, level.data(), out);
}

}  // namespace


// --------------------------------------------------------------------------
// C ABI
// --------------------------------------------------------------------------

extern "C" {

// Batched SHA-256: items concatenated in `data`, bounds in offsets[n+1].
void tm_sha256_batch(const uint8_t *data, const uint64_t *offsets,
                     uint64_t n, uint8_t *out /* n*32 */) {
  for (uint64_t i = 0; i < n; i++)
    sha256_one(data + offsets[i], offsets[i + 1] - offsets[i],
               out + 32 * i);
}

// Merkle root over raw items (ops/merkle.py root_host).
void tm_merkle_root(const uint8_t *data, const uint64_t *offsets,
                    uint64_t n, uint8_t *out /* 32 */) {
  if (n == 0) {
    uint8_t zero[32] = {0};
    final_hash(0, zero, out);
    return;
  }
  size_t m = padded_size(n);
  std::vector<uint8_t> level(m * 32, 0);
  leaf_hash_row(data, offsets, n, level.data());
  root_from_digests(level, n, out);
}

// Merkle root over precomputed 32-byte leaf digests.
void tm_merkle_root_from_digests(const uint8_t *digests, uint64_t n,
                                 uint8_t *out /* 32 */) {
  if (n == 0) {
    uint8_t zero[32] = {0};
    final_hash(0, zero, out);
    return;
  }
  size_t m = padded_size(n);
  std::vector<uint8_t> level(m * 32, 0);
  std::memcpy(level.data(), digests, size_t(n) * 32);
  root_from_digests(level, n, out);
}

// Shared tree build: levels[l] holds the LIVE prefix of depth-l nodes
// (nodes with at least one non-padding descendant); everything to their
// right is the zero-chain node z[l]. Returns the tree depth.
static uint64_t build_tree(std::vector<std::vector<uint8_t>> &levels,
                           std::vector<size_t> &live, const uint8_t *data,
                           const uint64_t *offsets, uint64_t n) {
  size_t m = padded_size(n);
  uint64_t depth = 0;
  while ((size_t(1) << depth) < m) depth++;
  levels.resize(depth + 1);
  live.resize(depth + 1);
  levels[0].resize(size_t(n) * 32);
  leaf_hash_row(data, offsets, n, levels[0].data());
  live[0] = n;
  const uint8_t *zc = zero_chain();
  for (uint64_t l = 0; l < depth; l++) {
    size_t r = live[l], r2 = (r + 1) / 2;
    levels[l + 1].resize(r2 * 32);
    level_hash_row(levels[l].data(), r / 2, levels[l + 1].data());
    if (r & 1)
      node_hash(&levels[l][32 * (r - 1)], zc + 32 * l,
                &levels[l + 1][32 * (r2 - 1)]);
    live[l + 1] = r2;
  }
  return depth;
}

static void extract_aunts(const std::vector<std::vector<uint8_t>> &levels,
                          const std::vector<size_t> &live, uint64_t depth,
                          uint64_t index, uint8_t *out /* depth*32 */) {
  const uint8_t *zc = zero_chain();
  size_t idx = index;
  for (uint64_t l = 0; l < depth; l++) {
    size_t sib = idx ^ 1;
    if (sib < live[l])
      std::memcpy(out + 32 * l, &levels[l][32 * sib], 32);
    else
      std::memcpy(out + 32 * l, zc + 32 * l, 32);
    idx /= 2;
  }
}

// Merkle proof (aunts leaf-up) for item `index`; out_aunts has
// log2(padded(n)) * 32 bytes; returns the depth.
uint64_t tm_merkle_proof(const uint8_t *data, const uint64_t *offsets,
                         uint64_t n, uint64_t index, uint8_t *out_root,
                         uint8_t *out_aunts) {
  if (n == 0) {
    uint8_t zero[32] = {0};
    final_hash(0, zero, out_root);
    return 0;
  }
  std::vector<std::vector<uint8_t>> levels;
  std::vector<size_t> live;
  uint64_t depth = build_tree(levels, live, data, offsets, n);
  extract_aunts(levels, live, depth, index, out_aunts);
  final_hash(n, levels[depth].data(), out_root);
  return depth;
}

// Root + EVERY item's proof from ONE tree build (the part-set
// constructor needs all of them; rebuilding the tree per part was the
// dominant cost of part-set assembly). out_aunts: n * depth * 32.
uint64_t tm_merkle_tree_proofs(const uint8_t *data,
                               const uint64_t *offsets, uint64_t n,
                               uint8_t *out_root, uint8_t *out_aunts) {
  if (n == 0) {
    uint8_t zero[32] = {0};
    final_hash(0, zero, out_root);
    return 0;
  }
  std::vector<std::vector<uint8_t>> levels;
  std::vector<size_t> live;
  uint64_t depth = build_tree(levels, live, data, offsets, n);
  for (uint64_t i = 0; i < n; i++)
    extract_aunts(levels, live, depth, i, out_aunts + i * depth * 32);
  final_hash(n, levels[depth].data(), out_root);
  return depth;
}

// Burst part-set build (types/part_set.py PartSet.from_data): split
// `data` (len bytes) into ceil(len/part_size) parts — ONE empty part
// when len == 0, matching the Python `or [b""]` — then leaf-hash every
// part and build the Merkle tree plus every part's proof in one call.
// The Python path sliced chunks, packed a ctypes offset array and made
// a separate tree call; here the proposer hands over the serialized
// block once and gets the whole part-set skeleton back. out_aunts:
// n_parts * depth * 32 bytes (n_parts and depth are fully determined
// by len and part_size, so the caller allocates exactly). Returns the
// tree depth.
uint64_t tm_partset_build(const uint8_t *data, uint64_t len,
                          uint64_t part_size, uint8_t *out_root,
                          uint8_t *out_aunts) {
  uint64_t n = part_size ? (len + part_size - 1) / part_size : 0;
  if (n == 0) n = 1;  // empty data still yields one empty part
  std::vector<uint64_t> offsets(n + 1);
  for (uint64_t i = 0; i <= n; i++) {
    uint64_t off = i * part_size;
    offsets[i] = off < len ? off : len;
  }
  std::vector<std::vector<uint8_t>> levels;
  std::vector<size_t> live;
  uint64_t depth = build_tree(levels, live, data, offsets.data(), n);
  for (uint64_t i = 0; i < n; i++)
    extract_aunts(levels, live, depth, i, out_aunts + i * depth * 32);
  final_hash(n, levels[depth].data(), out_root);
  return depth;
}

// 1 when SHA-256 compresses with SHA-NI in this build on this CPU, else 0.
int tm_sha256_shani() {
#if defined(TM_SHANI)
  return has_shani() ? 1 : 0;
#else
  return 0;
#endif
}

// Non-blocking writes of bufs[i][0, lens[i]) to socket fds[i], i < n, in
// one call (rpc/aserver.py: a loop tick's writes, the interpreter lock
// released once for all of them). sent[i] = the bytes written, which
// stop short where the socket's buffer is full, or -errno on an error
// other than EAGAIN / EINTR.
void tm_sendmany(int n, const int *fds, const char *const *bufs,
                 const uint64_t *lens, int64_t *sent) {
  for (int i = 0; i < n; i++) {
    uint64_t off = 0;
    int64_t err = 0;
    while (off < lens[i]) {
      ssize_t k = send(fds[i], bufs[i] + off, lens[i] - off,
                       MSG_DONTWAIT | MSG_NOSIGNAL);
      if (k > 0) {
        off += (uint64_t)k;
      } else if (k < 0 && errno == EINTR) {
        continue;
      } else {
        if (k < 0 && errno != EAGAIN && errno != EWOULDBLOCK) err = -errno;
        break;
      }
    }
    sent[i] = err ? err : (int64_t)off;
  }
}

}  // extern "C"
