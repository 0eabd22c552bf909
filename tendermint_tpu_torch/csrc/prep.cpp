// Batched Ed25519 host prep and signing phases: a CPython extension
// (module _tmtorch_prep) for tendermint_tpu_torch.
//
// prep_items takes the verifier's items list [(pubkey, msg, signature),
// ...] and produces the four device-bound arrays (pk[n,32], R[n,32],
// s[n,32], h[n,32]) plus the precheck mask in ONE call: classification,
// length checks, the s < L malleability check, h = SHA512(R||A||M) mod L.
// sign_phase1 and sign_phase2 are the host halves of batched RFC 8032
// signing around the r*B kernel: the nonces r = SHA512(prefix||M) mod L,
// then s = (r + SHA512(R||A||M) * a) mod L.
//
// Every hash loop runs with the GIL RELEASED over private copies of the
// inputs (pass 1 copies under the GIL, pass 2 hashes without it), so
// threads that resolve other batches overlap with it. SHA-512 is
// OpenSSL's one-shot SHA512() when libcrypto.so.3 loads at run time, the
// portable Sha512 of ed25519_host.h otherwise (`sha512_impl` says which).
//
// prep_items returns None for inputs the fast path does not cover --
// secp256k1 keys (33-byte SEC1, verified on the host), non-bytes members,
// items that are not 3-sequences -- and the caller then takes its general
// path, so this extension changes no verdict, only speed.
//
// The same library exports tm_ed25519_prepare (ed25519_host.h) with a
// plain C ABI for ctypes.
//
//   g++ -O3 -shared -fPIC -std=c++17 -I<python include> -o <lib>.so prep.cpp

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <dlfcn.h>

#include "ed25519_host.h"

namespace {

typedef unsigned char *(*sha512_oneshot_fn)(const unsigned char *, size_t,
                                            unsigned char *);
sha512_oneshot_fn ossl_sha512 = nullptr;

inline void sha512_ram(const uint8_t *r, const uint8_t *a,
                       const uint8_t *m, size_t mlen, uint8_t out[64]) {
    // SHA512(r32 || a32 || M); a may be null (32-byte-prefix inputs —
    // the signing nonce hash SHA512(prefix || M))
    size_t head = (a != nullptr) ? 64 : 32;
    if (ossl_sha512 != nullptr) {
        // one-shot wants contiguous input; the head is 32/64 bytes,
        // messages are vote/header sign-bytes (~100-300B), so a stack
        // scratch covers the common case without an allocation
        uint8_t scratch[512];
        if (head + mlen <= sizeof scratch) {
            std::memcpy(scratch, r, 32);
            if (a != nullptr) std::memcpy(scratch + 32, a, 32);
            std::memcpy(scratch + head, m, mlen);
            ossl_sha512(scratch, head + mlen, out);
            return;
        }
        std::vector<uint8_t> big(head + mlen);
        std::memcpy(big.data(), r, 32);
        if (a != nullptr) std::memcpy(big.data() + 32, a, 32);
        std::memcpy(big.data() + head, m, mlen);
        ossl_sha512(big.data(), big.size(), out);
        return;
    }
    Sha512 s;
    s.update(r, 32);
    if (a != nullptr) s.update(a, 32);
    s.update(m, mlen);
    s.final(out);
}

}  // namespace

static PyObject *prep_items(PyObject *self, PyObject *arg) {
    PyObject *seq = PySequence_Fast(arg, "prep_items expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);

    PyObject *pk_b = PyBytes_FromStringAndSize(nullptr, n * 32);
    PyObject *rb_b = PyBytes_FromStringAndSize(nullptr, n * 32);
    PyObject *s_b = PyBytes_FromStringAndSize(nullptr, n * 32);
    PyObject *h_b = PyBytes_FromStringAndSize(nullptr, n * 32);
    PyObject *pre_b = PyBytes_FromStringAndSize(nullptr, n);
    if (!pk_b || !rb_b || !s_b || !h_b || !pre_b) {
        Py_XDECREF(pk_b); Py_XDECREF(rb_b); Py_XDECREF(s_b);
        Py_XDECREF(h_b); Py_XDECREF(pre_b); Py_DECREF(seq);
        return nullptr;
    }
    uint8_t *pk = (uint8_t *)PyBytes_AS_STRING(pk_b);
    uint8_t *rb = (uint8_t *)PyBytes_AS_STRING(rb_b);
    uint8_t *sb = (uint8_t *)PyBytes_AS_STRING(s_b);
    uint8_t *hb = (uint8_t *)PyBytes_AS_STRING(h_b);
    uint8_t *pre = (uint8_t *)PyBytes_AS_STRING(pre_b);
    std::memset(pk, 0, (size_t)n * 32);
    std::memset(rb, 0, (size_t)n * 32);
    std::memset(sb, 0, (size_t)n * 32);
    std::memset(hb, 0, (size_t)n * 32);
    std::memset(pre, 0, (size_t)n);

    // Pass 1 (GIL held): copy messages into a private arena and pk/R/s
    // into the output buffers. Copies make the hash loop independent of
    // object lifetimes, so the GIL can drop for pass 2.
    std::vector<uint8_t> arena;
    arena.reserve((size_t)n * 160);
    std::vector<uint64_t> moff((size_t)n + 1, 0);
    bool fallback = false;
    for (Py_ssize_t i = 0; i < n && !fallback; i++) {
        PyObject *it = PySequence_Fast_GET_ITEM(seq, i);
        PyObject *fast =
            PySequence_Fast(it, "prep_items items must be sequences");
        if (fast == nullptr) {
            PyErr_Clear();
            fallback = true;
            break;
        }
        if (PySequence_Fast_GET_SIZE(fast) != 3) {
            Py_DECREF(fast);
            fallback = true;
            break;
        }
        PyObject *po = PySequence_Fast_GET_ITEM(fast, 0);
        PyObject *mo = PySequence_Fast_GET_ITEM(fast, 1);
        PyObject *so = PySequence_Fast_GET_ITEM(fast, 2);
        if (!PyBytes_Check(po) || !PyBytes_Check(mo) || !PyBytes_Check(so)) {
            Py_DECREF(fast);
            fallback = true;  // memoryview/bytearray etc: general path
            break;
        }
        Py_ssize_t plen = PyBytes_GET_SIZE(po);
        const uint8_t *pp = (const uint8_t *)PyBytes_AS_STRING(po);
        if (plen == 33 && (pp[0] == 2 || pp[0] == 3)) {
            Py_DECREF(fast);
            fallback = true;  // secp256k1: host-routed, general path
            break;
        }
        Py_ssize_t slen = PyBytes_GET_SIZE(so);
        moff[i + 1] = moff[i];
        if (plen != 32 || slen != 64) {
            Py_DECREF(fast);
            continue;  // pre stays 0, buffers stay zeroed
        }
        const uint8_t *sp = (const uint8_t *)PyBytes_AS_STRING(so);
        if (!scalar_below_l(sp + 32)) {
            Py_DECREF(fast);
            continue;
        }
        std::memcpy(pk + 32 * i, pp, 32);
        std::memcpy(rb + 32 * i, sp, 32);
        std::memcpy(sb + 32 * i, sp + 32, 32);
        Py_ssize_t mlen = PyBytes_GET_SIZE(mo);
        const uint8_t *mp = (const uint8_t *)PyBytes_AS_STRING(mo);
        arena.insert(arena.end(), mp, mp + mlen);
        moff[i + 1] = moff[i] + (uint64_t)mlen;
        pre[i] = 1;
        Py_DECREF(fast);
    }
    Py_DECREF(seq);
    if (fallback) {
        Py_DECREF(pk_b); Py_DECREF(rb_b); Py_DECREF(s_b);
        Py_DECREF(h_b); Py_DECREF(pre_b);
        Py_RETURN_NONE;
    }

    // Pass 2 (GIL released): h = SHA512(R || A || M) mod L
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < n; i++) {
        if (!pre[i]) continue;
        uint8_t digest[64];
        sha512_ram(rb + 32 * i, pk + 32 * i, arena.data() + moff[i],
                   (size_t)(moff[i + 1] - moff[i]), digest);
        reduce512_mod_l(digest, hb + 32 * i);
    }
    Py_END_ALLOW_THREADS

    PyObject *out = PyTuple_Pack(5, pk_b, rb_b, s_b, h_b, pre_b);
    Py_DECREF(pk_b); Py_DECREF(rb_b); Py_DECREF(s_b);
    Py_DECREF(h_b); Py_DECREF(pre_b);
    return out;
}

namespace {

// s = (r + k*a) mod L. r and k are < L; a is the CLAMPED secret
// scalar (bit 254 set, so a >= 2^254 > L — not reduced). The product
// goes through the general 512-bit reduction, which needs no bound
// beyond < 2^512; only the final r + (k*a mod L) sum relies on < L.
inline void muladd_mod_l(const uint8_t r[32], const uint8_t k[32],
                         const uint8_t a[32], uint8_t out[32]) {
    uint64_t kl[4], al[4];
    for (int i = 0; i < 4; i++) {
        uint64_t kw = 0, aw = 0;
        for (int j = 7; j >= 0; j--) {
            kw = (kw << 8) | k[8 * i + j];
            aw = (aw << 8) | a[8 * i + j];
        }
        kl[i] = kw;
        al[i] = aw;
    }
    // 4x4 schoolbook -> 8 limbs
    uint64_t prod[8] = {0};
    for (int i = 0; i < 4; i++) {
        unsigned __int128 carry = 0;
        for (int j = 0; j < 4; j++) {
            carry += (unsigned __int128)kl[i] * al[j] + prod[i + j];
            prod[i + j] = (uint64_t)carry;
            carry >>= 64;
        }
        prod[i + 4] = (uint64_t)carry;
    }
    uint8_t prod_le[64];
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
            prod_le[8 * i + j] = uint8_t(prod[i] >> (8 * j));
    uint8_t ka[32];
    reduce512_mod_l(prod_le, ka);
    // out = r + ka, minus L if the sum reaches it (both inputs < L)
    unsigned carry = 0;
    for (int i = 0; i < 32; i++) {
        unsigned t = (unsigned)r[i] + ka[i] + carry;
        out[i] = uint8_t(t);
        carry = t >> 8;
    }
    if (carry || !scalar_below_l(out)) {
        uint8_t l_bytes[32];
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 8; j++)
                l_bytes[8 * i + j] = uint8_t(L_LIMBS[i] >> (8 * j));
        unsigned borrow = 0;
        for (int i = 0; i < 32; i++) {
            int t = (int)out[i] - l_bytes[i] - (int)borrow;
            out[i] = uint8_t(t & 0xFF);
            borrow = t < 0;
        }
    }
}

}  // namespace

// sign_phase1(prefixes n*32, msgs) -> r bytes n*32:
// r = SHA512(prefix || M) mod L (RFC 8032 nonce). GIL released.
static PyObject *sign_phase1(PyObject *, PyObject *args) {
    const char *pre;
    Py_ssize_t pre_len;
    PyObject *msgs;
    if (!PyArg_ParseTuple(args, "y#O", &pre, &pre_len, &msgs))
        return nullptr;
    PyObject *seq = PySequence_Fast(msgs, "sign_phase1 expects msgs");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    if (pre_len != 32 * n) {
        Py_DECREF(seq);
        PyErr_SetString(PyExc_ValueError, "prefixes must be n*32 bytes");
        return nullptr;
    }
    // the y# blob pointers borrow from immutable bytes held by the
    // call's argument tuple — valid for the whole call, GIL or not;
    // only the msgs (many objects) need aggregating into an arena
    std::vector<uint8_t> arena;
    std::vector<uint64_t> off((size_t)n + 1, 0);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *m = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyBytes_Check(m)) {
            Py_DECREF(seq);
            PyErr_SetString(PyExc_TypeError, "msgs must be bytes");
            return nullptr;
        }
        const uint8_t *p = (const uint8_t *)PyBytes_AS_STRING(m);
        arena.insert(arena.end(), p, p + PyBytes_GET_SIZE(m));
        off[i + 1] = off[i] + (uint64_t)PyBytes_GET_SIZE(m);
    }
    Py_DECREF(seq);
    PyObject *out_b = PyBytes_FromStringAndSize(nullptr, n * 32);
    if (out_b == nullptr) return nullptr;
    uint8_t *out = (uint8_t *)PyBytes_AS_STRING(out_b);
    const uint8_t *prefixes = (const uint8_t *)pre;
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < n; i++) {
        uint8_t digest[64];
        sha512_ram(prefixes + 32 * i, nullptr,
                   arena.data() + off[i], (size_t)(off[i + 1] - off[i]),
                   digest);
        reduce512_mod_l(digest, out + 32 * i);
    }
    Py_END_ALLOW_THREADS
    return out_b;
}

// sign_phase2(renc n*32, pks n*32, msgs, r n*32, a n*32) -> sigs n*64:
// k = SHA512(Renc || A || M) mod L; s = (r + k*a) mod L; sig = Renc||s.
static PyObject *sign_phase2(PyObject *, PyObject *args) {
    const char *renc, *pks, *rs, *as_;
    Py_ssize_t renc_len, pks_len, rs_len, as_len;
    PyObject *msgs;
    if (!PyArg_ParseTuple(args, "y#y#Oy#y#", &renc, &renc_len, &pks,
                          &pks_len, &msgs, &rs, &rs_len, &as_, &as_len))
        return nullptr;
    PyObject *seq = PySequence_Fast(msgs, "sign_phase2 expects msgs");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    if (renc_len != 32 * n || pks_len != 32 * n || rs_len != 32 * n ||
        as_len != 32 * n) {
        Py_DECREF(seq);
        PyErr_SetString(PyExc_ValueError, "scalar blobs must be n*32");
        return nullptr;
    }
    std::vector<uint8_t> arena;
    std::vector<uint64_t> off((size_t)n + 1, 0);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *m = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyBytes_Check(m)) {
            Py_DECREF(seq);
            PyErr_SetString(PyExc_TypeError, "msgs must be bytes");
            return nullptr;
        }
        const uint8_t *p = (const uint8_t *)PyBytes_AS_STRING(m);
        arena.insert(arena.end(), p, p + PyBytes_GET_SIZE(m));
        off[i + 1] = off[i] + (uint64_t)PyBytes_GET_SIZE(m);
    }
    Py_DECREF(seq);
    // borrowed blob pointers (see sign_phase1) — no defensive copies
    const uint8_t *rc = (const uint8_t *)renc;
    const uint8_t *pc = (const uint8_t *)pks;
    const uint8_t *rv = (const uint8_t *)rs;
    const uint8_t *av = (const uint8_t *)as_;
    PyObject *out_b = PyBytes_FromStringAndSize(nullptr, n * 64);
    if (out_b == nullptr) return nullptr;
    uint8_t *out = (uint8_t *)PyBytes_AS_STRING(out_b);
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < n; i++) {
        uint8_t digest[64], k[32];
        sha512_ram(rc + 32 * i, pc + 32 * i,
                   arena.data() + off[i], (size_t)(off[i + 1] - off[i]),
                   digest);
        reduce512_mod_l(digest, k);
        std::memcpy(out + 64 * i, rc + 32 * i, 32);
        muladd_mod_l(rv + 32 * i, k, av + 32 * i, out + 64 * i + 32);
    }
    Py_END_ALLOW_THREADS
    return out_b;
}

static PyMethodDef prep_methods[] = {
    {"sign_phase1", sign_phase1, METH_VARARGS,
     "(prefixes n*32, msgs) -> r scalars n*32 (RFC 8032 nonces mod L)"},
    {"sign_phase2", sign_phase2, METH_VARARGS,
     "(renc n*32, pks n*32, msgs, r n*32, a n*32) -> signatures n*64"},
    {"prep_items", prep_items, METH_O,
     "items [(pk, msg, sig), ...] -> (pk, R, s, h, pre) byte buffers, "
     "or None when the batch needs the general Python path."},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef prep_moduledef = {
    PyModuleDef_HEAD_INIT, "_tmtorch_prep",
    "Native batched Ed25519 verify prep and signing phases for "
    "tendermint_tpu_torch", -1,
    prep_methods,
};

PyMODINIT_FUNC PyInit__tmtorch_prep(void) {
    void *crypto = dlopen("libcrypto.so.3", RTLD_LAZY | RTLD_LOCAL);
    if (crypto != nullptr)
        ossl_sha512 = (sha512_oneshot_fn)dlsym(crypto, "SHA512");
    PyObject *m = PyModule_Create(&prep_moduledef);
    if (m != nullptr)
        PyModule_AddStringConstant(
            m, "sha512_impl", ossl_sha512 ? "openssl" : "portable");
    return m;
}
