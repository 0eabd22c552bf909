// Native KVStore core, a CPython extension: the port's copy of
// tendermint_tpu/native/kvcore.cpp.
//
// The C++ half of abci/apps/kvstore.py: the plain "key=value" DeliverTx
// path, the CRC32-bucketed additive-accumulator app hash, and the
// bucket-Merkle commit, one call a block.
//
// Semantics are pinned BY the Python app (kvstore.py deliver_tx/commit):
// the two routes give byte-equal app hashes and store contents
// (tests/test_torch_kvcore.py); val: txs and empty txs make
// deliver_batch return the index they occur at, so that the wrapper
// takes the per-tx Python route for that whole block. Validator
// bookkeeping never lives here.
//
// Accumulator spec (must match kvstore.py commit()):
//   bucket(k)   = crc32(k) & 255
//   pair(k,v)   = sha256(le32(len k) || k || le32(len v) || v)
//   acc[b]      = sum of pair digests as little-endian ints mod 2^256
//   digest(b)   = sha256(0x00 || le256(acc[b]) || le64(count[b]))
//                 (empty bucket: sha256(0x00))
//   app_hash    = merkle root over the 256 bucket digests
//                 (b"\x00"*32 when the store is empty)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <array>
#include <string>
#include <string_view>
#include <mutex>
#include <vector>

#include "hostops.cpp"

namespace {

constexpr int KV_BUCKETS = 256;

// CRC-32 (zlib/IEEE 802.3 polynomial, reflected) — slice-by-4 tables
// built at init (keys are hashed once per tx; the bytewise loop's
// serial table-lookup chain showed in the deliver profile).
uint32_t crc_table[4][256];

void crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int j = 0; j < 8; j++)
            c = (c & 1) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
        crc_table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
        for (int t = 1; t < 4; t++)
            crc_table[t][i] = crc_table[0][crc_table[t - 1][i] & 0xFF] ^
                              (crc_table[t - 1][i] >> 8);
}

inline uint32_t crc32_of(const uint8_t *p, size_t n) {
    uint32_t c = 0xFFFFFFFFu;
    while (n >= 4) {
        uint32_t w;
        std::memcpy(&w, p, 4);
        c ^= w;
        c = crc_table[3][c & 0xFF] ^ crc_table[2][(c >> 8) & 0xFF] ^
            crc_table[1][(c >> 16) & 0xFF] ^ crc_table[0][c >> 24];
        p += 4;
        n -= 4;
    }
    for (size_t i = 0; i < n; i++)
        c = crc_table[0][(c ^ p[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

struct Acc256 {
    uint64_t v[4] = {0, 0, 0, 0};

    void add_le(const uint8_t d[32]) {
        unsigned __int128 carry = 0;
        for (int i = 0; i < 4; i++) {
            uint64_t w = 0;
            for (int j = 7; j >= 0; j--) w = (w << 8) | d[8 * i + j];
            carry += (unsigned __int128)v[i] + w;
            v[i] = (uint64_t)carry;
            carry >>= 64;
        }  // mod 2^256: carry out drops
    }

    void sub_le(const uint8_t d[32]) {
        unsigned __int128 borrow = 0;
        for (int i = 0; i < 4; i++) {
            uint64_t w = 0;
            for (int j = 7; j >= 0; j--) w = (w << 8) | d[8 * i + j];
            unsigned __int128 sub = (unsigned __int128)w + borrow;
            uint64_t lo = (uint64_t)sub;
            borrow = sub >> 64;
            if (v[i] < lo) borrow++;
            v[i] -= lo;
        }  // mod 2^256: borrow out drops
    }

    void to_le(uint8_t out[32]) const {
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 8; j++)
                out[8 * i + j] = uint8_t(v[i] >> (8 * j));
    }
};

inline void pair_digest(std::string_view k, std::string_view v,
                        uint8_t out[32]) {
    uint32_t kl = (uint32_t)k.size(), vl = (uint32_t)v.size();
    size_t total = 8 + k.size() + v.size();
    if (total <= 55) {  // typical kv tx: one padded block, one compress
        uint8_t msg[55];
        for (int i = 0; i < 4; i++) msg[i] = uint8_t(kl >> (8 * i));
        std::memcpy(msg + 4, k.data(), k.size());
        uint8_t *p = msg + 4 + k.size();
        for (int i = 0; i < 4; i++) p[i] = uint8_t(vl >> (8 * i));
        std::memcpy(p + 4, v.data(), v.size());
        sha256_single_block(msg, total, out);
        return;
    }
    Sha256 s;
    uint8_t len[4];
    for (int i = 0; i < 4; i++) len[i] = uint8_t(kl >> (8 * i));
    s.update(len, 4);
    s.update((const uint8_t *)k.data(), k.size());
    for (int i = 0; i < 4; i++) len[i] = uint8_t(vl >> (8 * i));
    s.update(len, 4);
    s.update((const uint8_t *)v.data(), v.size());
    s.final(out);
}


// Flat open-addressing store. The fast-sync workload holds millions of
// keys (key_space x txs/block), where a node-based unordered_map pays
// 2-3 cache misses + an allocation per operation. Here: one 64-byte
// entry per key (value SSO + digest + key ref inline), keys appended to
// an arena, and a 16-byte inline key prefix that decides nearly every
// probe without touching the arena. FNV-1a hash; capacity doubles at
// 0.75 load (tombstone-free: the kv app never deletes).
struct KVEntry {
    uint64_t kpre[2];    // first 16 key bytes, zero-padded
    uint64_t koff;       // key bytes in the arena (64-bit: cumulative
                         // key bytes can pass 4 GiB on long chains)
    uint32_t klen;
    std::string value;
    std::array<uint8_t, 32> digest;  // cached pair digest
};

inline uint64_t fnv1a(const uint8_t *p, size_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (size_t i = 0; i < n; i++) {
        h ^= p[i];
        h *= 1099511628211ULL;
    }
    return h;
}

struct FlatStore {
    std::vector<int32_t> slots;   // entry index + 1, 0 = empty
    std::vector<KVEntry> entries;
    std::string arena;            // append-only key bytes
    size_t mask = 0;

    FlatStore() { slots.assign(1 << 16, 0); mask = (1 << 16) - 1; }

    static void key_prefix(std::string_view k, uint64_t out[2]) {
        uint8_t buf[16] = {0};
        size_t n = k.size() < 16 ? k.size() : 16;
        std::memcpy(buf, k.data(), n);
        std::memcpy(&out[0], buf, 8);
        std::memcpy(&out[1], buf + 8, 8);
    }

    size_t size() const { return entries.size(); }

    std::string_view key_of(const KVEntry &e) const {
        return std::string_view(arena.data() + e.koff, e.klen);
    }

    void grow() {
        size_t cap = (mask + 1) * 2;
        std::vector<int32_t> ns(cap, 0);
        size_t nm = cap - 1;
        for (size_t i = 0; i < entries.size(); i++) {
            const KVEntry &e = entries[i];
            size_t pos = fnv1a((const uint8_t *)arena.data() + e.koff,
                               e.klen) & nm;
            while (ns[pos]) pos = (pos + 1) & nm;
            ns[pos] = int32_t(i) + 1;
        }
        slots.swap(ns);
        mask = nm;
    }

    // returns the entry for k, or nullptr + the insert slot position
    KVEntry *find(std::string_view k, uint64_t pre[2], size_t *pos_out) {
        return find_hashed(k, fnv1a((const uint8_t *)k.data(), k.size()),
                           pre, pos_out);
    }

    KVEntry *find_hashed(std::string_view k, uint64_t h, uint64_t pre[2],
                         size_t *pos_out) {
        key_prefix(k, pre);
        size_t pos = h & mask;
        for (;;) {
            int32_t s = slots[pos];
            if (s == 0) {
                *pos_out = pos;
                return nullptr;
            }
            KVEntry &e = entries[size_t(s) - 1];
            if (e.kpre[0] == pre[0] && e.kpre[1] == pre[1] &&
                e.klen == k.size() &&
                (k.size() <= 16 ||
                 std::memcmp(arena.data() + e.koff + 16, k.data() + 16,
                             k.size() - 16) == 0))
                return &e;
            pos = (pos + 1) & mask;
        }
    }

    KVEntry *insert_at(size_t pos, std::string_view k,
                       const uint64_t pre[2]) {
        if ((entries.size() + 1) * 4 > (mask + 1) * 3) {
            grow();
            // re-probe in the grown table
            pos = fnv1a((const uint8_t *)k.data(), k.size()) & mask;
            while (slots[pos]) pos = (pos + 1) & mask;
        }
        KVEntry e;
        e.kpre[0] = pre[0];
        e.kpre[1] = pre[1];
        e.koff = arena.size();
        e.klen = (uint32_t)k.size();
        arena.append(k.data(), k.size());
        entries.push_back(std::move(e));
        slots[pos] = int32_t(entries.size());
        return &entries.back();
    }
};

struct KVCore {
    // guards store/acc/digest state: deliver_batch releases the GIL
    // for its apply loop, so RPC-thread reads (kv_get / kv_commit /
    // kv_items) would otherwise race mid-mutation (slot published
    // before value assigned; grow()/arena realloc under a reader)
    std::mutex mu;
    FlatStore store;
    Acc256 acc[KV_BUCKETS];
    uint64_t count[KV_BUCKETS] = {0};
    uint8_t bucket_digest[KV_BUCKETS * 32];
    bool bucket_dirty[KV_BUCKETS] = {false};

    KVCore() {
        uint8_t empty[32];
        Sha256 s;
        uint8_t z = 0;
        s.update(&z, 1);
        s.final(empty);
        for (int b = 0; b < KV_BUCKETS; b++)
            std::memcpy(bucket_digest + 32 * b, empty, 32);
    }

    // set k=v, updating the bucket accumulator (matches the dirty-key
    // replay in kvstore.py commit(), applied eagerly per key)
    void set(std::string_view k, std::string_view v) {
        set_hashed(k, v, fnv1a((const uint8_t *)k.data(), k.size()));
    }

    void set_hashed(std::string_view k, std::string_view v, uint64_t h) {
        uint8_t d[32];
        pair_digest(k, v, d);
        set_hashed_digest(k, v, h, d);
    }

    void set_hashed_digest(std::string_view k, std::string_view v,
                           uint64_t h, const uint8_t d[32]) {
        int b = crc32_of((const uint8_t *)k.data(), k.size()) &
                (KV_BUCKETS - 1);
        uint64_t pre[2];
        size_t pos;
        KVEntry *e = store.find_hashed(k, h, pre, &pos);
        if (e != nullptr) {
            acc[b].sub_le(e->digest.data());
            e->value.assign(v.data(), v.size());
            std::memcpy(e->digest.data(), d, 32);
        } else {
            count[b]++;
            e = store.insert_at(pos, k, pre);
            e->value.assign(v.data(), v.size());
            std::memcpy(e->digest.data(), d, 32);
        }
        acc[b].add_le(d);
        bucket_dirty[b] = true;
    }

    void refresh_digests() {
        for (int b = 0; b < KV_BUCKETS; b++) {
            if (!bucket_dirty[b]) continue;
            bucket_dirty[b] = false;
            uint8_t *out = bucket_digest + 32 * b;
            if (count[b] == 0) {
                Sha256 s;
                uint8_t z = 0;
                s.update(&z, 1);
                s.final(out);
            } else {
                uint8_t buf[41];
                buf[0] = 0;
                acc[b].to_le(buf + 1);
                for (int i = 0; i < 8; i++)
                    buf[33 + i] = uint8_t(count[b] >> (8 * i));
                Sha256 s;
                s.update(buf, 41);
                s.final(out);
            }
        }
    }
};

void kv_capsule_destroy(PyObject *cap) {
    delete (KVCore *)PyCapsule_GetPointer(cap, "tm_kvcore");
}

KVCore *kv_from(PyObject *cap) {
    return (KVCore *)PyCapsule_GetPointer(cap, "tm_kvcore");
}

}  // namespace

static PyObject *kv_new(PyObject *, PyObject *) {
    return PyCapsule_New(new KVCore(), "tm_kvcore", kv_capsule_destroy);
}

// deliver_batch(core, txs) -> (keys list, packed key blob), or the int
// index of the first tx the native path does not handle (empty /
// "val:" prefixed / non-bytes) — caller replays the WHOLE batch
// through Python, so the native store must not be touched before that
// scan completes. The packed blob is the length-prefixed key
// concatenation UniformDeliverResults persists, built here because
// 5,000 per-key concats in Python cost more than the delivery.
static PyObject *kv_deliver_batch(PyObject *, PyObject *args) {
    PyObject *cap, *txs;
    if (!PyArg_ParseTuple(args, "OO", &cap, &txs)) return nullptr;
    KVCore *core = kv_from(cap);
    if (core == nullptr) return nullptr;
    PyObject *seq = PySequence_Fast(txs, "deliver_batch expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    // pass 1: scan for txs needing the Python path (no mutations yet)
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *t = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyBytes_Check(t) || PyBytes_GET_SIZE(t) == 0 ||
            (PyBytes_GET_SIZE(t) >= 4 &&
             std::memcmp(PyBytes_AS_STRING(t), "val:", 4) == 0)) {
            Py_DECREF(seq);
            return PyLong_FromSsize_t(i);
        }
    }
    // pass 2: parse + build the packed key blob, allocating EVERY
    // Python object before the first core->set — an allocation failure
    // after partial application would leave the native store diverged
    // from what the caller believes was applied (a consensus-visible
    // state fork on replay). Per-key PyBytes are NOT built here: the
    // wrapper's UniformDeliverResults unpacks keys lazily from the
    // blob in the rare per-tx-access paths (events, tx index).
    std::vector<std::pair<std::string_view, std::string_view>> kvs(
        (size_t)n);
    std::string packed;  // length-prefixed key blob for compact persist
    packed.reserve((size_t)n * 16);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *t = PySequence_Fast_GET_ITEM(seq, i);
        const char *p = PyBytes_AS_STRING(t);
        Py_ssize_t len = PyBytes_GET_SIZE(t);
        const char *eq = (const char *)std::memchr(p, '=', len);
        std::string_view k, v;
        if (eq != nullptr) {
            k = std::string_view(p, eq - p);
            v = std::string_view(eq + 1, len - (eq - p) - 1);
        } else {
            k = v = std::string_view(p, len);
        }
        kvs[i] = {k, v};
        uint32_t kl = (uint32_t)k.size();
        char lenb[4];
        for (int j = 0; j < 4; j++) lenb[j] = char(kl >> (8 * j));
        packed.append(lenb, 4);
        packed.append(k.data(), k.size());
    }
    PyObject *packed_b = PyBytes_FromStringAndSize(
        packed.data(), (Py_ssize_t)packed.size());
    PyObject *n_obj = PyLong_FromSsize_t(n);
    PyObject *out = (packed_b && n_obj)
        ? PyTuple_Pack(2, n_obj, packed_b) : nullptr;
    Py_XDECREF(n_obj);
    Py_XDECREF(packed_b);
    if (out == nullptr) {
        Py_DECREF(seq);
        return nullptr;
    }
    // pass 3: apply (no Python allocation from here on; GIL released —
    // the tx views point into the caller-held bytes objects). The
    // store spans hundreds of MB at fast-sync scale, so every probe is
    // a cache miss; hashes are precomputed and the slot word + first
    // candidate entry are prefetched a few txs ahead, which hides most
    // of the miss latency behind the SHA-256 pair digests. Prefetches
    // after a table grow may touch stale positions — harmless, find()
    // re-probes authoritatively.
    Py_BEGIN_ALLOW_THREADS
    {
        std::lock_guard<std::mutex> lock(core->mu);
        std::vector<uint64_t> hashes((size_t)n);
        for (Py_ssize_t i = 0; i < n; i++)
            hashes[i] = fnv1a((const uint8_t *)kvs[i].first.data(),
                              kvs[i].first.size());
        FlatStore &st = core->store;
        for (Py_ssize_t i = 0; i < n; i++) {
            if (i + 8 < n)
                __builtin_prefetch(&st.slots[hashes[i + 8] & st.mask]);
            if (i + 4 < n) {
                int32_t s = st.slots[hashes[i + 4] & st.mask];
                if (s > 0 && size_t(s) <= st.entries.size())
                    __builtin_prefetch(&st.entries[size_t(s) - 1]);
            }
            core->set_hashed(kvs[i].first, kvs[i].second, hashes[i]);
        }
    }
    Py_END_ALLOW_THREADS
    Py_DECREF(seq);
    return out;
}

// set_one(core, key, value): the single-tx Python fallback still must
// keep the native accumulator in sync when mixed batches occur.
static PyObject *kv_set(PyObject *, PyObject *args) {
    PyObject *cap;
    const char *k, *v;
    Py_ssize_t kl, vl;
    if (!PyArg_ParseTuple(args, "Oy#y#", &cap, &k, &kl, &v, &vl))
        return nullptr;
    KVCore *core = kv_from(cap);
    if (core == nullptr) return nullptr;
    {
        std::lock_guard<std::mutex> lock(core->mu);
        core->set(std::string_view(k, (size_t)kl),
                  std::string_view(v, (size_t)vl));
    }
    Py_RETURN_NONE;
}

// commit(core) -> 32-byte app hash (b"\x00"*32 for an empty store)
static PyObject *kv_commit(PyObject *, PyObject *arg) {
    KVCore *core = kv_from(arg);
    if (core == nullptr) return nullptr;
    uint8_t out[32];
    {
        std::lock_guard<std::mutex> lock(core->mu);
        if (core->store.size() == 0)
            return PyBytes_FromStringAndSize(
                "\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0"
                "\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0", 32);
        core->refresh_digests();
        std::vector<uint8_t> level(core->bucket_digest,
                                   core->bucket_digest + KV_BUCKETS * 32);
        root_from_digests(level, KV_BUCKETS, out);
    }
    return PyBytes_FromStringAndSize((const char *)out, 32);
}

static PyObject *kv_get(PyObject *, PyObject *args) {
    PyObject *cap;
    const char *k;
    Py_ssize_t kl;
    if (!PyArg_ParseTuple(args, "Oy#", &cap, &k, &kl)) return nullptr;
    KVCore *core = kv_from(cap);
    if (core == nullptr) return nullptr;
    std::lock_guard<std::mutex> lock(core->mu);
    uint64_t pre[2];
    size_t pos;
    KVEntry *e = core->store.find(std::string_view(k, (size_t)kl), pre,
                                  &pos);
    if (e == nullptr) Py_RETURN_NONE;
    return PyBytes_FromStringAndSize(e->value.data(),
                                     (Py_ssize_t)e->value.size());
}

static PyObject *kv_size(PyObject *, PyObject *arg) {
    KVCore *core = kv_from(arg);
    if (core == nullptr) return nullptr;
    std::lock_guard<std::mutex> lock(core->mu);
    return PyLong_FromSize_t(core->store.size());
}

static PyObject *kv_items(PyObject *, PyObject *arg) {
    KVCore *core = kv_from(arg);
    if (core == nullptr) return nullptr;
    std::lock_guard<std::mutex> lock(core->mu);
    PyObject *out = PyList_New((Py_ssize_t)core->store.size());
    if (out == nullptr) return nullptr;
    Py_ssize_t i = 0;
    for (const KVEntry &e : core->store.entries) {
        std::string_view k = core->store.key_of(e);
        PyObject *pair = Py_BuildValue(
            "(y#y#)", k.data(), (Py_ssize_t)k.size(),
            e.value.data(), (Py_ssize_t)e.value.size());
        if (pair == nullptr) {
            Py_DECREF(out);
            return nullptr;
        }
        PyList_SET_ITEM(out, i++, pair);
    }
    return out;
}

static PyMethodDef kv_methods[] = {
    {"kv_new", kv_new, METH_NOARGS, "new KV core handle"},
    {"deliver_batch", kv_deliver_batch, METH_VARARGS,
     "(core, txs) -> (n, packed), or int index of first non-kv tx"},
    {"set_one", kv_set, METH_VARARGS, "(core, key, value)"},
    {"commit", kv_commit, METH_O, "(core) -> 32-byte app hash"},
    {"get", kv_get, METH_VARARGS, "(core, key) -> value | None"},
    {"size", kv_size, METH_O, "(core) -> number of keys"},
    {"items", kv_items, METH_O, "(core) -> [(key, value), ...]"},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef kv_moduledef = {
    PyModuleDef_HEAD_INIT, "_tmtorch_kv",
    "Native KVStore core for tendermint_tpu", -1, kv_methods,
};

PyMODINIT_FUNC PyInit__tmtorch_kv(void) {
    crc_init();
    return PyModule_Create(&kv_moduledef);
}
