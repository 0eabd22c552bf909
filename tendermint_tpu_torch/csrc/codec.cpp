// Canonical-JSON encoder, a CPython extension: the port's copy of
// tendermint_tpu/native/codec.cpp.
//
// Byte-for-byte equivalent to types/encoding.py _pure_cdumps() (the
// specification: _canon() + json.dumps(sort_keys=True,
// separators=(",",":"), ensure_ascii=False)) for the object shapes the
// node serializes: dict[str]->..., list/tuple, str, int, bytes/bytearray
// (lowercase hex), bool, None, and objects exposing to_obj(). Floats
// raise TypeError exactly like the Python path.
//
// Anything outside that shape (non-str dict keys, surrogates, ...) raises
// the module's Fallback exception, and types/encoding.cdumps re-encodes
// it through the specification path and counts it, so the C path never
// produces other bytes than the specification.
//
// Built with g++ by tendermint_tpu_torch/native.py against the running
// interpreter's Python.h.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <string>
#include <vector>

static PyObject *FallbackError;  // wrapper catches this and uses pure path

static const char HEX[] = "0123456789abcdef";

static bool encode_obj(PyObject *obj, std::string &out, int depth);

static void append_escaped(const char *s, Py_ssize_t n, std::string &out) {
    out.push_back('"');
    for (Py_ssize_t i = 0; i < n; i++) {
        unsigned char c = (unsigned char)s[i];
        switch (c) {
            case '"': out += "\\\""; break;
            case '\\': out += "\\\\"; break;
            case '\b': out += "\\b"; break;
            case '\t': out += "\\t"; break;
            case '\n': out += "\\n"; break;
            case '\f': out += "\\f"; break;
            case '\r': out += "\\r"; break;
            default:
                if (c < 0x20) {
                    char buf[8];
                    snprintf(buf, sizeof buf, "\\u%04x", c);
                    out += buf;
                } else {
                    out.push_back((char)c);  // raw UTF-8 (ensure_ascii=False)
                }
        }
    }
    out.push_back('"');
}

static void append_hex(const unsigned char *b, Py_ssize_t n,
                       std::string &out) {
    out.push_back('"');
    size_t base = out.size();
    out.resize(base + 2 * (size_t)n);
    char *dst = &out[base];
    for (Py_ssize_t i = 0; i < n; i++) {
        dst[2 * i] = HEX[b[i] >> 4];
        dst[2 * i + 1] = HEX[b[i] & 0xf];
    }
    out.push_back('"');
}

static bool encode_dict(PyObject *obj, std::string &out, int depth) {
    // keys must be str: json.dumps sorts non-str keys by their ORIGINAL
    // values (ints numerically), which bytewise sort can't reproduce.
    // Values are INCREF'd: recursing may run arbitrary Python (to_obj)
    // which could mutate the dict and invalidate borrowed refs.
    std::vector<std::pair<std::string, PyObject *>> items;
    items.reserve(PyDict_Size(obj));
    bool ok = true;
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(obj, &pos, &key, &value)) {
        if (!PyUnicode_Check(key)) {
            PyErr_SetString(FallbackError, "non-str dict key");
            ok = false;
            break;
        }
        Py_ssize_t kn;
        const char *ks = PyUnicode_AsUTF8AndSize(key, &kn);
        if (ks == nullptr) {
            PyErr_Clear();
            PyErr_SetString(FallbackError, "unencodable dict key");
            ok = false;
            break;
        }
        Py_INCREF(value);
        items.emplace_back(std::string(ks, (size_t)kn), value);
    }
    if (ok) {
        // UTF-8 bytewise order == code-point order == Python str sort
        std::sort(items.begin(), items.end(),
                  [](const auto &a, const auto &b) {
                      return a.first < b.first;
                  });
        out.push_back('{');
        bool first = true;
        for (auto &kv : items) {
            if (!first) out.push_back(',');
            first = false;
            append_escaped(kv.first.data(), (Py_ssize_t)kv.first.size(),
                           out);
            out.push_back(':');
            if (!encode_obj(kv.second, out, depth)) {
                ok = false;
                break;
            }
        }
        if (ok) out.push_back('}');
    }
    for (auto &kv : items) Py_DECREF(kv.second);
    return ok;
}

static bool encode_obj(PyObject *obj, std::string &out, int depth) {
    if (depth > 200) {
        PyErr_SetString(PyExc_ValueError,
                        "canonical encoding: structure too deep");
        return false;
    }
    if (obj == Py_None) {
        out += "null";
        return true;
    }
    if (PyBool_Check(obj)) {  // before PyLong: bool is an int subtype
        out += (obj == Py_True) ? "true" : "false";
        return true;
    }
    if (PyLong_Check(obj)) {
        int overflow = 0;
        long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
        if (overflow == 0 && !(v == -1 && PyErr_Occurred())) {
            char buf[32];
            snprintf(buf, sizeof buf, "%lld", v);
            out += buf;
            return true;
        }
        PyErr_Clear();
        PyObject *s = PyObject_Str(obj);  // arbitrary-precision decimal
        if (s == nullptr) return false;
        Py_ssize_t n;
        const char *cs = PyUnicode_AsUTF8AndSize(s, &n);
        if (cs == nullptr) {
            Py_DECREF(s);
            return false;
        }
        out.append(cs, (size_t)n);
        Py_DECREF(s);
        return true;
    }
    if (PyUnicode_Check(obj)) {
        Py_ssize_t n;
        const char *s = PyUnicode_AsUTF8AndSize(obj, &n);
        if (s == nullptr) {
            PyErr_Clear();  // e.g. lone surrogates: let the pure path rule
            PyErr_SetString(FallbackError, "unencodable str");
            return false;
        }
        append_escaped(s, n, out);
        return true;
    }
    if (PyBytes_Check(obj)) {
        append_hex((const unsigned char *)PyBytes_AS_STRING(obj),
                   PyBytes_GET_SIZE(obj), out);
        return true;
    }
    if (PyByteArray_Check(obj)) {
        append_hex((const unsigned char *)PyByteArray_AS_STRING(obj),
                   PyByteArray_GET_SIZE(obj), out);
        return true;
    }
    if (PyFloat_Check(obj)) {
        PyErr_SetString(PyExc_TypeError,
                        "floats are not deterministic; forbidden in "
                        "canonical encoding");
        return false;
    }
    if (PyDict_Check(obj)) return encode_dict(obj, out, depth + 1);
    if (PyList_Check(obj) || PyTuple_Check(obj)) {
        PyObject *fast = obj;  // borrowed; GET_ITEM works on both
        Py_ssize_t n = PyList_Check(obj) ? PyList_GET_SIZE(obj)
                                         : PyTuple_GET_SIZE(obj);
        out.push_back('[');
        for (Py_ssize_t i = 0; i < n; i++) {
            if (i) out.push_back(',');
            PyObject *it = PyList_Check(obj) ? PyList_GET_ITEM(fast, i)
                                             : PyTuple_GET_ITEM(fast, i);
            if (!encode_obj(it, out, depth + 1)) return false;
        }
        out.push_back(']');
        return true;
    }
    // objects exposing to_obj() (the _canon hook)
    PyObject *to_obj = PyObject_GetAttrString(obj, "to_obj");
    if (to_obj == nullptr) {
        PyErr_Clear();
        PyErr_SetString(FallbackError, "unsupported object type");
        return false;
    }
    PyObject *plain = PyObject_CallObject(to_obj, nullptr);
    Py_DECREF(to_obj);
    if (plain == nullptr) return false;
    bool ok = encode_obj(plain, out, depth + 1);
    Py_DECREF(plain);
    return ok;
}

static PyObject *canonical_dumps(PyObject *self, PyObject *arg) {
    std::string out;
    out.reserve(256);
    if (!encode_obj(arg, out, 0)) return nullptr;
    return PyBytes_FromStringAndSize(out.data(), (Py_ssize_t)out.size());
}

static PyMethodDef methods[] = {
    {"canonical_dumps", canonical_dumps, METH_O,
     "Canonical JSON bytes (sorted keys, minimal separators, bytes as "
     "lowercase hex); byte-equal to the pure-Python cdumps path."},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_tmtorch_codec",
    "Native canonical-JSON encoder for tendermint_tpu", -1, methods,
};

PyMODINIT_FUNC PyInit__tmtorch_codec(void) {
    PyObject *m = PyModule_Create(&moduledef);
    if (m == nullptr) return nullptr;
    FallbackError = PyErr_NewException("_tmtorch_codec.Fallback",
                                       PyExc_TypeError, nullptr);
    Py_INCREF(FallbackError);
    if (PyModule_AddObject(m, "Fallback", FallbackError) < 0) {
        Py_DECREF(FallbackError);
        Py_DECREF(m);
        return nullptr;
    }
    return m;
}
