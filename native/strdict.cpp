// Native string dictionary: C++ core for hdk_jax's dictionary encoding.
//
// Reference: omniscidb/StringDictionary/StringDictionary.cpp — an
// append-only string<->int32 interning map with bulk encode as the
// import hot path (getOrAddBulk, StringDictionary.h:126).  This module
// provides the same core (unordered_map + arena of strings) behind a
// minimal CPython C API surface; hdk_jax/storage/dictionary.py uses it
// when importable and falls back to pure Python otherwise.
//
// API (module hdk_jax_native):
//   dict_new() -> capsule
//   dict_len(capsule) -> int
//   dict_get_or_add(capsule, str) -> int
//   dict_get_code(capsule, str) -> int            (-1 if absent)
//   dict_get_string(capsule, int) -> str
//   dict_bulk_get_or_add(capsule, list[str|None]) -> bytes (int32 codes)
//   dict_bulk_decode(capsule, bytes|memoryview of int32) -> list[str|None]
//   dict_all_strings(capsule) -> list[str]

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <deque>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr int32_t kNullCode = INT32_MIN;

struct StrDict {
  // deque: element addresses are stable under growth, so string_view
  // keys into the stored strings stay valid (a vector would move its
  // SSO strings on reallocation and dangle every map key)
  std::deque<std::string> strings;
  std::unordered_map<std::string_view, int32_t> codes;

  int32_t get_or_add(const char* data, Py_ssize_t len) {
    std::string_view key(data, static_cast<size_t>(len));
    auto it = codes.find(key);
    if (it != codes.end()) {
      return it->second;
    }
    strings.emplace_back(data, static_cast<size_t>(len));
    int32_t code = static_cast<int32_t>(strings.size() - 1);
    codes.emplace(std::string_view(strings.back()), code);
    return code;
  }
};

void destroy(PyObject* capsule) {
  delete static_cast<StrDict*>(PyCapsule_GetPointer(capsule, "hdk.StrDict"));
}

StrDict* unwrap(PyObject* capsule) {
  return static_cast<StrDict*>(PyCapsule_GetPointer(capsule, "hdk.StrDict"));
}

PyObject* dict_new(PyObject*, PyObject*) {
  return PyCapsule_New(new StrDict(), "hdk.StrDict", destroy);
}

PyObject* dict_len(PyObject*, PyObject* arg) {
  StrDict* d = unwrap(arg);
  if (!d) return nullptr;
  return PyLong_FromSsize_t(static_cast<Py_ssize_t>(d->strings.size()));
}

PyObject* dict_get_or_add(PyObject*, PyObject* args) {
  PyObject* cap;
  const char* s;
  Py_ssize_t len;
  if (!PyArg_ParseTuple(args, "Os#", &cap, &s, &len)) return nullptr;
  StrDict* d = unwrap(cap);
  if (!d) return nullptr;
  return PyLong_FromLong(d->get_or_add(s, len));
}

PyObject* dict_get_code(PyObject*, PyObject* args) {
  PyObject* cap;
  const char* s;
  Py_ssize_t len;
  if (!PyArg_ParseTuple(args, "Os#", &cap, &s, &len)) return nullptr;
  StrDict* d = unwrap(cap);
  if (!d) return nullptr;
  auto it = d->codes.find(std::string_view(s, static_cast<size_t>(len)));
  return PyLong_FromLong(it == d->codes.end() ? -1 : it->second);
}

PyObject* dict_get_string(PyObject*, PyObject* args) {
  PyObject* cap;
  long code;
  if (!PyArg_ParseTuple(args, "Ol", &cap, &code)) return nullptr;
  StrDict* d = unwrap(cap);
  if (!d) return nullptr;
  if (code < 0 || static_cast<size_t>(code) >= d->strings.size()) {
    PyErr_SetString(PyExc_IndexError, "string code out of range");
    return nullptr;
  }
  const std::string& s = d->strings[static_cast<size_t>(code)];
  return PyUnicode_FromStringAndSize(s.data(), static_cast<Py_ssize_t>(s.size()));
}

// Parallel bulk encode (reference: TBB-parallel getOrAddBulk,
// StringDictionary.h:126-128 / StringDictionary.cpp).  Code assignment
// stays DETERMINISTIC first-occurrence order — identical output to the
// serial path — via a three-phase scheme:
//   pass 1 (parallel, chunked rows): probe the existing map read-only;
//     unknown strings become per-(chunk, hash-shard) candidate lists.
//   shard pass (parallel, one thread per hash shard): each shard
//     dedups its candidates into first-occurrence row order (chunk
//     order == ascending rows, so the first insert wins).
//   merge (serial, unique strings only): sort new uniques by first
//     row, append to the dictionary in that order.
//   pass 3 (parallel): resolve the pending rows against the now-
//     complete map.
// The GIL is released for all passes; UTF-8 pointers extracted under
// the GIL stay valid while the sequence holds its item refs.
namespace {

constexpr int32_t kPending = -2;

struct BulkItem {
  const char* s;
  Py_ssize_t len;
};

void bulk_encode_serial(StrDict* d, const BulkItem* items, int32_t* codes,
                        Py_ssize_t n) {
  for (Py_ssize_t i = 0; i < n; ++i) {
    if (items[i].s) codes[i] = d->get_or_add(items[i].s, items[i].len);
  }
}

void bulk_encode_parallel(StrDict* d, const BulkItem* items, int32_t* codes,
                          size_t n, unsigned nthreads) {
  const unsigned T = nthreads;
  const size_t chunk = (n + T - 1) / T;
  std::hash<std::string_view> hasher;
  // cand[t][s]: rows of chunk t whose key hashes to shard s and is not
  // yet in the dictionary
  std::vector<std::vector<std::vector<uint32_t>>> cand(
      T, std::vector<std::vector<uint32_t>>(T));

  auto pass1 = [&](unsigned t) {
    const size_t lo = t * chunk, hi = std::min(n, lo + chunk);
    auto& cd = d->codes;  // read-only during this pass
    for (size_t i = lo; i < hi; ++i) {
      if (!items[i].s) continue;  // NULL already coded
      std::string_view key(items[i].s, static_cast<size_t>(items[i].len));
      auto it = cd.find(key);
      if (it != cd.end()) {
        codes[i] = it->second;
      } else {
        codes[i] = kPending;
        cand[t][hasher(key) % T].push_back(static_cast<uint32_t>(i));
      }
    }
  };
  {
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < T; ++t) ts.emplace_back(pass1, t);
    for (auto& th : ts) th.join();
  }

  // shard pass: first-occurrence dedup per hash shard (rows ascend
  // because chunk order == row order)
  std::vector<std::unordered_map<std::string_view, uint32_t>> shard_first(T);
  auto shard_pass = [&](unsigned s) {
    auto& m = shard_first[s];
    for (unsigned t = 0; t < T; ++t) {
      for (uint32_t i : cand[t][s]) {
        std::string_view key(items[i].s, static_cast<size_t>(items[i].len));
        m.emplace(key, i);  // first insert (lowest row) wins
      }
    }
  };
  {
    std::vector<std::thread> ts;
    for (unsigned s = 0; s < T; ++s) ts.emplace_back(shard_pass, s);
    for (auto& th : ts) th.join();
  }

  // merge: append new uniques in first-occurrence row order
  std::vector<std::pair<uint32_t, std::string_view>> news;
  size_t total_new = 0;
  for (auto& m : shard_first) total_new += m.size();
  news.reserve(total_new);
  for (auto& m : shard_first) {
    for (auto& kv : m) news.emplace_back(kv.second, kv.first);
  }
  std::sort(news.begin(), news.end(),
            [](const auto& a, const auto& b) { return a.first < b.first; });
  for (auto& kv : news) {
    d->strings.emplace_back(kv.second);
    d->codes.emplace(std::string_view(d->strings.back()),
                     static_cast<int32_t>(d->strings.size() - 1));
  }

  if (news.empty()) return;
  // pass 3: resolve pending rows against the complete map
  auto pass3 = [&](unsigned t) {
    const size_t lo = t * chunk, hi = std::min(n, lo + chunk);
    auto& cd = d->codes;
    for (size_t i = lo; i < hi; ++i) {
      if (codes[i] != kPending) continue;
      std::string_view key(items[i].s, static_cast<size_t>(items[i].len));
      codes[i] = cd.find(key)->second;
    }
  };
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < T; ++t) ts.emplace_back(pass3, t);
  for (auto& th : ts) th.join();
}

}  // namespace

PyObject* dict_bulk_get_or_add(PyObject*, PyObject* args) {
  PyObject* cap;
  PyObject* seq;
  if (!PyArg_ParseTuple(args, "OO", &cap, &seq)) return nullptr;
  StrDict* d = unwrap(cap);
  if (!d) return nullptr;
  PyObject* fast = PySequence_Fast(seq, "expected a sequence");
  if (!fast) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject* out = PyBytes_FromStringAndSize(nullptr, n * 4);
  if (!out) {
    Py_DECREF(fast);
    return nullptr;
  }
  int32_t* codes = reinterpret_cast<int32_t*>(PyBytes_AS_STRING(out));
  // phase A (GIL held): extract UTF-8 views; the sequence keeps every
  // item alive, so the cached UTF-8 pointers outlive the encode passes.
  // Compact-ASCII strings (the overwhelmingly common case) read their
  // data pointer directly — their ASCII bytes ARE their UTF-8 — which
  // roughly halves this serial, GIL-bound pass.
  std::vector<BulkItem> items(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(fast, i);
    if (item == Py_None) {
      codes[i] = kNullCode;
      items[i] = {nullptr, 0};
      continue;
    }
    if (PyUnicode_Check(item) && PyUnicode_IS_COMPACT_ASCII(item)) {
      items[i] = {reinterpret_cast<const char*>(PyUnicode_1BYTE_DATA(item)),
                  PyUnicode_GET_LENGTH(item)};
      continue;
    }
    Py_ssize_t len;
    const char* s = PyUnicode_AsUTF8AndSize(item, &len);
    if (!s) {
      Py_DECREF(fast);
      Py_DECREF(out);
      return nullptr;
    }
    items[i] = {s, len};
  }
  unsigned hw = std::thread::hardware_concurrency();
  unsigned nthreads = hw ? std::min(hw, 16u) : 1u;
  // HDK_JAX_DICT_THREADS=1 forces the serial path (A/B measurement)
  if (const char* env = getenv("HDK_JAX_DICT_THREADS")) {
    long v = strtol(env, nullptr, 10);
    if (v >= 1 && v <= 64) nthreads = static_cast<unsigned>(v);
  }
  if (n >= (Py_ssize_t{1} << 15) && nthreads >= 2) {
    Py_BEGIN_ALLOW_THREADS
    bulk_encode_parallel(d, items.data(), codes,
                         static_cast<size_t>(n), nthreads);
    Py_END_ALLOW_THREADS
  } else {
    bulk_encode_serial(d, items.data(), codes, n);
  }
  Py_DECREF(fast);
  return out;
}

PyObject* dict_bulk_get_code(PyObject*, PyObject* args) {
  // read-only bulk lookup: codes for existing strings, -1 for absent,
  // kNullCode for None (reference: StringDictionary::getBulk,
  // StringDictionary.h:118-124)
  PyObject* cap;
  PyObject* seq;
  if (!PyArg_ParseTuple(args, "OO", &cap, &seq)) return nullptr;
  StrDict* d = unwrap(cap);
  if (!d) return nullptr;
  PyObject* fast = PySequence_Fast(seq, "expected a sequence");
  if (!fast) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject* out = PyBytes_FromStringAndSize(nullptr, n * 4);
  if (!out) {
    Py_DECREF(fast);
    return nullptr;
  }
  int32_t* codes = reinterpret_cast<int32_t*>(PyBytes_AS_STRING(out));
  std::vector<BulkItem> items(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(fast, i);
    if (item == Py_None) {
      codes[i] = kNullCode;
      items[i] = {nullptr, 0};
      continue;
    }
    Py_ssize_t len;
    const char* s = PyUnicode_AsUTF8AndSize(item, &len);
    if (!s) {
      Py_DECREF(fast);
      Py_DECREF(out);
      return nullptr;
    }
    items[i] = {s, len};
  }
  Py_BEGIN_ALLOW_THREADS
  for (Py_ssize_t i = 0; i < n; ++i) {
    if (!items[i].s) continue;
    auto it = d->codes.find(std::string_view(
        items[i].s, static_cast<size_t>(items[i].len)));
    codes[i] = it == d->codes.end() ? -1 : it->second;
  }
  Py_END_ALLOW_THREADS
  Py_DECREF(fast);
  return out;
}

PyObject* dict_bulk_decode(PyObject*, PyObject* args) {
  PyObject* cap;
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "Oy*", &cap, &buf)) return nullptr;
  StrDict* d = unwrap(cap);
  if (!d) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  Py_ssize_t n = buf.len / 4;
  const int32_t* codes = static_cast<const int32_t*>(buf.buf);
  PyObject* out = PyList_New(n);
  if (!out) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n; ++i) {
    int32_t c = codes[i];
    if (c == kNullCode || c < 0 ||
        static_cast<size_t>(c) >= d->strings.size()) {
      Py_INCREF(Py_None);
      PyList_SET_ITEM(out, i, Py_None);
    } else {
      const std::string& s = d->strings[static_cast<size_t>(c)];
      PyObject* u = PyUnicode_FromStringAndSize(
          s.data(), static_cast<Py_ssize_t>(s.size()));
      if (!u) {
        Py_DECREF(out);
        PyBuffer_Release(&buf);
        return nullptr;
      }
      PyList_SET_ITEM(out, i, u);
    }
  }
  PyBuffer_Release(&buf);
  return out;
}

PyObject* dict_all_strings(PyObject*, PyObject* arg) {
  StrDict* d = unwrap(arg);
  if (!d) return nullptr;
  PyObject* out = PyList_New(static_cast<Py_ssize_t>(d->strings.size()));
  if (!out) return nullptr;
  for (size_t i = 0; i < d->strings.size(); ++i) {
    PyObject* u = PyUnicode_FromStringAndSize(
        d->strings[i].data(), static_cast<Py_ssize_t>(d->strings[i].size()));
    if (!u) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, static_cast<Py_ssize_t>(i), u);
  }
  return out;
}

PyMethodDef methods[] = {
    {"dict_new", dict_new, METH_NOARGS, "create a dictionary"},
    {"dict_len", dict_len, METH_O, "entry count"},
    {"dict_get_or_add", dict_get_or_add, METH_VARARGS, "intern one string"},
    {"dict_get_code", dict_get_code, METH_VARARGS, "lookup, -1 if absent"},
    {"dict_get_string", dict_get_string, METH_VARARGS, "code -> string"},
    {"dict_bulk_get_or_add", dict_bulk_get_or_add, METH_VARARGS,
     "intern a sequence; returns int32 codes as bytes"},
    {"dict_bulk_get_code", dict_bulk_get_code, METH_VARARGS,
     "bulk lookup; -1 for absent strings"},
    {"dict_bulk_decode", dict_bulk_decode, METH_VARARGS,
     "int32 code buffer -> list of str/None"},
    {"dict_all_strings", dict_all_strings, METH_O, "all strings in order"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "hdk_jax_native",
                      "native core for hdk_jax", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_hdk_jax_native() { return PyModule_Create(&module); }
