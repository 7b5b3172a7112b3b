/*!
 * Implementation of the full native C graph ABI (see c_api_graph.h) over
 * an embedded CPython runtime.
 *
 * Reference parity: src/c_api/c_api.cc. The reference marshals into C++
 * classes; here every entry point holds the GIL, calls the matching
 * plain-typed shim in mxnet_tpu_torch/c_api_impl.py, and unpacks the result
 * into thread-local scratch (the analogue of the reference's
 * MXAPIThreadLocalEntry). Handles are integer ids in the shim's table
 * cast to void*, so this file never owns a PyObject. Built by
 * mxnet_tpu_torch/capi/__init__.py, which defines MXT_PYTHON (the
 * interpreter) and MXT_ROOT (the repo).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <set>
#include <string>
#include <vector>

#include "c_api_graph.h"

namespace {

thread_local std::string g_last_error;

void SetError(const std::string &msg) { g_last_error = msg; }

void SetErrorFromPython() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "python error";
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  SetError(msg);
}

std::once_flag g_init_once;
PyObject *g_module = nullptr;  // mxnet_tpu_torch.c_api_impl, kept forever

bool EnsureRuntime() {
  std::call_once(g_init_once, []() {
    if (!Py_IsInitialized()) {
      /* the interpreter the library was built for (its venv included:
       * CPython finds pyvenv.cfg beside program_name); the repo root
       * goes first on sys.path so that mxnet_tpu_torch imports without
       * PYTHONPATH */
      PyConfig config;
      PyConfig_InitPythonConfig(&config);
      config.install_signal_handlers = 0;
      PyConfig_SetBytesString(&config, &config.program_name, MXT_PYTHON);
      Py_InitializeFromConfig(&config);
      PyConfig_Clear(&config);
      PyObject *path = PySys_GetObject("path");  // borrowed
      PyObject *root = PyUnicode_FromString(MXT_ROOT);
      if (path && root) PyList_Insert(path, 0, root);
      Py_XDECREF(root);
      /* drop the GIL acquired by initialization so any thread can take it */
      PyEval_SaveThread();
    }
  });
  return true;
}

class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

bool EnsureModule() {
  if (g_module) return true;
  PyObject *m = PyImport_ImportModule("mxnet_tpu_torch.c_api_impl");
  if (!m) {
    SetErrorFromPython();
    return false;
  }
  g_module = m;
  return true;
}

/* Call a shim function; returns new ref or nullptr (error already set). */
PyObject *Call(const char *fn, PyObject *args /* stolen */) {
  if (!args) {
    SetErrorFromPython();
    return nullptr;
  }
  PyObject *f = PyObject_GetAttrString(g_module, fn);
  if (!f) {
    Py_DECREF(args);
    SetErrorFromPython();
    return nullptr;
  }
  PyObject *r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_DECREF(args);
  if (!r) SetErrorFromPython();
  return r;
}

/* Thread-local scratch backing all returned pointers: valid until the
 * next ABI call on the same thread (reference MXAPIThreadLocalEntry). */
struct Scratch {
  // three independent slots so one call can return up to three string
  // lists (e.g. MXTSymbolGetAtomicSymbolInfo) without one list's
  // reallocation invalidating another's c_str() pointers
  std::vector<std::string> strs[3];
  std::vector<const char *> cstrs[3];
  std::vector<void *> handles;
  std::string bytes;
  std::string str;
  std::vector<mx_uint> shape;
  std::vector<uint64_t> index;
  std::vector<int> types[3];
  // per-section shape storage for InferShape (arg/out/aux)
  std::vector<mx_uint> ndims[3];
  std::vector<std::vector<mx_uint>> dims[3];
  std::vector<const mx_uint *> dptrs[3];
};

Scratch *TLS() {
  thread_local Scratch s;
  return &s;
}

/* interned names double as Function/Creator handles */
const char *Intern(const std::string &s) {
  static std::set<std::string> pool;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  return pool.insert(s).first->c_str();
}

uintptr_t Id(void *h) { return reinterpret_cast<uintptr_t>(h); }
void *AsHandle(long long id) { return reinterpret_cast<void *>(id); }

PyObject *HandleTuple(mx_uint n, void **hs) {
  PyObject *t = PyTuple_New(n);
  for (mx_uint i = 0; i < n; ++i)
    PyTuple_SetItem(t, i, PyLong_FromUnsignedLongLong(
                              hs ? Id(hs[i]) : 0));
  return t;
}

PyObject *StrTuple(mx_uint n, const char **ss) {
  PyObject *t = PyTuple_New(n);
  for (mx_uint i = 0; i < n; ++i)
    PyTuple_SetItem(t, i, PyUnicode_FromString(ss[i]));
  return t;
}

PyObject *IntTuple(mx_uint n, const int *xs) {
  PyObject *t = PyTuple_New(n);
  for (mx_uint i = 0; i < n; ++i)
    PyTuple_SetItem(t, i, PyLong_FromLong(xs[i]));
  return t;
}

PyObject *UIntTuple(mx_uint n, const mx_uint *xs) {
  PyObject *t = PyTuple_New(n);
  for (mx_uint i = 0; i < n; ++i)
    PyTuple_SetItem(t, i, PyLong_FromUnsignedLong(xs[i]));
  return t;
}

/* unpack a tuple of str into scratch slot `which` (0..2); each call
 * replaces that slot's previous contents, so results live until the next
 * ABI call on the thread (reference MXAPIThreadLocalEntry contract) */
bool UnpackStrs(PyObject *r, mx_uint *out_size, const char ***out_array,
                int which = 0) {
  Scratch *s = TLS();
  std::vector<std::string> &strs = s->strs[which];
  std::vector<const char *> &cs = s->cstrs[which];
  Py_ssize_t n = PySequence_Size(r);
  if (n < 0) return false;
  strs.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *it = PySequence_GetItem(r, i);
    const char *c = PyUnicode_AsUTF8(it);
    strs.emplace_back(c ? c : "");
    Py_XDECREF(it);
  }
  cs.clear();
  for (Py_ssize_t i = 0; i < n; ++i)
    cs.push_back(strs[i].c_str());
  *out_size = static_cast<mx_uint>(n);
  *out_array = cs.data();
  return true;
}

bool UnpackHandles(PyObject *r, mx_uint *out_size, void ***out_array) {
  Scratch *s = TLS();
  Py_ssize_t n = PySequence_Size(r);
  if (n < 0) return false;
  s->handles.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *it = PySequence_GetItem(r, i);
    s->handles.push_back(AsHandle(PyLong_AsLongLong(it)));
    Py_XDECREF(it);
  }
  *out_size = static_cast<mx_uint>(n);
  *out_array = s->handles.data();
  return true;
}

/* unpack ((s0..),(s1..),..) into scratch shape section `sec` */
bool UnpackShapes(PyObject *shapes, int sec, mx_uint *out_size,
                  const mx_uint **out_ndim, const mx_uint ***out_data) {
  Scratch *s = TLS();
  Py_ssize_t n = PySequence_Size(shapes);
  if (n < 0) return false;
  s->ndims[sec].clear();
  s->dims[sec].clear();
  s->dptrs[sec].clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *shp = PySequence_GetItem(shapes, i);
    Py_ssize_t d = PySequence_Size(shp);
    std::vector<mx_uint> dim;
    for (Py_ssize_t j = 0; j < d; ++j) {
      PyObject *x = PySequence_GetItem(shp, j);
      dim.push_back(static_cast<mx_uint>(PyLong_AsUnsignedLong(x)));
      Py_XDECREF(x);
    }
    Py_XDECREF(shp);
    s->ndims[sec].push_back(static_cast<mx_uint>(d));
    s->dims[sec].push_back(std::move(dim));
  }
  for (auto &v : s->dims[sec]) s->dptrs[sec].push_back(v.data());
  *out_size = static_cast<mx_uint>(n);
  *out_ndim = s->ndims[sec].data();
  *out_data = s->dptrs[sec].data();
  return true;
}

bool UnpackInts(PyObject *r, int sec, mx_uint *out_size, const int **out) {
  Scratch *s = TLS();
  Py_ssize_t n = PySequence_Size(r);
  if (n < 0) return false;
  s->types[sec].clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *it = PySequence_GetItem(r, i);
    s->types[sec].push_back(static_cast<int>(PyLong_AsLong(it)));
    Py_XDECREF(it);
  }
  *out_size = static_cast<mx_uint>(n);
  *out = s->types[sec].data();
  return true;
}

#define ENTER()               \
  EnsureRuntime();            \
  Gil gil;                    \
  if (!EnsureModule()) return -1

/* run a shim returning None */
int VoidCall(const char *fn, PyObject *args) {
  PyObject *r = Call(fn, args);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

/* run a shim returning one int (usually a new handle id) */
int HandleCall(const char *fn, PyObject *args, void **out) {
  PyObject *r = Call(fn, args);
  if (!r) return -1;
  *out = AsHandle(PyLong_AsLongLong(r));
  Py_DECREF(r);
  if (PyErr_Occurred()) {
    SetErrorFromPython();
    return -1;
  }
  return 0;
}

/* run a shim returning one str, into scratch */
int StrCall(const char *fn, PyObject *args, const char **out) {
  PyObject *r = Call(fn, args);
  if (!r) return -1;
  const char *c = PyUnicode_AsUTF8(r);
  TLS()->str = c ? c : "";
  Py_DECREF(r);
  *out = TLS()->str.c_str();
  return 0;
}

}  // namespace

extern "C" {

const char *MXTApiGetLastError(void) { return g_last_error.c_str(); }

/* ---- global ---------------------------------------------------------- */

int MXTRandomSeed(int seed) {
  ENTER();
  return VoidCall("random_seed", Py_BuildValue("(i)", seed));
}

int MXTNotifyShutdown(void) {
  ENTER();
  return VoidCall("notify_shutdown", PyTuple_New(0));
}

/* ---- NDArray --------------------------------------------------------- */

int MXTNDArrayCreateNone(NDArrayHandle *out) {
  ENTER();
  return HandleCall("ndarray_create_none", PyTuple_New(0), out);
}

int MXTNDArrayCreateEx(const mx_uint *shape, mx_uint ndim, int dev_type,
                       int dev_id, int delay_alloc, int dtype,
                       NDArrayHandle *out) {
  ENTER();
  PyObject *shp = UIntTuple(ndim, shape);
  return HandleCall("ndarray_create",
                    Py_BuildValue("(Niiii)", shp, dev_type, dev_id,
                                  delay_alloc, dtype),
                    out);
}

int MXTNDArrayCreate(const mx_uint *shape, mx_uint ndim, int dev_type,
                     int dev_id, int delay_alloc, NDArrayHandle *out) {
  return MXTNDArrayCreateEx(shape, ndim, dev_type, dev_id, delay_alloc, 0,
                            out);
}

int MXTNDArrayFree(NDArrayHandle handle) {
  ENTER();
  return VoidCall("free_handle", Py_BuildValue("(K)", Id(handle)));
}

int MXTNDArrayGetShape(NDArrayHandle handle, mx_uint *out_dim,
                       const mx_uint **out_pdata) {
  ENTER();
  PyObject *r = Call("ndarray_shape", Py_BuildValue("(K)", Id(handle)));
  if (!r) return -1;
  Scratch *s = TLS();
  s->shape.clear();
  Py_ssize_t n = PySequence_Size(r);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *it = PySequence_GetItem(r, i);
    s->shape.push_back(static_cast<mx_uint>(PyLong_AsUnsignedLong(it)));
    Py_XDECREF(it);
  }
  Py_DECREF(r);
  *out_dim = static_cast<mx_uint>(n);
  *out_pdata = s->shape.data();
  return 0;
}

int MXTNDArrayGetDType(NDArrayHandle handle, int *out_dtype) {
  ENTER();
  PyObject *r = Call("ndarray_dtype", Py_BuildValue("(K)", Id(handle)));
  if (!r) return -1;
  *out_dtype = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int MXTNDArrayGetContext(NDArrayHandle handle, int *out_dev_type,
                         int *out_dev_id) {
  ENTER();
  PyObject *r = Call("ndarray_context", Py_BuildValue("(K)", Id(handle)));
  if (!r) return -1;
  int ok = PyArg_ParseTuple(r, "ii", out_dev_type, out_dev_id);
  Py_DECREF(r);
  if (!ok) {
    SetErrorFromPython();
    return -1;
  }
  return 0;
}

int MXTNDArraySyncCopyFromCPU(NDArrayHandle handle, const void *data,
                              size_t size) {
  ENTER();
  int dtype = 0;
  if (MXTNDArrayGetDType(handle, &dtype) != 0) return -1;
  size_t esize = dtype == 1 ? 8 : (dtype == 2 || dtype == 16) ? 2
                 : dtype == 3 ? 1 : 4;
  return VoidCall("ndarray_sync_copy_from",
                  Py_BuildValue("(Ky#)", Id(handle),
                                static_cast<const char *>(data),
                                static_cast<Py_ssize_t>(size * esize)));
}

int MXTNDArraySyncCopyToCPU(NDArrayHandle handle, void *data, size_t size) {
  ENTER();
  PyObject *r = Call("ndarray_sync_copy_to",
                     Py_BuildValue("(K)", Id(handle)));
  if (!r) return -1;
  char *buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(r, &buf, &len) != 0) {
    Py_DECREF(r);
    SetErrorFromPython();
    return -1;
  }
  int dtype = 0;
  MXTNDArrayGetDType(handle, &dtype);
  size_t esize = dtype == 1 ? 8 : (dtype == 2 || dtype == 16) ? 2
                 : dtype == 3 ? 1 : 4;
  size_t want = size * esize;
  if (want != static_cast<size_t>(len)) {
    Py_DECREF(r);
    SetError("MXTNDArraySyncCopyToCPU: size mismatch (array has " +
             std::to_string(len / esize) + " elements, caller asked for " +
             std::to_string(size) + ")");
    return -1;
  }
  std::memcpy(data, buf, want);
  Py_DECREF(r);
  return 0;
}

int MXTNDArrayWaitToRead(NDArrayHandle handle) {
  ENTER();
  return VoidCall("ndarray_wait_to_read", Py_BuildValue("(K)", Id(handle)));
}

int MXTNDArrayWaitToWrite(NDArrayHandle handle) {
  ENTER();
  return VoidCall("ndarray_wait_to_write", Py_BuildValue("(K)", Id(handle)));
}

int MXTNDArrayWaitAll(void) {
  ENTER();
  return VoidCall("wait_all", PyTuple_New(0));
}

int MXTNDArraySlice(NDArrayHandle handle, mx_uint slice_begin,
                    mx_uint slice_end, NDArrayHandle *out) {
  ENTER();
  return HandleCall("ndarray_slice",
                    Py_BuildValue("(KII)", Id(handle), slice_begin,
                                  slice_end),
                    out);
}

int MXTNDArrayReshape(NDArrayHandle handle, int ndim, const int *dims,
                      NDArrayHandle *out) {
  ENTER();
  PyObject *shp = IntTuple(ndim, dims);
  return HandleCall("ndarray_reshape",
                    Py_BuildValue("(KN)", Id(handle), shp), out);
}

int MXTNDArraySave(const char *fname, mx_uint num_args, NDArrayHandle *args,
                   const char **keys) {
  ENTER();
  PyObject *hs = HandleTuple(num_args, args);
  PyObject *names = keys ? StrTuple(num_args, keys) : PyTuple_New(0);
  return VoidCall("ndarray_save", Py_BuildValue("(sNN)", fname, hs, names));
}

int MXTNDArrayLoad(const char *fname, mx_uint *out_size,
                   NDArrayHandle **out_arr, mx_uint *out_name_size,
                   const char ***out_names) {
  ENTER();
  PyObject *r = Call("ndarray_load", Py_BuildValue("(s)", fname));
  if (!r) return -1;
  PyObject *hids = PyTuple_GetItem(r, 0);
  PyObject *names = PyTuple_GetItem(r, 1);
  bool ok = UnpackHandles(hids, out_size, out_arr) &&
            UnpackStrs(names, out_name_size, out_names);
  Py_DECREF(r);
  if (!ok) {
    SetError("ndarray_load: malformed result");
    return -1;
  }
  return 0;
}

int MXTNDArraySaveRawBytes(NDArrayHandle handle, size_t *out_size,
                           const char **out_buf) {
  ENTER();
  PyObject *r = Call("ndarray_save_raw", Py_BuildValue("(K)", Id(handle)));
  if (!r) return -1;
  char *buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(r, &buf, &len) != 0) {
    Py_DECREF(r);
    SetErrorFromPython();
    return -1;
  }
  TLS()->bytes.assign(buf, len);
  Py_DECREF(r);
  *out_size = TLS()->bytes.size();
  *out_buf = TLS()->bytes.data();
  return 0;
}

int MXTNDArrayLoadFromRawBytes(const void *buf, size_t size,
                               NDArrayHandle *out) {
  ENTER();
  return HandleCall("ndarray_load_raw",
                    Py_BuildValue("(y#)", static_cast<const char *>(buf),
                                  static_cast<Py_ssize_t>(size)),
                    out);
}

/* ---- NDArray function registry -------------------------------------- */

int MXTListFunctions(mx_uint *out_size, FunctionHandle **out_array) {
  ENTER();
  PyObject *r = Call("list_functions", PyTuple_New(0));
  if (!r) return -1;
  Scratch *s = TLS();
  s->handles.clear();
  Py_ssize_t n = PySequence_Size(r);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *it = PySequence_GetItem(r, i);
    const char *c = PyUnicode_AsUTF8(it);
    s->handles.push_back(const_cast<char *>(Intern(c ? c : "")));
    Py_XDECREF(it);
  }
  Py_DECREF(r);
  *out_size = static_cast<mx_uint>(n);
  *out_array = const_cast<FunctionHandle *>(
      reinterpret_cast<const void *const *>(s->handles.data()));
  return 0;
}

int MXTGetFunction(const char *name, FunctionHandle *out) {
  ENTER();
  PyObject *r = Call("func_info", Py_BuildValue("(s)", name));
  if (!r) return -1;
  Py_DECREF(r);
  *out = Intern(name);
  return 0;
}

int MXTFuncGetInfo(FunctionHandle fun, const char **name,
                   const char **description) {
  ENTER();
  PyObject *r = Call("func_info",
                     Py_BuildValue("(s)", static_cast<const char *>(fun)));
  if (!r) return -1;
  *name = static_cast<const char *>(fun);
  const char *doc = "";
  PyObject *d = PyTuple_GetItem(r, 1);
  if (d) doc = PyUnicode_AsUTF8(d);
  TLS()->str = doc ? doc : "";
  Py_DECREF(r);
  *description = TLS()->str.c_str();
  return 0;
}

int MXTFuncDescribe(FunctionHandle fun, mx_uint *num_used_vars,
                    mx_uint *num_scalars, mx_uint *num_mutate_vars,
                    int *type_mask) {
  ENTER();
  PyObject *r = Call("func_describe",
                     Py_BuildValue("(s)", static_cast<const char *>(fun)));
  if (!r) return -1;
  int u = 0, s = 0, m = 0;
  int ok = PyArg_ParseTuple(r, "iii", &u, &s, &m);
  Py_DECREF(r);
  if (!ok) {
    SetErrorFromPython();
    return -1;
  }
  *num_used_vars = u;
  *num_scalars = s;
  *num_mutate_vars = m;
  if (type_mask) *type_mask = 0;
  return 0;
}

int MXTFuncInvoke(FunctionHandle fun, NDArrayHandle *used_vars,
                  mx_float *scalar_args, NDArrayHandle *mutate_vars) {
  ENTER();
  mx_uint nu = 0, ns = 0, nm = 0;
  int mask = 0;
  if (MXTFuncDescribe(fun, &nu, &ns, &nm, &mask) != 0) return -1;
  PyObject *used = HandleTuple(nu, used_vars);
  PyObject *scalars = PyTuple_New(ns);
  for (mx_uint i = 0; i < ns; ++i)
    PyTuple_SetItem(scalars, i, PyFloat_FromDouble(scalar_args[i]));
  PyObject *mut = HandleTuple(nm, mutate_vars);
  return VoidCall("func_invoke",
                  Py_BuildValue("(sNNN)", static_cast<const char *>(fun),
                                used, scalars, mut));
}

/* ---- Symbol ---------------------------------------------------------- */

int MXTSymbolListAtomicSymbolCreators(mx_uint *out_size,
                                      AtomicSymbolCreator **out_array) {
  ENTER();
  PyObject *r = Call("symbol_list_creators", PyTuple_New(0));
  if (!r) return -1;
  Scratch *s = TLS();
  s->handles.clear();
  Py_ssize_t n = PySequence_Size(r);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *it = PySequence_GetItem(r, i);
    const char *c = PyUnicode_AsUTF8(it);
    s->handles.push_back(const_cast<char *>(Intern(c ? c : "")));
    Py_XDECREF(it);
  }
  Py_DECREF(r);
  *out_size = static_cast<mx_uint>(n);
  *out_array = s->handles.data();
  return 0;
}

int MXTSymbolGetAtomicSymbolName(AtomicSymbolCreator creator,
                                 const char **name) {
  *name = static_cast<const char *>(creator);
  return 0;
}

int MXTSymbolGetAtomicSymbolInfo(AtomicSymbolCreator creator,
                                 const char **name, const char **description,
                                 mx_uint *num_args, const char ***arg_names,
                                 const char ***arg_type_infos,
                                 const char ***arg_descriptions) {
  ENTER();
  PyObject *r =
      Call("symbol_creator_info",
           Py_BuildValue("(s)", static_cast<const char *>(creator)));
  if (!r) return -1;
  Scratch *s = TLS();
  *name = static_cast<const char *>(creator);
  PyObject *doc = PyTuple_GetItem(r, 1);
  const char *d = doc ? PyUnicode_AsUTF8(doc) : "";
  s->str = d ? d : "";
  *description = s->str.c_str();
  mx_uint n2 = 0, n3 = 0;
  bool ok = UnpackStrs(PyTuple_GetItem(r, 2), num_args, arg_names, 0) &&
            UnpackStrs(PyTuple_GetItem(r, 3), &n2, arg_type_infos, 1) &&
            UnpackStrs(PyTuple_GetItem(r, 4), &n3, arg_descriptions, 2);
  Py_DECREF(r);
  if (!ok) {
    SetError("symbol_creator_info: malformed result");
    return -1;
  }
  return 0;
}

int MXTSymbolCreateAtomicSymbol(AtomicSymbolCreator creator,
                                mx_uint num_param, const char **keys,
                                const char **vals, SymbolHandle *out) {
  ENTER();
  PyObject *k = StrTuple(num_param, keys);
  PyObject *v = StrTuple(num_param, vals);
  return HandleCall("symbol_create_atomic",
                    Py_BuildValue("(sNN)",
                                  static_cast<const char *>(creator), k, v),
                    out);
}

int MXTSymbolCreateVariable(const char *name, SymbolHandle *out) {
  ENTER();
  return HandleCall("symbol_create_variable", Py_BuildValue("(s)", name),
                    out);
}

int MXTSymbolCreateGroup(mx_uint num_symbols, SymbolHandle *symbols,
                         SymbolHandle *out) {
  ENTER();
  PyObject *hs = HandleTuple(num_symbols, symbols);
  return HandleCall("symbol_create_group", Py_BuildValue("(N)", hs), out);
}

int MXTSymbolCreateFromFile(const char *fname, SymbolHandle *out) {
  ENTER();
  return HandleCall("symbol_from_file", Py_BuildValue("(s)", fname), out);
}

int MXTSymbolCreateFromJSON(const char *json, SymbolHandle *out) {
  ENTER();
  return HandleCall("symbol_from_json", Py_BuildValue("(s)", json), out);
}

int MXTSymbolSaveToFile(SymbolHandle symbol, const char *fname) {
  ENTER();
  return VoidCall("symbol_save_file",
                  Py_BuildValue("(Ks)", Id(symbol), fname));
}

int MXTSymbolSaveToJSON(SymbolHandle symbol, const char **out_json) {
  ENTER();
  return StrCall("symbol_to_json", Py_BuildValue("(K)", Id(symbol)),
                 out_json);
}

int MXTSymbolFree(SymbolHandle symbol) { return MXTNDArrayFree(symbol); }

int MXTSymbolCopy(SymbolHandle symbol, SymbolHandle *out) {
  ENTER();
  return HandleCall("symbol_copy", Py_BuildValue("(K)", Id(symbol)), out);
}

int MXTSymbolPrint(SymbolHandle symbol, const char **out_str) {
  ENTER();
  return StrCall("symbol_print", Py_BuildValue("(K)", Id(symbol)), out_str);
}

int MXTSymbolGetAttr(SymbolHandle symbol, const char *key, const char **out,
                     int *success) {
  ENTER();
  PyObject *r =
      Call("symbol_get_attr", Py_BuildValue("(Ks)", Id(symbol), key));
  if (!r) return -1;
  int ok = 0;
  const char *val = nullptr;
  if (!PyArg_ParseTuple(r, "is", &ok, &val)) {
    Py_DECREF(r);
    SetErrorFromPython();
    return -1;
  }
  TLS()->str = val ? val : "";
  Py_DECREF(r);
  *success = ok;
  *out = ok ? TLS()->str.c_str() : nullptr;
  return 0;
}

int MXTSymbolSetAttr(SymbolHandle symbol, const char *key,
                     const char *value) {
  ENTER();
  return VoidCall("symbol_set_attr",
                  Py_BuildValue("(Kss)", Id(symbol), key, value));
}

#define SYMBOL_STRLIST(cname, shim)                                       \
  int cname(SymbolHandle symbol, mx_uint *out_size,                       \
            const char ***out_str_array) {                                \
    ENTER();                                                              \
    PyObject *r = Call(shim, Py_BuildValue("(K)", Id(symbol)));           \
    if (!r) return -1;                                                    \
    bool ok = UnpackStrs(r, out_size, out_str_array);                     \
    Py_DECREF(r);                                                         \
    if (!ok) {                                                            \
      SetError(#cname ": malformed result");                              \
      return -1;                                                          \
    }                                                                     \
    return 0;                                                             \
  }

SYMBOL_STRLIST(MXTSymbolListArguments, "symbol_list_arguments")
SYMBOL_STRLIST(MXTSymbolListOutputs, "symbol_list_outputs")
SYMBOL_STRLIST(MXTSymbolListAuxiliaryStates, "symbol_list_aux")

int MXTSymbolGetInternals(SymbolHandle symbol, SymbolHandle *out) {
  ENTER();
  return HandleCall("symbol_get_internals", Py_BuildValue("(K)", Id(symbol)),
                    out);
}

int MXTSymbolGetOutput(SymbolHandle symbol, mx_uint index,
                       SymbolHandle *out) {
  ENTER();
  return HandleCall("symbol_get_output",
                    Py_BuildValue("(KI)", Id(symbol), index), out);
}

int MXTSymbolCompose(SymbolHandle sym, const char *name, mx_uint num_args,
                     const char **keys, SymbolHandle *args) {
  ENTER();
  PyObject *k = keys ? StrTuple(num_args, keys) : PyTuple_New(0);
  PyObject *hs = HandleTuple(num_args, args);
  return VoidCall("symbol_compose",
                  Py_BuildValue("(KsNN)", Id(sym), name ? name : "", k, hs));
}

int MXTSymbolGrad(SymbolHandle sym, mx_uint num_wrt, const char **wrt,
                  SymbolHandle *out) {
  ENTER();
  PyObject *w = StrTuple(num_wrt, wrt);
  return HandleCall("symbol_grad", Py_BuildValue("(KN)", Id(sym), w), out);
}

static int InferShapeImpl(SymbolHandle sym, mx_uint num_args,
                          const char **keys, const mx_uint *arg_ind_ptr,
                          const mx_uint *arg_shape_data,
                          mx_uint *in_shape_size,
                          const mx_uint **in_shape_ndim,
                          const mx_uint ***in_shape_data,
                          mx_uint *out_shape_size,
                          const mx_uint **out_shape_ndim,
                          const mx_uint ***out_shape_data,
                          mx_uint *aux_shape_size,
                          const mx_uint **aux_shape_ndim,
                          const mx_uint ***aux_shape_data, int *complete,
                          int partial) {
  ENTER();
  /* keys == NULL => positional inference (reference c_api.cc supports
   * it); the shim maps shapes to list_arguments() order */
  PyObject *k = keys ? StrTuple(num_args, keys) : PyTuple_New(0);
  PyObject *shapes = PyTuple_New(num_args);
  for (mx_uint i = 0; i < num_args; ++i) {
    mx_uint lo = arg_ind_ptr[i], hi = arg_ind_ptr[i + 1];
    PyObject *shp = PyTuple_New(hi - lo);
    for (mx_uint j = lo; j < hi; ++j)
      PyTuple_SetItem(shp, j - lo,
                      PyLong_FromUnsignedLong(arg_shape_data[j]));
    PyTuple_SetItem(shapes, i, shp);
  }
  PyObject *r = Call("symbol_infer_shape",
                     Py_BuildValue("(KNNi)", Id(sym), k, shapes, partial));
  if (!r) return -1;
  long done = PyLong_AsLong(PyTuple_GetItem(r, 0));
  bool ok =
      UnpackShapes(PyTuple_GetItem(r, 1), 0, in_shape_size, in_shape_ndim,
                   in_shape_data) &&
      UnpackShapes(PyTuple_GetItem(r, 2), 1, out_shape_size, out_shape_ndim,
                   out_shape_data) &&
      UnpackShapes(PyTuple_GetItem(r, 3), 2, aux_shape_size, aux_shape_ndim,
                   aux_shape_data);
  Py_DECREF(r);
  if (!ok) {
    SetError("symbol_infer_shape: malformed result");
    return -1;
  }
  *complete = static_cast<int>(done);
  return 0;
}

int MXTSymbolInferShape(SymbolHandle sym, mx_uint num_args,
                        const char **keys, const mx_uint *arg_ind_ptr,
                        const mx_uint *arg_shape_data,
                        mx_uint *in_shape_size, const mx_uint **in_shape_ndim,
                        const mx_uint ***in_shape_data,
                        mx_uint *out_shape_size,
                        const mx_uint **out_shape_ndim,
                        const mx_uint ***out_shape_data,
                        mx_uint *aux_shape_size,
                        const mx_uint **aux_shape_ndim,
                        const mx_uint ***aux_shape_data, int *complete) {
  return InferShapeImpl(sym, num_args, keys, arg_ind_ptr, arg_shape_data,
                        in_shape_size, in_shape_ndim, in_shape_data,
                        out_shape_size, out_shape_ndim, out_shape_data,
                        aux_shape_size, aux_shape_ndim, aux_shape_data,
                        complete, 0);
}

int MXTSymbolInferShapePartial(
    SymbolHandle sym, mx_uint num_args, const char **keys,
    const mx_uint *arg_ind_ptr, const mx_uint *arg_shape_data,
    mx_uint *in_shape_size, const mx_uint **in_shape_ndim,
    const mx_uint ***in_shape_data, mx_uint *out_shape_size,
    const mx_uint **out_shape_ndim, const mx_uint ***out_shape_data,
    mx_uint *aux_shape_size, const mx_uint **aux_shape_ndim,
    const mx_uint ***aux_shape_data, int *complete) {
  return InferShapeImpl(sym, num_args, keys, arg_ind_ptr, arg_shape_data,
                        in_shape_size, in_shape_ndim, in_shape_data,
                        out_shape_size, out_shape_ndim, out_shape_data,
                        aux_shape_size, aux_shape_ndim, aux_shape_data,
                        complete, 1);
}

int MXTSymbolInferType(SymbolHandle sym, mx_uint num_args, const char **keys,
                       const int *arg_type_data, mx_uint *in_type_size,
                       const int **in_type_data, mx_uint *out_type_size,
                       const int **out_type_data, mx_uint *aux_type_size,
                       const int **aux_type_data, int *complete) {
  ENTER();
  PyObject *k = keys ? StrTuple(num_args, keys) : PyTuple_New(0);
  PyObject *t = IntTuple(num_args, arg_type_data);
  PyObject *r =
      Call("symbol_infer_type", Py_BuildValue("(KNN)", Id(sym), k, t));
  if (!r) return -1;
  long done = PyLong_AsLong(PyTuple_GetItem(r, 0));
  bool ok = UnpackInts(PyTuple_GetItem(r, 1), 0, in_type_size,
                       in_type_data) &&
            UnpackInts(PyTuple_GetItem(r, 2), 1, out_type_size,
                       out_type_data) &&
            UnpackInts(PyTuple_GetItem(r, 3), 2, aux_type_size,
                       aux_type_data);
  Py_DECREF(r);
  if (!ok) {
    SetError("symbol_infer_type: malformed result");
    return -1;
  }
  *complete = static_cast<int>(done);
  return 0;
}

/* ---- Executor -------------------------------------------------------- */

int MXTExecutorFree(ExecutorHandle handle) { return MXTNDArrayFree(handle); }

int MXTExecutorPrint(ExecutorHandle handle, const char **out_str) {
  ENTER();
  return StrCall("executor_print", Py_BuildValue("(K)", Id(handle)),
                 out_str);
}

int MXTExecutorForward(ExecutorHandle handle, int is_train) {
  ENTER();
  return VoidCall("executor_forward",
                  Py_BuildValue("(Ki)", Id(handle), is_train));
}

int MXTExecutorBackward(ExecutorHandle handle, mx_uint len,
                        NDArrayHandle *head_grads) {
  ENTER();
  PyObject *hs = HandleTuple(len, head_grads);
  return VoidCall("executor_backward",
                  Py_BuildValue("(KN)", Id(handle), hs));
}

int MXTExecutorOutputs(ExecutorHandle handle, mx_uint *out_size,
                       NDArrayHandle **out) {
  ENTER();
  PyObject *r = Call("executor_outputs", Py_BuildValue("(K)", Id(handle)));
  if (!r) return -1;
  bool ok = UnpackHandles(r, out_size, out);
  Py_DECREF(r);
  if (!ok) {
    SetError("executor_outputs: malformed result");
    return -1;
  }
  return 0;
}

int MXTExecutorBind(SymbolHandle symbol_handle, int dev_type, int dev_id,
                    mx_uint len, NDArrayHandle *in_args,
                    NDArrayHandle *arg_grad_store, mx_uint *grad_req_type,
                    mx_uint aux_states_len, NDArrayHandle *aux_states,
                    ExecutorHandle *out) {
  ENTER();
  PyObject *args = HandleTuple(len, in_args);
  PyObject *grads = HandleTuple(len, arg_grad_store);
  PyObject *reqs = PyTuple_New(len);
  for (mx_uint i = 0; i < len; ++i)
    PyTuple_SetItem(reqs, i, PyLong_FromUnsignedLong(
                                 grad_req_type ? grad_req_type[i] : 1));
  PyObject *aux = HandleTuple(aux_states_len, aux_states);
  return HandleCall("executor_bind",
                    Py_BuildValue("(KiiNNNN)", Id(symbol_handle), dev_type,
                                  dev_id, args, grads, reqs, aux),
                    out);
}

/* ---- DataIter -------------------------------------------------------- */

int MXTListDataIters(mx_uint *out_size, DataIterCreator **out_array) {
  ENTER();
  PyObject *r = Call("list_data_iters", PyTuple_New(0));
  if (!r) return -1;
  Scratch *s = TLS();
  s->handles.clear();
  Py_ssize_t n = PySequence_Size(r);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *it = PySequence_GetItem(r, i);
    const char *c = PyUnicode_AsUTF8(it);
    s->handles.push_back(const_cast<char *>(Intern(c ? c : "")));
    Py_XDECREF(it);
  }
  Py_DECREF(r);
  *out_size = static_cast<mx_uint>(n);
  *out_array = s->handles.data();
  return 0;
}

int MXTDataIterGetIterInfo(DataIterCreator creator, const char **name,
                           const char **description, mx_uint *num_args,
                           const char ***arg_names,
                           const char ***arg_type_infos,
                           const char ***arg_descriptions) {
  *name = static_cast<const char *>(creator);
  *description = "";
  *num_args = 0;
  static const char *empty[] = {nullptr};
  *arg_names = empty;
  *arg_type_infos = empty;
  *arg_descriptions = empty;
  return 0;
}

int MXTDataIterCreateIter(DataIterCreator creator, mx_uint num_param,
                          const char **keys, const char **vals,
                          DataIterHandle *out) {
  ENTER();
  PyObject *k = StrTuple(num_param, keys);
  PyObject *v = StrTuple(num_param, vals);
  return HandleCall("data_iter_create",
                    Py_BuildValue("(sNN)",
                                  static_cast<const char *>(creator), k, v),
                    out);
}

int MXTDataIterFree(DataIterHandle handle) { return MXTNDArrayFree(handle); }

int MXTDataIterNext(DataIterHandle handle, int *out) {
  ENTER();
  PyObject *r = Call("data_iter_next", Py_BuildValue("(K)", Id(handle)));
  if (!r) return -1;
  *out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int MXTDataIterBeforeFirst(DataIterHandle handle) {
  ENTER();
  return VoidCall("data_iter_before_first", Py_BuildValue("(K)", Id(handle)));
}

int MXTDataIterGetData(DataIterHandle handle, NDArrayHandle *out) {
  ENTER();
  return HandleCall("data_iter_get_data", Py_BuildValue("(K)", Id(handle)),
                    out);
}

int MXTDataIterGetLabel(DataIterHandle handle, NDArrayHandle *out) {
  ENTER();
  return HandleCall("data_iter_get_label", Py_BuildValue("(K)", Id(handle)),
                    out);
}

int MXTDataIterGetIndex(DataIterHandle handle, uint64_t **out_index,
                        uint64_t *out_size) {
  ENTER();
  PyObject *r = Call("data_iter_get_index", Py_BuildValue("(K)", Id(handle)));
  if (!r) return -1;
  Scratch *s = TLS();
  s->index.clear();
  Py_ssize_t n = PySequence_Size(r);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *it = PySequence_GetItem(r, i);
    s->index.push_back(PyLong_AsUnsignedLongLong(it));
    Py_XDECREF(it);
  }
  Py_DECREF(r);
  *out_index = s->index.data();
  *out_size = static_cast<uint64_t>(n);
  return 0;
}

int MXTDataIterGetPadNum(DataIterHandle handle, int *pad) {
  ENTER();
  PyObject *r = Call("data_iter_get_pad", Py_BuildValue("(K)", Id(handle)));
  if (!r) return -1;
  *pad = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

/* ---- KVStore --------------------------------------------------------- */

int MXTKVStoreCreate(const char *type, KVStoreHandle *out) {
  ENTER();
  return HandleCall("kvstore_create", Py_BuildValue("(s)", type), out);
}

int MXTKVStoreFree(KVStoreHandle handle) { return MXTNDArrayFree(handle); }

static PyObject *KeyTuple(mx_uint num, const int *keys) {
  PyObject *t = PyTuple_New(num);
  for (mx_uint i = 0; i < num; ++i)
    PyTuple_SetItem(t, i, PyLong_FromLong(keys[i]));
  return t;
}

int MXTKVStoreInit(KVStoreHandle handle, mx_uint num, const int *keys,
                   NDArrayHandle *vals) {
  ENTER();
  PyObject *k = KeyTuple(num, keys);
  PyObject *v = HandleTuple(num, vals);
  return VoidCall("kvstore_init", Py_BuildValue("(KNN)", Id(handle), k, v));
}

int MXTKVStorePush(KVStoreHandle handle, mx_uint num, const int *keys,
                   NDArrayHandle *vals, int priority) {
  ENTER();
  PyObject *k = KeyTuple(num, keys);
  PyObject *v = HandleTuple(num, vals);
  return VoidCall("kvstore_push",
                  Py_BuildValue("(KNNi)", Id(handle), k, v, priority));
}

int MXTKVStorePull(KVStoreHandle handle, mx_uint num, const int *keys,
                   NDArrayHandle *vals, int priority) {
  ENTER();
  PyObject *k = KeyTuple(num, keys);
  PyObject *v = HandleTuple(num, vals);
  return VoidCall("kvstore_pull",
                  Py_BuildValue("(KNNi)", Id(handle), k, v, priority));
}

int MXTKVStoreSetUpdater(KVStoreHandle handle, MXTKVStoreUpdater *updater,
                         void *updater_handle) {
  ENTER();
  return VoidCall("kvstore_set_updater",
                  Py_BuildValue("(KKK)", Id(handle),
                                reinterpret_cast<uintptr_t>(updater),
                                reinterpret_cast<uintptr_t>(updater_handle)));
}

int MXTKVStoreGetType(KVStoreHandle handle, const char **type) {
  ENTER();
  return StrCall("kvstore_get_type", Py_BuildValue("(K)", Id(handle)), type);
}

int MXTKVStoreGetRank(KVStoreHandle handle, int *rank) {
  ENTER();
  PyObject *r = Call("kvstore_get_rank", Py_BuildValue("(K)", Id(handle)));
  if (!r) return -1;
  *rank = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int MXTKVStoreGetGroupSize(KVStoreHandle handle, int *size) {
  ENTER();
  PyObject *r =
      Call("kvstore_get_group_size", Py_BuildValue("(K)", Id(handle)));
  if (!r) return -1;
  *size = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

/* role predicates: from DMLC_ROLE like the reference
 * (include/mxnet/kvstore.h:154-178) */
static int RoleIs(const char *role) {
  const char *r = getenv("DMLC_ROLE");
  if (!r) return strcmp(role, "worker") == 0;
  return strcmp(r, role) == 0;
}

int MXTKVStoreIsWorkerNode(int *ret) {
  *ret = RoleIs("worker");
  return 0;
}

int MXTKVStoreIsServerNode(int *ret) {
  *ret = RoleIs("server");
  return 0;
}

int MXTKVStoreIsSchedulerNode(int *ret) {
  *ret = RoleIs("scheduler");
  return 0;
}

int MXTKVStoreBarrier(KVStoreHandle handle) {
  ENTER();
  return VoidCall("kvstore_barrier", Py_BuildValue("(K)", Id(handle)));
}

int MXTKVStoreSendCommmandToServers(KVStoreHandle handle, int cmd_id,
                                    const char *cmd_body) {
  ENTER();
  return VoidCall("kvstore_send_command",
                  Py_BuildValue("(Kis)", Id(handle), cmd_id, cmd_body));
}

}  // extern "C"
