/*!
 * Native C predict ABI over an embedded CPython runtime.
 *
 * Reference parity: src/c_api/c_predict_api.cc (predictor creation from
 * symbol JSON + param blob, input staging, forward, output fetch) and its
 * per-thread ring-buffered error string (src/c_api/c_api_error.cc).
 *
 * Design: the reference's predict path strips the engine to a naive
 * executor under MXNET_PREDICT_ONLY; here the whole compiled path lives
 * behind Python (torch and the port's kernels, or the numpy amalgamation
 * interpreter when MXNET_TPU_PREDICT_NUMPY=1), so this file embeds the
 * interpreter once per process and marshals through
 * mxnet_tpu_torch.c_predict with plain str/bytes/tuple types only — no
 * numpy/torch C coupling. Built by mxnet_tpu_torch/capi/__init__.py,
 * which defines MXT_PYTHON (the interpreter) and MXT_ROOT (the repo).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "c_predict_api.h"

namespace {

thread_local std::string g_last_error;

void SetError(const std::string &msg) { g_last_error = msg; }

/* capture the pending Python exception into the thread-local error */
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
PyObject *g_module = nullptr;  // mxnet_tpu_torch.c_predict, borrowed forever

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

/* RAII GIL holder: every ABI entry point runs under this */
class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

bool EnsureModule() {
  if (g_module) return true;
  PyObject *m = PyImport_ImportModule("mxnet_tpu_torch.c_predict");
  if (!m) {
    SetErrorFromPython();
    return false;
  }
  g_module = m;  // keep alive for process lifetime
  return true;
}

struct Predictor {
  PyObject *handle;                   // _CPredictor instance
  std::vector<mx_uint> shape_buf;     // backs MXTPredGetOutputShape
};

PyObject *Call(const char *fn, PyObject *args) {
  PyObject *f = PyObject_GetAttrString(g_module, fn);
  if (!f) return nullptr;
  PyObject *r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  return r;
}

}  // namespace

extern "C" {

const char *MXTPredGetLastError(void) { return g_last_error.c_str(); }

int MXTPredCreate(const char *symbol_json_str, const void *param_bytes,
                  int param_size, int dev_type, int dev_id,
                  mx_uint num_input_nodes, const char **input_keys,
                  const mx_uint *input_shape_indptr,
                  const mx_uint *input_shape_data, PredictorHandle *out) {
  EnsureRuntime();
  Gil gil;
  if (!EnsureModule()) return -1;
  PyObject *names = PyList_New(num_input_nodes);
  PyObject *shapes = PyList_New(num_input_nodes);
  for (mx_uint i = 0; i < num_input_nodes; ++i) {
    PyList_SetItem(names, i, PyUnicode_FromString(input_keys[i]));
    mx_uint lo = input_shape_indptr[i], hi = input_shape_indptr[i + 1];
    PyObject *shp = PyTuple_New(hi - lo);
    for (mx_uint j = lo; j < hi; ++j)
      PyTuple_SetItem(shp, j - lo, PyLong_FromUnsignedLong(
                                       input_shape_data[j]));
    PyList_SetItem(shapes, i, shp);
  }
  const char *dev = (dev_type == 2) ? "gpu" : "cpu";
  PyObject *args = Py_BuildValue(
      "(sy#OOsi)", symbol_json_str, static_cast<const char *>(param_bytes),
      static_cast<Py_ssize_t>(param_size), names, shapes, dev, dev_id);
  Py_DECREF(names);
  Py_DECREF(shapes);
  if (!args) {
    SetErrorFromPython();
    return -1;
  }
  PyObject *h = Call("create", args);
  Py_DECREF(args);
  if (!h) {
    SetErrorFromPython();
    return -1;
  }
  Predictor *p = new Predictor{h, {}};
  *out = p;
  return 0;
}

int MXTPredCreatePartialOut(const char *symbol_json_str,
                            const void *param_bytes, int param_size,
                            int dev_type, int dev_id,
                            mx_uint num_input_nodes,
                            const char **input_keys,
                            const mx_uint *input_shape_indptr,
                            const mx_uint *input_shape_data,
                            mx_uint num_output_nodes,
                            const char **output_keys,
                            PredictorHandle *out) {
  EnsureRuntime();
  Gil gil;
  if (!EnsureModule()) return -1;
  PyObject *names = PyList_New(num_input_nodes);
  PyObject *shapes = PyList_New(num_input_nodes);
  for (mx_uint i = 0; i < num_input_nodes; ++i) {
    PyList_SetItem(names, i, PyUnicode_FromString(input_keys[i]));
    mx_uint lo = input_shape_indptr[i], hi = input_shape_indptr[i + 1];
    PyObject *shp = PyTuple_New(hi - lo);
    for (mx_uint j = lo; j < hi; ++j)
      PyTuple_SetItem(shp, j - lo, PyLong_FromUnsignedLong(
                                       input_shape_data[j]));
    PyList_SetItem(shapes, i, shp);
  }
  PyObject *outs = PyList_New(num_output_nodes);
  for (mx_uint i = 0; i < num_output_nodes; ++i)
    PyList_SetItem(outs, i, PyUnicode_FromString(output_keys[i]));
  const char *dev = (dev_type == 2) ? "gpu" : "cpu";
  PyObject *args = Py_BuildValue(
      "(sy#OOsiO)", symbol_json_str,
      static_cast<const char *>(param_bytes),
      static_cast<Py_ssize_t>(param_size), names, shapes, dev, dev_id,
      outs);
  Py_DECREF(names);
  Py_DECREF(shapes);
  Py_DECREF(outs);
  if (!args) {
    SetErrorFromPython();
    return -1;
  }
  PyObject *h = Call("create_partial_out", args);
  Py_DECREF(args);
  if (!h) {
    SetErrorFromPython();
    return -1;
  }
  Predictor *p = new Predictor{h, {}};
  *out = p;
  return 0;
}

int MXTPredSetInput(PredictorHandle handle, const char *key,
                    const mx_float *data, mx_uint size) {
  Gil gil;
  Predictor *p = static_cast<Predictor *>(handle);
  PyObject *args = Py_BuildValue(
      "(Osy#)", p->handle, key, reinterpret_cast<const char *>(data),
      static_cast<Py_ssize_t>(size * sizeof(mx_float)));
  if (!args) {
    SetErrorFromPython();
    return -1;
  }
  PyObject *r = Call("set_input", args);
  Py_DECREF(args);
  if (!r) {
    SetErrorFromPython();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int MXTPredForward(PredictorHandle handle) {
  Gil gil;
  Predictor *p = static_cast<Predictor *>(handle);
  PyObject *args = Py_BuildValue("(O)", p->handle);
  PyObject *r = Call("forward", args);
  Py_DECREF(args);
  if (!r) {
    SetErrorFromPython();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int MXTPredNumOutputs(PredictorHandle handle, mx_uint *out) {
  Gil gil;
  Predictor *p = static_cast<Predictor *>(handle);
  PyObject *args = Py_BuildValue("(O)", p->handle);
  PyObject *r = Call("num_outputs", args);
  Py_DECREF(args);
  if (!r) {
    SetErrorFromPython();
    return -1;
  }
  *out = static_cast<mx_uint>(PyLong_AsUnsignedLong(r));
  Py_DECREF(r);
  return 0;
}

int MXTPredGetOutputShape(PredictorHandle handle, mx_uint index,
                          mx_uint **shape_data, mx_uint *shape_ndim) {
  Gil gil;
  Predictor *p = static_cast<Predictor *>(handle);
  PyObject *args = Py_BuildValue("(OI)", p->handle, index);
  PyObject *r = Call("get_output_shape", args);
  Py_DECREF(args);
  if (!r) {
    SetErrorFromPython();
    return -1;
  }
  Py_ssize_t n = PyTuple_Size(r);
  p->shape_buf.resize(n);
  for (Py_ssize_t i = 0; i < n; ++i)
    p->shape_buf[i] = static_cast<mx_uint>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(r, i)));
  Py_DECREF(r);
  *shape_data = p->shape_buf.data();
  *shape_ndim = static_cast<mx_uint>(n);
  return 0;
}

int MXTPredGetOutput(PredictorHandle handle, mx_uint index, mx_float *data,
                     mx_uint size) {
  Gil gil;
  Predictor *p = static_cast<Predictor *>(handle);
  PyObject *args = Py_BuildValue("(OI)", p->handle, index);
  PyObject *r = Call("get_output", args);
  Py_DECREF(args);
  if (!r) {
    SetErrorFromPython();
    return -1;
  }
  char *buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(r, &buf, &len) != 0) {
    Py_DECREF(r);
    SetErrorFromPython();
    return -1;
  }
  if (static_cast<mx_uint>(len) != size * sizeof(mx_float)) {
    Py_DECREF(r);
    SetError("MXTPredGetOutput: size mismatch");
    return -1;
  }
  std::memcpy(data, buf, len);
  Py_DECREF(r);
  return 0;
}

int MXTPredFree(PredictorHandle handle) {
  Gil gil;
  Predictor *p = static_cast<Predictor *>(handle);
  Py_XDECREF(p->handle);
  delete p;
  return 0;
}

}  // extern "C"
