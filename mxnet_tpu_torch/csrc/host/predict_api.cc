// Adapted from src/predict_api.cc: serves through mxnet_tpu_torch.predictor and honours dev_type.
//
// C predict ABI: the reference's c_predict_api.h surface (include/mxnet/
// c_predict_api.h:1-210, src/c_api/c_predict_api.cc), declared by
// include/mxtpu/c_predict_api.h, over the port's
// mxnet_tpu_torch.predictor.Predictor. The library embeds CPython (or adopts
// a Python host's interpreter) and exposes the stable C symbols an
// application or another language binding links against. Every entry point
// is GIL-correct and usable from any thread. MXPredCreate's dev_type is
// honoured: 1 the CPU, 2 the CUDA card (an error naming CUDA when there is
// none; never a CPU fallback).
//
// Build (mxnet_tpu_torch/_native_build.py): g++ -std=c++17 -O2 -shared -fPIC
//   predict_api.cc $(python3-config --includes) -o libmxtpu_predict.so
//   $(python3-config --ldflags --embed)
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include "embed_runtime.h"

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

typedef void* PredictorHandle;
typedef uint32_t mx_uint;

namespace {

std::mutex g_init_mu;
thread_local std::string g_last_error;

struct Pred {
  PyObject* predictor = nullptr;   // mxnet_tpu_torch.predictor.Predictor
  PyObject* staged = nullptr;      // dict of inputs set via MXPredSetInput
  // creation arguments, retained so MXPredReshape can build an INDEPENDENT
  // predictor (a shared one would mutate under the old handle)
  PyObject* symbol_json = nullptr;
  PyObject* param_bytes = nullptr;
  PyObject* output_names = nullptr;
  PyObject* ctx = nullptr;         // the Context dev_type/dev_id named
  // one cached fetch: GetOutputShape-then-GetOutput is the canonical call
  // sequence and must not copy device->host twice
  long cached_index = -1;
  std::vector<mx_uint> out_shape;
  std::vector<float> out_data;
};

PyObject* np_module() {
  static PyObject* np = nullptr;  // borrowed forever (interned)
  if (!np) np = PyImport_ImportModule("numpy");
  return np;
}

// Fetch output `index` into the handle's cache (caller holds the GIL).
int fetch_output(Pred* p, mx_uint index) {
  if (p->cached_index == static_cast<long>(index)) return 0;
  PyObject* out = PyObject_CallMethod(p->predictor, "get_output", "I", index);
  if (!out) return -1;
  PyObject* np = np_module();
  PyObject* flat = np ? PyObject_CallMethod(
      np, "ascontiguousarray", "Os", out, "float32") : nullptr;
  PyObject* shp = PyObject_GetAttrString(out, "shape");
  Py_DECREF(out);
  if (!flat || !shp) {
    Py_XDECREF(flat);
    Py_XDECREF(shp);
    return -1;
  }
  p->out_shape.clear();
  for (Py_ssize_t i = 0; i < PyTuple_Size(shp); ++i)
    p->out_shape.push_back(static_cast<mx_uint>(
        PyLong_AsUnsignedLong(PyTuple_GET_ITEM(shp, i))));
  Py_DECREF(shp);
  Py_buffer view;
  if (PyObject_GetBuffer(flat, &view, PyBUF_CONTIG_RO) != 0) {
    Py_DECREF(flat);
    return -1;
  }
  p->out_data.resize(static_cast<size_t>(view.len) / sizeof(float));
  memcpy(p->out_data.data(), view.buf, view.len);
  PyBuffer_Release(&view);
  Py_DECREF(flat);
  p->cached_index = static_cast<long>(index);
  return 0;
}


void ensure_python() { mxtpu_embed::ensure_python(g_init_mu); }


struct Gil {
  PyGILState_STATE st;
  Gil() { st = PyGILState_Ensure(); }
  ~Gil() { PyGILState_Release(st); }
};

int fail_from_python() {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  PyObject* s = value ? PyObject_Str(value) : nullptr;
  const char* msg = (s && PyUnicode_Check(s)) ? PyUnicode_AsUTF8(s) : nullptr;
  if (!msg) {
    PyErr_Clear();  // PyUnicode_AsUTF8 may fail on unencodable text
    msg = "unknown python error";
  }
  g_last_error = msg;
  Py_XDECREF(s);
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return -1;
}

int fail(const std::string& msg) {
  g_last_error = msg;
  return -1;
}

// float32 C-order ndarray copy of `data` with the given shape
PyObject* make_array(const float* data, const std::vector<Py_ssize_t>& shape) {
  PyObject* np = np_module();
  if (!np) return nullptr;
  Py_ssize_t n = 1;
  for (auto d : shape) n *= d;
  PyObject* mem = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<float*>(data)),
      n * static_cast<Py_ssize_t>(sizeof(float)), PyBUF_READ);
  if (!mem) return nullptr;
  PyObject* flat = PyObject_CallMethod(np, "frombuffer", "Os", mem, "float32");
  Py_DECREF(mem);
  if (!flat) return nullptr;
  PyObject* shp = PyTuple_New(shape.size());
  for (size_t i = 0; i < shape.size(); ++i)
    PyTuple_SET_ITEM(shp, i, PyLong_FromSsize_t(shape[i]));
  PyObject* shaped = PyObject_CallMethod(flat, "reshape", "O", shp);
  Py_DECREF(flat);
  Py_DECREF(shp);
  if (!shaped) return nullptr;
  PyObject* owned = PyObject_CallMethod(shaped, "copy", nullptr);  // own memory
  Py_DECREF(shaped);
  return owned;
}

// The Context of (dev_type, dev_id): mxnet_tpu_torch.c_api.device_context,
// which raises (naming CUDA) for a card that is not there.
PyObject* device_context(int dev_type, int dev_id) {
  PyObject* mod = PyImport_ImportModule("mxnet_tpu_torch.c_api");
  if (!mod) return nullptr;
  PyObject* ctx = PyObject_CallMethod(mod, "device_context", "ii", dev_type,
                                      dev_id);
  Py_DECREF(mod);
  return ctx;
}

// Build a Predictor instance from (json, params, shapes-dict, outputs, ctx).
PyObject* new_predictor(PyObject* json, PyObject* params, PyObject* shapes,
                        PyObject* output_names, PyObject* ctx) {
  PyObject* mod = PyImport_ImportModule("mxnet_tpu_torch.predictor");
  if (!mod) return nullptr;
  PyObject* cls = PyObject_GetAttrString(mod, "Predictor");
  Py_DECREF(mod);
  if (!cls) return nullptr;
  PyObject* kwargs = PyDict_New();
  PyDict_SetItemString(kwargs, "output_names", output_names);
  PyDict_SetItemString(kwargs, "ctx", ctx);
  PyObject* args = Py_BuildValue("(OOO)", json, params, shapes);
  PyObject* predictor = PyObject_Call(cls, args, kwargs);
  Py_DECREF(args);
  Py_DECREF(kwargs);
  Py_DECREF(cls);
  return predictor;
}

int create_impl(const char* symbol_json_str, const void* param_bytes,
                int param_size, int dev_type, int dev_id,
                mx_uint num_input_nodes,
                const char** input_keys, const mx_uint* input_shape_indptr,
                const mx_uint* input_shape_data, mx_uint num_output_nodes,
                const char** output_keys, PredictorHandle* out) {
  ensure_python();
  Gil gil;
  PyObject* ctx = device_context(dev_type, dev_id);
  if (!ctx) return fail_from_python();
  PyObject* shapes = PyDict_New();
  for (mx_uint i = 0; i < num_input_nodes; ++i) {
    PyObject* tup = PyTuple_New(input_shape_indptr[i + 1] -
                                input_shape_indptr[i]);
    for (mx_uint j = input_shape_indptr[i], k = 0;
         j < input_shape_indptr[i + 1]; ++j, ++k)
      PyTuple_SET_ITEM(tup, k, PyLong_FromUnsignedLong(input_shape_data[j]));
    PyDict_SetItemString(shapes, input_keys[i], tup);
    Py_DECREF(tup);
  }
  PyObject* params = PyBytes_FromStringAndSize(
      static_cast<const char*>(param_bytes), param_size);
  PyObject* outputs = Py_None;
  Py_INCREF(Py_None);
  if (num_output_nodes > 0) {
    Py_DECREF(outputs);
    outputs = PyList_New(num_output_nodes);
    for (mx_uint i = 0; i < num_output_nodes; ++i)
      PyList_SET_ITEM(outputs, i, PyUnicode_FromString(output_keys[i]));
  }
  PyObject* json = PyUnicode_FromString(symbol_json_str);
  PyObject* predictor = new_predictor(json, params, shapes, outputs, ctx);
  Py_DECREF(shapes);
  if (!predictor) {
    Py_DECREF(json);
    Py_DECREF(params);
    Py_DECREF(outputs);
    Py_DECREF(ctx);
    return fail_from_python();
  }

  auto* p = new Pred();
  p->predictor = predictor;
  p->staged = PyDict_New();
  p->symbol_json = json;        // retained for MXPredReshape
  p->param_bytes = params;
  p->output_names = outputs;
  p->ctx = ctx;
  *out = p;
  mxtpu_embed::ensure_exit_guard();  // torch dlopens its CUDA libraries lazily
  return 0;
}

}  // namespace

extern "C" {

const char* MXGetLastError() { return g_last_error.c_str(); }

int MXPredCreate(const char* symbol_json_str, const void* param_bytes,
                 int param_size, int dev_type, int dev_id,
                 mx_uint num_input_nodes, const char** input_keys,
                 const mx_uint* input_shape_indptr,
                 const mx_uint* input_shape_data, PredictorHandle* out) {
  return create_impl(symbol_json_str, param_bytes, param_size, dev_type,
                     dev_id, num_input_nodes, input_keys, input_shape_indptr,
                     input_shape_data, 0, nullptr, out);
}

int MXPredCreatePartialOut(const char* symbol_json_str,
                           const void* param_bytes, int param_size,
                           int dev_type, int dev_id,
                           mx_uint num_input_nodes, const char** input_keys,
                           const mx_uint* input_shape_indptr,
                           const mx_uint* input_shape_data,
                           mx_uint num_output_nodes,
                           const char** output_keys, PredictorHandle* out) {
  return create_impl(symbol_json_str, param_bytes, param_size, dev_type,
                     dev_id, num_input_nodes, input_keys, input_shape_indptr,
                     input_shape_data, num_output_nodes, output_keys, out);
}

int MXPredSetInput(PredictorHandle handle, const char* key,
                   const float* data, mx_uint size) {
  auto* p = static_cast<Pred*>(handle);
  if (!p) return fail("null handle");
  Gil gil;
  // shape comes from the predictor's bound input spec; the flat size must
  // match it (the reference's contract: shape fixed at create time)
  PyObject* shapes = PyObject_GetAttrString(p->predictor, "input_shapes");
  if (!shapes) return fail_from_python();
  PyObject* shp = PyDict_GetItemString(shapes, key);  // borrowed
  if (!shp) {
    Py_DECREF(shapes);
    return fail(std::string("unknown input key: ") + key);
  }
  std::vector<Py_ssize_t> dims;
  Py_ssize_t want = 1;
  for (Py_ssize_t i = 0; i < PySequence_Length(shp); ++i) {
    PyObject* d = PySequence_GetItem(shp, i);
    dims.push_back(PyLong_AsSsize_t(d));
    want *= dims.back();
    Py_DECREF(d);
  }
  Py_DECREF(shapes);
  if (want != static_cast<Py_ssize_t>(size))
    return fail("MXPredSetInput: size mismatch for '" + std::string(key) +
                "'");
  PyObject* arr = make_array(data, dims);
  if (!arr) return fail_from_python();
  PyDict_SetItemString(p->staged, key, arr);
  Py_DECREF(arr);
  return 0;
}

int MXPredForward(PredictorHandle handle) {
  auto* p = static_cast<Pred*>(handle);
  if (!p) return fail("null handle");
  Gil gil;
  PyObject* fwd = PyObject_GetAttrString(p->predictor, "forward");
  if (!fwd) return fail_from_python();
  PyObject* empty = PyTuple_New(0);
  PyObject* r = PyObject_Call(fwd, empty, p->staged);
  Py_DECREF(empty);
  Py_DECREF(fwd);
  if (!r) return fail_from_python();
  Py_DECREF(r);
  p->cached_index = -1;  // new forward invalidates the output cache
  mxtpu_embed::ensure_exit_guard();  // a first convolution dlopens cuDNN
  return 0;
}

int MXPredGetOutputShape(PredictorHandle handle, mx_uint index,
                         mx_uint** shape_data, mx_uint* shape_ndim) {
  auto* p = static_cast<Pred*>(handle);
  if (!p) return fail("null handle");
  Gil gil;
  if (fetch_output(p, index) != 0) return fail_from_python();
  *shape_data = p->out_shape.data();
  *shape_ndim = static_cast<mx_uint>(p->out_shape.size());
  return 0;
}

int MXPredGetOutput(PredictorHandle handle, mx_uint index, float* data,
                    mx_uint size) {
  auto* p = static_cast<Pred*>(handle);
  if (!p) return fail("null handle");
  Gil gil;
  if (fetch_output(p, index) != 0) return fail_from_python();
  if (p->out_data.size() != size)
    return fail("MXPredGetOutput: caller buffer size mismatch");
  memcpy(data, p->out_data.data(), size * sizeof(float));
  return 0;
}

int MXPredReshape(PredictorHandle handle, mx_uint num_input_nodes,
                  const char** input_keys, const mx_uint* input_shape_indptr,
                  const mx_uint* input_shape_data, PredictorHandle* out) {
  auto* p = static_cast<Pred*>(handle);
  if (!p) return fail("null handle");
  Gil gil;
  PyObject* shapes = PyDict_New();
  for (mx_uint i = 0; i < num_input_nodes; ++i) {
    PyObject* tup = PyTuple_New(input_shape_indptr[i + 1] -
                                input_shape_indptr[i]);
    for (mx_uint j = input_shape_indptr[i], k = 0;
         j < input_shape_indptr[i + 1]; ++j, ++k)
      PyTuple_SET_ITEM(tup, k, PyLong_FromUnsignedLong(input_shape_data[j]));
    PyDict_SetItemString(shapes, input_keys[i], tup);
    Py_DECREF(tup);
  }
  // a fully INDEPENDENT predictor for the new shapes: sharing the old
  // Python object would mutate the old handle's executor underneath it
  PyObject* predictor = new_predictor(p->symbol_json, p->param_bytes,
                                      shapes, p->output_names, p->ctx);
  Py_DECREF(shapes);
  if (!predictor) return fail_from_python();
  auto* q = new Pred();
  q->predictor = predictor;
  q->staged = PyDict_New();
  q->symbol_json = p->symbol_json;
  Py_INCREF(q->symbol_json);
  q->param_bytes = p->param_bytes;
  Py_INCREF(q->param_bytes);
  q->output_names = p->output_names;
  Py_INCREF(q->output_names);
  q->ctx = p->ctx;
  Py_INCREF(q->ctx);
  *out = q;
  return 0;
}

int MXPredFree(PredictorHandle handle) {
  auto* p = static_cast<Pred*>(handle);
  if (!p) return 0;
  {
    Gil gil;
    Py_XDECREF(p->predictor);
    Py_XDECREF(p->staged);
    Py_XDECREF(p->symbol_json);
    Py_XDECREF(p->param_bytes);
    Py_XDECREF(p->output_names);
    Py_XDECREF(p->ctx);
  }
  delete p;
  mxtpu_embed::quiesce();
  mxtpu_embed::ensure_exit_guard();
  return 0;
}

}  // extern "C"
