// Adapted from src/c_api.cc: calls into mxnet_tpu_torch.c_api and honours dev_type.
//
// Training-side C ABI: the minimal imperative slice of the reference's
// include/mxnet/c_api.h (NDArray CRUD, MXImperativeInvoke
// [src/c_api/c_api_ndarray.cc:322], executor bind/forward/backward, KVStore
// init/push/pull) over the mxnet_tpu_torch package, declared by
// include/mxtpu/c_api.h. The library embeds CPython (or adopts the
// interpreter of a Python host that loaded it): the interpreter takes the
// place of the reference's static graph-executor library, and every entry
// point is GIL-correct from any thread. MXNDArrayCreate's dev_type is
// honoured: 1 the CPU, 2 the CUDA card (an error naming CUDA when there is
// none); an executor binds on the default context.
//
// Build (mxnet_tpu_torch/_native_build.py): g++ -std=c++17 -O2 -shared -fPIC
//   c_api.cc $(python3-config --includes) -o libmxtpu_c.so
//   $(python3-config --ldflags --embed)
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include "embed_runtime.h"

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

typedef uint32_t mx_uint;
typedef void* NDArrayHandle;
typedef void* ExecutorHandle;
typedef void* KVStoreHandle;

namespace {

std::mutex g_init_mu;
thread_local std::string g_last_error;
// storage for handle arrays returned by MXImperativeInvokeByName
thread_local std::vector<NDArrayHandle> g_invoke_outs;


void ensure_python() { mxtpu_embed::ensure_python(g_init_mu); }


struct Gil {
  PyGILState_STATE st;
  Gil() { st = PyGILState_Ensure(); }
  ~Gil() { PyGILState_Release(st); }
};

int fail(const std::string& msg) {
  g_last_error = msg;
  return -1;
}

int fail_from_python() {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  PyObject* s = value ? PyObject_Str(value) : nullptr;
  const char* msg = (s && PyUnicode_Check(s)) ? PyUnicode_AsUTF8(s) : nullptr;
  if (!msg) {
    PyErr_Clear();
    msg = "unknown python error";
  }
  g_last_error = msg;
  Py_XDECREF(s);
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return -1;
}

// the python-side glue lives in mxnet_tpu_torch.c_api (bind_from_json, invoke)
PyObject* glue() {
  static PyObject* mod = nullptr;  // borrowed forever
  if (!mod) mod = PyImport_ImportModule("mxnet_tpu_torch.c_api");
  return mod;
}

// An NDArrayHandle owns one reference to a mxnet_tpu_torch NDArray plus a cached
// shape for MXNDArrayGetShape's borrowed-pointer contract.
struct ND {
  PyObject* arr = nullptr;
  std::vector<mx_uint> shape;
};

ND* wrap(PyObject* arr /* stolen */) {
  auto* h = new ND();
  h->arr = arr;
  return h;
}

int cache_shape(ND* h) {
  PyObject* shp = PyObject_GetAttrString(h->arr, "shape");
  if (!shp) return fail_from_python();
  h->shape.clear();
  for (Py_ssize_t i = 0; i < PyTuple_Size(shp); ++i)
    h->shape.push_back(static_cast<mx_uint>(
        PyLong_AsUnsignedLong(PyTuple_GET_ITEM(shp, i))));
  Py_DECREF(shp);
  return 0;
}

// float32 contiguous view of an NDArray's host copy -> memcpy into data
int copy_to_host(PyObject* arr, float* data, size_t size) {
  PyObject* np_arr = PyObject_CallMethod(arr, "asnumpy", nullptr);
  if (!np_arr) return fail_from_python();
  PyObject* np = PyImport_ImportModule("numpy");
  PyObject* flat = np ? PyObject_CallMethod(np, "ascontiguousarray", "Os",
                                            np_arr, "float32")
                      : nullptr;
  Py_DECREF(np_arr);
  Py_XDECREF(np);
  if (!flat) return fail_from_python();
  Py_buffer view;
  if (PyObject_GetBuffer(flat, &view, PyBUF_CONTIG_RO) != 0) {
    Py_DECREF(flat);
    return fail_from_python();
  }
  int rc = 0;
  if (static_cast<size_t>(view.len) != size * sizeof(float))
    rc = fail("MXNDArraySyncCopyToCPU: caller buffer size mismatch");
  else
    memcpy(data, view.buf, view.len);
  PyBuffer_Release(&view);
  Py_DECREF(flat);
  return rc;
}

struct Exec {
  PyObject* ex = nullptr;         // mxnet_tpu_torch Executor
  PyObject* arg_names = nullptr;  // list[str], pinned for ListArguments
  std::vector<const char*> name_ptrs;
};

struct KV {
  PyObject* kv = nullptr;
};

PyObject* handles_to_list(int n, NDArrayHandle* hs) {
  PyObject* lst = PyList_New(n);
  for (int i = 0; i < n; ++i) {
    PyObject* a = static_cast<ND*>(hs[i])->arr;
    Py_INCREF(a);
    PyList_SET_ITEM(lst, i, a);
  }
  return lst;
}

}  // namespace

extern "C" {

const char* MXGetLastError() { return g_last_error.c_str(); }

/* ---- NDArray ---------------------------------------------------------- */

int MXNDArrayCreate(const mx_uint* shape, mx_uint ndim, int dev_type,
                    int dev_id, int /*delay_alloc*/, NDArrayHandle* out) {
  ensure_python();
  Gil gil;
  PyObject* g = glue();
  if (!g) return fail_from_python();
  PyObject* shp = PyTuple_New(ndim);
  for (mx_uint i = 0; i < ndim; ++i)
    PyTuple_SET_ITEM(shp, i, PyLong_FromUnsignedLong(shape[i]));
  // 1 the CPU, 2 the card: the glue raises (naming CUDA) for a card that
  // is not there
  PyObject* arr = PyObject_CallMethod(g, "zeros", "Oii", shp, dev_type,
                                      dev_id);
  Py_DECREF(shp);
  if (!arr) return fail_from_python();
  *out = wrap(arr);
  return 0;
}

int MXNDArrayFree(NDArrayHandle handle) {
  auto* h = static_cast<ND*>(handle);
  if (!h) return 0;
  {
    Gil gil;
    Py_XDECREF(h->arr);
  }
  delete h;
  return 0;
}

int MXNDArraySyncCopyFromCPU(NDArrayHandle handle, const float* data,
                             size_t size) {
  auto* h = static_cast<ND*>(handle);
  if (!h) return fail("null handle");
  Gil gil;
  PyObject* mem = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<float*>(data)),
      static_cast<Py_ssize_t>(size * sizeof(float)), PyBUF_READ);
  if (!mem) return fail_from_python();
  PyObject* r = PyObject_CallMethod(glue(), "copy_from_host", "OO",
                                    h->arr, mem);
  Py_DECREF(mem);
  if (!r) return fail_from_python();
  Py_DECREF(r);
  return 0;
}

int MXNDArraySyncCopyToCPU(NDArrayHandle handle, float* data, size_t size) {
  auto* h = static_cast<ND*>(handle);
  if (!h) return fail("null handle");
  Gil gil;
  return copy_to_host(h->arr, data, size);
}

int MXNDArrayGetShape(NDArrayHandle handle, mx_uint* out_dim,
                      const mx_uint** out_pdata) {
  auto* h = static_cast<ND*>(handle);
  if (!h) return fail("null handle");
  Gil gil;
  if (cache_shape(h) != 0) return -1;
  *out_dim = static_cast<mx_uint>(h->shape.size());
  *out_pdata = h->shape.data();
  return 0;
}

int MXNDArrayWaitAll() {
  ensure_python();
  Gil gil;
  PyObject* r = PyObject_CallMethod(glue(), "waitall", nullptr);
  if (!r) return fail_from_python();
  Py_DECREF(r);
  return 0;
}

/* ---- Imperative invoke ------------------------------------------------ */

int MXImperativeInvokeByName(const char* op_name, int num_inputs,
                             NDArrayHandle* inputs, int* num_outputs,
                             NDArrayHandle** outputs, int num_params,
                             const char** param_keys,
                             const char** param_vals) {
  ensure_python();
  Gil gil;
  PyObject* ins = handles_to_list(num_inputs, inputs);
  PyObject* outs = Py_None;
  Py_INCREF(Py_None);
  if (*num_outputs > 0) {
    Py_DECREF(outs);
    outs = handles_to_list(*num_outputs, *outputs);
  }
  PyObject* keys = PyList_New(num_params);
  PyObject* vals = PyList_New(num_params);
  for (int i = 0; i < num_params; ++i) {
    PyList_SET_ITEM(keys, i, PyUnicode_FromString(param_keys[i]));
    PyList_SET_ITEM(vals, i, PyUnicode_FromString(param_vals[i]));
  }
  PyObject* res = PyObject_CallMethod(glue(), "invoke", "sOOOO", op_name,
                                      ins, keys, vals, outs);
  Py_DECREF(ins);
  Py_DECREF(keys);
  Py_DECREF(vals);
  Py_DECREF(outs);
  if (!res) return fail_from_python();
  if (*num_outputs > 0) {
    // in-place: the caller's arrays were written through out=
    Py_DECREF(res);
    return 0;
  }
  Py_ssize_t n = PyList_Size(res);
  g_invoke_outs.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* a = PyList_GET_ITEM(res, i);
    Py_INCREF(a);
    g_invoke_outs.push_back(wrap(a));
  }
  Py_DECREF(res);
  *num_outputs = static_cast<int>(n);
  *outputs = g_invoke_outs.data();
  return 0;
}

/* ---- Executor --------------------------------------------------------- */

int MXTrainExecutorCreate(const char* symbol_json, mx_uint num_inputs,
                          const char** input_keys,
                          const mx_uint* input_shape_indptr,
                          const mx_uint* input_shape_data,
                          ExecutorHandle* out) {
  ensure_python();
  Gil gil;
  PyObject* g = glue();
  if (!g) return fail_from_python();
  PyObject* shapes = PyDict_New();
  for (mx_uint i = 0; i < num_inputs; ++i) {
    PyObject* tup = PyTuple_New(input_shape_indptr[i + 1] -
                                input_shape_indptr[i]);
    for (mx_uint j = input_shape_indptr[i], k = 0;
         j < input_shape_indptr[i + 1]; ++j, ++k)
      PyTuple_SET_ITEM(tup, k, PyLong_FromUnsignedLong(input_shape_data[j]));
    PyDict_SetItemString(shapes, input_keys[i], tup);
    Py_DECREF(tup);
  }
  PyObject* ex = PyObject_CallMethod(g, "bind_from_json", "sO", symbol_json,
                                     shapes);
  Py_DECREF(shapes);
  if (!ex) return fail_from_python();
  auto* h = new Exec();
  h->ex = ex;
  *out = h;
  mxtpu_embed::ensure_exit_guard();  // torch dlopens its CUDA libraries lazily
  return 0;
}

int MXExecutorForward(ExecutorHandle handle, int is_train) {
  auto* h = static_cast<Exec*>(handle);
  if (!h) return fail("null handle");
  {
    Gil gil;
    PyObject* r = PyObject_CallMethod(h->ex, "forward", "i", is_train);
    if (!r) return fail_from_python();
    Py_DECREF(r);
  }
  mxtpu_embed::ensure_exit_guard();  // a first convolution dlopens cuDNN
  return 0;
}

int MXExecutorBackward(ExecutorHandle handle, mx_uint num_head,
                       NDArrayHandle* head_grads) {
  auto* h = static_cast<Exec*>(handle);
  if (!h) return fail("null handle");
  Gil gil;
  PyObject* r;
  if (num_head == 0 || head_grads == nullptr) {
    r = PyObject_CallMethod(h->ex, "backward", nullptr);
  } else {
    PyObject* lst = handles_to_list(static_cast<int>(num_head), head_grads);
    r = PyObject_CallMethod(h->ex, "backward", "O", lst);
    Py_DECREF(lst);
  }
  if (!r) return fail_from_python();
  Py_DECREF(r);
  return 0;
}

int MXExecutorNumOutputs(ExecutorHandle handle, int* out) {
  auto* h = static_cast<Exec*>(handle);
  if (!h) return fail("null handle");
  Gil gil;
  PyObject* outs = PyObject_GetAttrString(h->ex, "outputs");
  if (!outs) return fail_from_python();
  *out = static_cast<int>(PySequence_Length(outs));
  Py_DECREF(outs);
  return 0;
}

int MXExecutorGetOutput(ExecutorHandle handle, mx_uint index,
                        NDArrayHandle* out) {
  auto* h = static_cast<Exec*>(handle);
  if (!h) return fail("null handle");
  Gil gil;
  PyObject* outs = PyObject_GetAttrString(h->ex, "outputs");
  if (!outs) return fail_from_python();
  PyObject* a = PySequence_GetItem(outs, index);  // new ref
  Py_DECREF(outs);
  if (!a) return fail_from_python();
  *out = wrap(a);
  return 0;
}

int MXExecutorListArguments(ExecutorHandle handle, mx_uint* out_size,
                            const char*** out_names) {
  auto* h = static_cast<Exec*>(handle);
  if (!h) return fail("null handle");
  Gil gil;
  if (!h->arg_names) {
    h->arg_names = PyObject_CallMethod(glue(), "arg_names", "O", h->ex);
    if (!h->arg_names) return fail_from_python();
    h->name_ptrs.clear();
    for (Py_ssize_t i = 0; i < PyList_Size(h->arg_names); ++i)
      h->name_ptrs.push_back(
          PyUnicode_AsUTF8(PyList_GET_ITEM(h->arg_names, i)));
  }
  *out_size = static_cast<mx_uint>(h->name_ptrs.size());
  *out_names = h->name_ptrs.data();
  return 0;
}

static int get_from_dict(Exec* h, const char* method, const char* name,
                         NDArrayHandle* out) {
  PyObject* a = PyObject_CallMethod(glue(), method, "Os", h->ex, name);
  if (!a) return fail_from_python();
  if (a == Py_None) {  // e.g. grad of a no-grad input
    Py_DECREF(a);
    *out = nullptr;
    return 0;
  }
  *out = wrap(a);
  return 0;
}

int MXExecutorGetArg(ExecutorHandle handle, const char* name,
                     NDArrayHandle* out) {
  auto* h = static_cast<Exec*>(handle);
  if (!h) return fail("null handle");
  Gil gil;
  return get_from_dict(h, "get_arg", name, out);
}

int MXExecutorGetGrad(ExecutorHandle handle, const char* name,
                      NDArrayHandle* out) {
  auto* h = static_cast<Exec*>(handle);
  if (!h) return fail("null handle");
  Gil gil;
  return get_from_dict(h, "get_grad", name, out);
}

int MXExecutorFree(ExecutorHandle handle) {
  auto* h = static_cast<Exec*>(handle);
  if (!h) return 0;
  {
    Gil gil;
    Py_XDECREF(h->ex);
    Py_XDECREF(h->arg_names);
  }
  delete h;
  mxtpu_embed::quiesce();
  mxtpu_embed::ensure_exit_guard();
  return 0;
}

/* ---- KVStore ---------------------------------------------------------- */

int MXKVStoreCreate(const char* type, KVStoreHandle* out) {
  ensure_python();
  Gil gil;
  PyObject* g = glue();
  if (!g) return fail_from_python();
  PyObject* kv = PyObject_CallMethod(g, "kv_create", "s", type);
  if (!kv) return fail_from_python();
  auto* h = new KV();
  h->kv = kv;
  *out = h;
  mxtpu_embed::ensure_exit_guard();
  return 0;
}

static int kv_call(KVStoreHandle handle, const char* method, mx_uint num,
                   const int* keys, NDArrayHandle* vals) {
  auto* h = static_cast<KV*>(handle);
  if (!h) return fail("null handle");
  Gil gil;
  PyObject* pykeys = PyList_New(num);
  for (mx_uint i = 0; i < num; ++i)
    PyList_SET_ITEM(pykeys, i, PyLong_FromLong(keys[i]));
  PyObject* pyvals = handles_to_list(static_cast<int>(num), vals);
  PyObject* r = PyObject_CallMethod(glue(), method, "OOO", h->kv, pykeys,
                                    pyvals);
  Py_DECREF(pykeys);
  Py_DECREF(pyvals);
  if (!r) return fail_from_python();
  Py_DECREF(r);
  return 0;
}

int MXKVStoreInit(KVStoreHandle handle, mx_uint num, const int* keys,
                  NDArrayHandle* vals) {
  return kv_call(handle, "kv_init", num, keys, vals);
}

int MXKVStorePush(KVStoreHandle handle, mx_uint num, const int* keys,
                  NDArrayHandle* vals, int /*priority*/) {
  return kv_call(handle, "kv_push", num, keys, vals);
}

int MXKVStorePull(KVStoreHandle handle, mx_uint num, const int* keys,
                  NDArrayHandle* outs, int /*priority*/) {
  return kv_call(handle, "kv_pull", num, keys, outs);
}

int MXKVStoreFree(KVStoreHandle handle) {
  auto* h = static_cast<KV*>(handle);
  if (!h) return 0;
  {
    Gil gil;
    Py_XDECREF(h->kv);
  }
  delete h;
  mxtpu_embed::quiesce();
  mxtpu_embed::ensure_exit_guard();
  return 0;
}

}  // extern "C"
