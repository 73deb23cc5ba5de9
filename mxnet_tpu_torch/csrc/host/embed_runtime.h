// Adapted from src/embed_runtime.h: the exit guard re-derived for torch's teardown.
//
// Embedded-interpreter lifecycle for the port's C ABI shims (c_api.cc,
// predict_api.cc). Internal linkage on purpose: each .so gets its own copy
// and state; external linkage would interpose between libmxtpu_c.so and
// libmxtpu_predict.so when a host loads both.
//
// The hazard. A C host that started the interpreter through this library
// never finalizes it: when the host calls exit(), the static destructors of
// libtorch (the CUDA caching allocator, the CUDA runtime's module table) and
// of the CUDA runtime itself run in the reverse order of their libraries'
// loads, while Python objects still hold CUDA tensors and torch's worker
// threads may still be inside the runtime. Whether the allocator frees its
// blocks before or after the runtime has torn down its context is then a
// matter of load order, which torch's lazy loading (libcudart, cuBLAS and
// cuDNN are dlopened at first use) decides; the JAX package met the same
// class of fault in its pool threads as an intermittent exit-time SIGSEGV.
// And a checkpoint write still queued on the port's engine would be lost.
// Two pieces close it:
//
//  * quiesce(): drain the port's engine (pending checkpoint writes land),
//    synchronize the card if torch initialised CUDA, and collect garbage,
//    while the interpreter is whole. Run at the handle-Free entry points
//    (rare, end-of-life calls) and at exit.
//  * an exit guard, armed only when this library started the interpreter
//    (a Python host finalizes itself): the FIRST exit handler quiesces if
//    nothing did in the last two seconds, flushes stdio and _exit()s,
//    skipping every static destructor. Exit handlers run LIFO and torch
//    keeps dlopening lazily (its CUDA libraries at first use, cuDNN at the
//    first convolution), each dlopen registering destructors ABOVE an
//    earlier guard, so the guard is re-armed whenever the count of loaded
//    shared objects changed, from the create/forward/free entry points.
//
// Tradeoff: once this library has started the interpreter, host atexit
// handlers registered BEFORE the guard's latest re-arm are skipped at exit.
// Hosts that need their own atexit work do it before exit(), or export
// MXTPU_EXIT_GUARD=0 to disable the guard (quiesce() still runs at the Free
// entry points). The variable is read at every re-arm attempt.
#ifndef MXTPU_TORCH_EMBED_RUNTIME_H_
#define MXTPU_TORCH_EMBED_RUNTIME_H_

#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <ctime>
#include <link.h>
#include <mutex>
#include <unistd.h>

namespace mxtpu_embed {

inline std::mutex& guard_mu() {
  static std::mutex mu;
  return mu;
}

// true once this library called Py_InitializeEx (the host is not Python)
inline bool& owns_interpreter() {
  static bool owns = false;
  return owns;
}

inline double monotonic_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

inline double& last_quiesce() {
  static double t = -1e9;
  return t;
}

// Drain the engine, synchronize the card, collect. Safe from any thread
// (takes the GIL); touches only modules the process already imported.
inline void quiesce() {
  if (!Py_IsInitialized()) return;
  PyGILState_STATE st = PyGILState_Ensure();
  PyRun_SimpleString(
      "import gc, sys\n"
      "_m = sys.modules.get('mxnet_tpu_torch.engine')\n"
      "if _m is not None and _m._engine is not None:\n"
      "    _m._engine.wait_for_all()\n"
      "_t = sys.modules.get('torch')\n"
      "if _t is not None and _t.cuda.is_initialized():\n"
      "    _t.cuda.synchronize()\n"
      "gc.collect()\n");
  PyGILState_Release(st);
  std::lock_guard<std::mutex> lk(guard_mu());
  last_quiesce() = monotonic_s();
}

inline int count_dsos() {
  int n = 0;
  dl_iterate_phdr([](struct dl_phdr_info*, size_t, void* p) {
    ++*static_cast<int*>(p);
    return 0;
  }, &n);
  return n;
}

// Re-arm the exit guard if new shared objects appeared since last time.
inline void ensure_exit_guard() {
  const char* guard_env = std::getenv("MXTPU_EXIT_GUARD");
  if (guard_env && guard_env[0] == '0' && guard_env[1] == '\0') return;
  std::lock_guard<std::mutex> lk(guard_mu());
  if (!owns_interpreter()) return;
  static int last = -1;
  int n = count_dsos();
  if (n == last) return;
  last = n;
  on_exit([](int status, void*) {
    bool settled;
    {
      std::lock_guard<std::mutex> lk(guard_mu());
      settled = monotonic_s() - last_quiesce() < 2.0;
    }
    // a host that exited without freeing its handles: quiesce now. This
    // takes the GIL and can block behind a call running on another thread,
    // bounded by that call, as any entry point is.
    if (!settled) quiesce();
    fflush(stdout);
    fflush(stderr);
    _exit(status);
  }, nullptr);
}

// Start the interpreter unless the host already runs one (a Python host
// that loaded this library through ctypes), and release the GIL so every
// entry point can take it with PyGILState_Ensure.
inline void ensure_python(std::mutex& init_mu) {
  bool started = false;
  {
    std::lock_guard<std::mutex> lk(init_mu);
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);  // the interpreter lives for the process lifetime
      PyEval_SaveThread();
      started = true;
    }
  }
  if (started) {
    {
      std::lock_guard<std::mutex> lk(guard_mu());
      owns_interpreter() = true;
    }
    ensure_exit_guard();
  }
}

}  // namespace mxtpu_embed

#endif  // MXTPU_TORCH_EMBED_RUNTIME_H_
