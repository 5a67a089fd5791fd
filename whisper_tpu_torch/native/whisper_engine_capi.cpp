// C-ABI engine binding of the PyTorch port: create / transcribe / destroy
// for foreign callers.
//
// The port's copy of native/whisper_engine_capi.cpp (the JAX package's
// binding, the counterpart of the reference's JNI bridge): the same plain C
// ABI any FFI can bind (Java via JNA/Panama, Go cgo, Rust, C#), the same
// entry points and error surface. Only the bootstrap differs: it builds a
// whisper_tpu_torch engine, which runs on the card unless the config says
// otherwise. The C boundary is crossed once per utterance with a string or
// a PCM buffer.
//
// Implementation: embeds CPython (or joins an already-initialized
// interpreter when the host process IS Python, e.g. ctypes-driven tests).
// All entry points take the GIL via PyGILState_Ensure, so the library is
// safe to call from any thread.
//
// Surface (all functions thread-safe; strings are UTF-8):
//   wh_engine_create(config_json)           -> opaque handle or NULL
//   wh_engine_transcribe_file(h, path)      -> malloc'd transcript or NULL
//   wh_engine_transcribe_buffer(h, pcm, n)  -> malloc'd transcript or NULL
//   wh_engine_destroy(h)
//   wh_engine_error()                       -> last error on this thread
//   wh_engine_string_free(s)
//
// config_json keys: engine ("monolith"|"encdec"), model, language, task,
// beam_size, max_new_tokens, dtype, quantization, kv_cache_dtype,
// checkpoint (path), vocab_bin (path), seed, device ("cuda" by default,
// "cpu" to run on the CPU), pythonpath (prepended to sys.path so an
// uninstalled repo checkout, or the site-packages of a virtual
// environment, is importable), plus any other EngineConfig field.
//
// Build: python -m whisper_tpu_torch.native.build (g++ against the
// interpreter's include directory and python3-config --embed --ldflags).

#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

#define WH_API __attribute__((visibility("default")))

namespace {

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

// Render the pending Python exception into g_error and clear it.
void capture_py_error(const char* where) {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = std::string(where) + ": ";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg += c;
      Py_DECREF(s);
    }
  } else {
    msg += "unknown python error";
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

// Bootstrap helpers, exec'd once into a private module. Kept as source so
// the .so has no file dependencies beyond an importable whisper_tpu_torch.
const char* kBootstrap = R"PY(
import json

def _create(cfg_json):
    d = json.loads(cfg_json or "{}")
    pp = d.pop("pythonpath", None)
    if pp:
        import sys
        for p in reversed(pp.split(":")):
            if p and p not in sys.path:
                sys.path.insert(0, p)
    from whisper_tpu_torch.config import MODEL_DIMS, EngineConfig
    from whisper_tpu_torch.engine import EngineType, create_engine

    et = (EngineType.ENCDEC if d.pop("engine", "monolith") == "encdec"
          else EngineType.MONOLITH)
    ckpt = d.pop("checkpoint", None)
    vocab = d.pop("vocab_bin", None)
    seed = int(d.pop("seed", 0))
    device = d.pop("device", "cuda")
    params = None
    if ckpt:
        from whisper_tpu_torch.models.convert import load_checkpoint
        params, dims = load_checkpoint(ckpt)
        if "model" not in d:
            d["model"] = next(
                k for k, v in MODEL_DIMS.items() if v == dims
            )
    config = EngineConfig(**d)
    return create_engine(et, config, params=params, vocab_bin=vocab,
                         seed=seed, device=device)

def _transcribe_file(engine, path):
    return engine.transcribe(path).text

def _transcribe_buffer(engine, buf):
    import numpy as np
    samples = np.frombuffer(buf, dtype=np.float32)
    return engine.transcribe(samples).text
)PY";

bool g_owns_interpreter = false;
PyObject* g_helpers = nullptr;  // module dict holding _create etc.

// Bring the interpreter up exactly once. When this library is loaded INTO a
// Python process (ctypes), the interpreter already exists and we only attach.
void ensure_python() {
  static std::once_flag once;
  std::call_once(once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      g_owns_interpreter = true;
      // Release the GIL the embedded init acquired; every entry point
      // re-takes it via PyGILState_Ensure.
      PyEval_SaveThread();
    }
  });
}

// Must hold the GIL.
bool ensure_helpers() {
  if (g_helpers != nullptr) return true;
  PyObject* mod = PyModule_New("whisper_tpu_torch_capi_bootstrap");
  if (mod == nullptr) {
    capture_py_error("bootstrap module");
    return false;
  }
  PyObject* dict = PyModule_GetDict(mod);  // borrowed
  PyDict_SetItemString(dict, "__builtins__", PyEval_GetBuiltins());
  PyObject* res =
      PyRun_String(kBootstrap, Py_file_input, dict, dict);
  if (res == nullptr) {
    capture_py_error("bootstrap exec");
    Py_DECREF(mod);
    return false;
  }
  Py_DECREF(res);
  g_helpers = mod;  // keep the module (and its dict) alive forever
  return true;
}

// Must hold the GIL. Returns a NEW reference or nullptr.
PyObject* call_helper(const char* name, PyObject* args) {
  if (!ensure_helpers()) return nullptr;
  PyObject* fn =
      PyDict_GetItemString(PyModule_GetDict(g_helpers), name);  // borrowed
  if (fn == nullptr) {
    set_error(std::string("helper missing: ") + name);
    return nullptr;
  }
  PyObject* out = PyObject_CallObject(fn, args);
  if (out == nullptr) capture_py_error(name);
  return out;
}

char* str_result(PyObject* s) {
  const char* c = PyUnicode_AsUTF8(s);
  if (c == nullptr) {
    capture_py_error("utf8");
    return nullptr;
  }
  char* out = static_cast<char*>(std::malloc(std::strlen(c) + 1));
  if (out != nullptr) std::strcpy(out, c);
  return out;
}

class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

}  // namespace

extern "C" {

WH_API const char* wh_engine_error(void) { return g_error.c_str(); }

WH_API void wh_engine_string_free(char* s) { std::free(s); }

WH_API void* wh_engine_create(const char* config_json) {
  ensure_python();
  Gil gil;
  PyObject* args = Py_BuildValue("(s)", config_json ? config_json : "{}");
  if (args == nullptr) {
    capture_py_error("build args");
    return nullptr;
  }
  PyObject* engine = call_helper("_create", args);
  Py_DECREF(args);
  return engine;  // owned reference doubles as the opaque handle
}

WH_API char* wh_engine_transcribe_file(void* handle, const char* path) {
  if (handle == nullptr || path == nullptr) {
    set_error("null handle or path");
    return nullptr;
  }
  Gil gil;
  PyObject* args =
      Py_BuildValue("(Os)", static_cast<PyObject*>(handle), path);
  if (args == nullptr) {
    capture_py_error("build args");
    return nullptr;
  }
  PyObject* text = call_helper("_transcribe_file", args);
  Py_DECREF(args);
  if (text == nullptr) return nullptr;
  char* out = str_result(text);
  Py_DECREF(text);
  return out;
}

WH_API char* wh_engine_transcribe_buffer(void* handle, const float* samples,
                                         long long n_samples) {
  if (handle == nullptr || samples == nullptr || n_samples <= 0) {
    set_error("null handle/buffer or empty audio");
    return nullptr;
  }
  Gil gil;
  PyObject* buf = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(samples),
      static_cast<Py_ssize_t>(n_samples) *
          static_cast<Py_ssize_t>(sizeof(float)));
  if (buf == nullptr) {
    capture_py_error("buffer copy");
    return nullptr;
  }
  PyObject* args =
      Py_BuildValue("(OO)", static_cast<PyObject*>(handle), buf);
  Py_DECREF(buf);
  if (args == nullptr) {
    capture_py_error("build args");
    return nullptr;
  }
  PyObject* text = call_helper("_transcribe_buffer", args);
  Py_DECREF(args);
  if (text == nullptr) return nullptr;
  char* out = str_result(text);
  Py_DECREF(text);
  return out;
}

WH_API void wh_engine_destroy(void* handle) {
  if (handle == nullptr) return;
  // Releases the engine (the reference's Java binding never frees one).
  Gil gil;
  Py_DECREF(static_cast<PyObject*>(handle));
}

}  // extern "C"
