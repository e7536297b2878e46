// fastllama_tpu_torch C ABI implementation (see fastllama_c.h).
//
// The reference's C bridge (interfaces/c/main.cpp and lib/bridge.cpp of
// fastLLaMa) wraps a C++ runtime; here the runtime is Python/PyTorch, so
// this translation unit embeds a CPython interpreter and forwards every
// entry point to fastllama_tpu_torch.api.Model. It is the JAX package's
// c_api.cpp with the embedded helper and the capsule name pointed at this
// package. Design rules:
//
//   * One interpreter per process, created lazily by the first
//     llama_create_context() (or reused if the host process already runs
//     Python — e.g. when this library is dlopen'ed from a Python test).
//     The GIL is released after startup and re-acquired per call with
//     PyGILState_Ensure, so any thread may call in.
//   * C function pointers (logger channels, the token stream) are wrapped
//     as PyCFunctions whose `self` is a PyCapsule carrying the raw pointer;
//     Python-side they are plain callables handed to the library Logger.
//   * Array views (logits/embeddings) are materialized as contiguous f32
//     copies owned by the context via the buffer protocol; a view stays
//     valid until the next call on the same context.
//   * Python exceptions never cross the ABI: they are printed to stderr
//     and surface as false / NULL / empty views, matching the reference's
//     bool-return convention.

#include <Python.h>

#include <csignal>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <new>

#include "fastllama_c.h"

namespace {

constexpr const char* kCapName = "fastllama_tpu_torch.cptr";

// Python-side glue, compiled once into a private dict. Keeping the
// marshalling (kwargs assembly, enum coercion, contiguity) in Python keeps
// the C layer free of numpy/API-version coupling.
constexpr const char* kHelperSrc = R"PY(
import numpy as _np

def _make_logger(log, err, warn, reset, progress):
    from fastllama_tpu_torch.engine.logger import Logger
    pf = None
    if progress is not None:
        def pf(tag, done, total):
            progress(int(tag), int(done), int(total))
    return Logger(log_fn=log, log_err_fn=err, log_warn_fn=warn,
                  reset_fn=reset, progress_fn=pf)

def _create(path, kw, logger):
    import fastllama_tpu_torch
    if logger is None:
        return fastllama_tpu_torch.Model(path, **kw)
    return fastllama_tpu_torch.Model(path, logger=logger, **kw)

def _f32(a):
    if hasattr(a, "detach"):            # a torch tensor, on the card or not
        a = a.detach().float().cpu().numpy()
    return _np.ascontiguousarray(_np.asarray(a), dtype=_np.float32).ravel()
)PY";

PyObject* g_helpers = nullptr;  // dict holding the glue functions
bool g_started_interp = false;

std::once_flag g_py_once;

void ensure_python() {
    // call_once: the header promises every entry point is callable from any
    // thread; two first-callers racing Py_IsInitialized() could otherwise
    // double-initialize or skip the GIL release.
    std::call_once(g_py_once, [] {
        if (Py_IsInitialized()) return;  // host app embeds Python already
        Py_InitializeEx(0);
        g_started_interp = true;
        if (const char* boot = std::getenv("FASTLLAMA_C_INIT")) {
            if (PyRun_SimpleString(boot) != 0)
                std::fprintf(stderr, "fastllama_c: FASTLLAMA_C_INIT failed\n");
        }
        // release the GIL so per-call PyGILState_Ensure works from any thread
        PyEval_SaveThread();
    });
}

// must hold the GIL
PyObject* helpers() {
    if (g_helpers) return g_helpers;
    PyObject* globals = PyDict_New();
    if (!globals) return nullptr;
    PyDict_SetItemString(globals, "__builtins__", PyEval_GetBuiltins());
    PyObject* r = PyRun_String(kHelperSrc, Py_file_input, globals, globals);
    if (!r) {
        PyErr_Print();
        Py_DECREF(globals);
        return nullptr;
    }
    Py_DECREF(r);
    g_helpers = globals;
    return g_helpers;
}

// must hold the GIL; returns a borrowed-name helper, new ref
PyObject* call_helper(const char* name, PyObject* argtuple) {
    PyObject* h = helpers();
    if (!h) return nullptr;
    PyObject* fn = PyDict_GetItemString(h, name);  // borrowed
    if (!fn) return nullptr;
    return PyObject_CallObject(fn, argtuple);
}

// ---- C-pointer -> Python-callable shims ------------------------------------

PyObject* shim_log(PyObject* self, PyObject* args) {
    const char* fn; Py_ssize_t fl; const char* msg; Py_ssize_t ml;
    if (!PyArg_ParseTuple(args, "s#s#", &fn, &fl, &msg, &ml)) return nullptr;
    auto f = reinterpret_cast<LLAMA_LOGGER_FUNC>(
        PyCapsule_GetPointer(self, kCapName));
    if (f) f(fn, static_cast<int>(fl), msg, static_cast<int>(ml));
    Py_RETURN_NONE;
}

PyObject* shim_reset(PyObject* self, PyObject*) {
    auto f = reinterpret_cast<LLAMA_LOGGER_RESET_FUNC>(
        PyCapsule_GetPointer(self, kCapName));
    if (f) f();
    Py_RETURN_NONE;
}

PyObject* shim_progress(PyObject* self, PyObject* args) {
    int tag; Py_ssize_t done, total;
    if (!PyArg_ParseTuple(args, "inn", &tag, &done, &total)) return nullptr;
    auto f = reinterpret_cast<LLAMA_LOGGER_PROGRESS_FUNC>(
        PyCapsule_GetPointer(self, kCapName));
    if (f) f(static_cast<progress_type_tag>(tag),
             static_cast<size_t>(done), static_cast<size_t>(total));
    Py_RETURN_NONE;
}

// Interrupt flag set by llama_handle_signal (possibly from an async signal
// context — sig_atomic_t is the only type safely writable there) and polled
// once per token by the session's generate loop via the shim below.
volatile std::sig_atomic_t g_interrupt = 0;

PyObject* shim_poll_interrupt(PyObject*, PyObject*) {
    return PyBool_FromLong(g_interrupt != 0);
}

PyObject* shim_stream(PyObject* self, PyObject* arg) {
    Py_ssize_t n = 0;
    const char* s = PyUnicode_AsUTF8AndSize(arg, &n);
    if (!s) return nullptr;
    auto f = reinterpret_cast<LLAMA_STREAM_FUNC>(
        PyCapsule_GetPointer(self, kCapName));
    if (f) f(s, static_cast<int>(n));
    Py_RETURN_NONE;
}

PyMethodDef kLogDef = {"c_log", shim_log, METH_VARARGS, nullptr};
PyMethodDef kResetDef = {"c_reset", shim_reset, METH_NOARGS, nullptr};
PyMethodDef kProgressDef = {"c_progress", shim_progress, METH_VARARGS,
                            nullptr};
PyMethodDef kStreamDef = {"c_stream", shim_stream, METH_O, nullptr};
PyMethodDef kPollDef = {"c_poll_interrupt", shim_poll_interrupt, METH_NOARGS,
                        nullptr};

// wrap a C pointer as a Python callable (new ref); None when fn is NULL
PyObject* wrap_c_fn(void* fn, PyMethodDef* def) {
    if (!fn) Py_RETURN_NONE;
    PyObject* cap = PyCapsule_New(fn, kCapName, nullptr);
    if (!cap) return nullptr;
    PyObject* callable = PyCFunction_New(def, cap);
    Py_DECREF(cap);  // PyCFunction_New holds its own reference
    return callable;
}

struct ViewHolder {
    PyObject* arr = nullptr;
    Py_buffer buf{};
    bool held = false;

    // must hold the GIL
    void release() {
        if (held) {
            PyBuffer_Release(&buf);
            held = false;
        }
        Py_CLEAR(arr);
    }
};

}  // namespace

struct llama_model_context {
    llama_model_context_args args{};
    PyObject* model = nullptr;   // fastllama_tpu_torch.Model, after load
    PyObject* logger = nullptr;  // Logger or nullptr (library default)
    ViewHolder logits, embeddings;
};

namespace {

class GilGuard {
 public:
    GilGuard() : state_(PyGILState_Ensure()) {}
    ~GilGuard() { PyGILState_Release(state_); }
 private:
    PyGILState_STATE state_;
};

// call model.<method>(*args); on exception print + return nullptr
PyObject* call_method(llama_model_context* ctx, const char* method,
                      PyObject* argtuple) {
    if (!ctx || !ctx->model) return nullptr;
    PyObject* m = PyObject_GetAttrString(ctx->model, method);
    if (!m) {
        PyErr_Print();
        return nullptr;
    }
    PyObject* r = PyObject_CallObject(m, argtuple);
    Py_DECREF(m);
    if (!r) PyErr_Print();
    return r;
}

bool bool_method(llama_model_context* ctx, const char* method,
                 PyObject* argtuple) {
    GilGuard gil;
    PyObject* r = call_method(ctx, method, argtuple);
    Py_XDECREF(argtuple);
    if (!r) return false;
    const bool ok = PyObject_IsTrue(r) == 1;
    Py_DECREF(r);
    return ok;
}

bool path_method(llama_model_context* ctx, const char* method,
                 const char* path) {
    if (!path) return false;
    GilGuard gil;
    PyObject* args = Py_BuildValue("(s)", path);
    if (!args) return false;
    PyObject* r = call_method(ctx, method, args);
    Py_DECREF(args);
    if (!r) return false;
    const bool ok = PyObject_IsTrue(r) == 1;
    Py_DECREF(r);
    return ok;
}

llama_array_view_f view_method(llama_model_context const* cctx,
                               const char* method, ViewHolder* holder) {
    llama_array_view_f empty{nullptr, 0};
    auto* ctx = const_cast<llama_model_context*>(cctx);
    if (!ctx || !ctx->model) return empty;
    GilGuard gil;
    holder->release();
    PyObject* raw = call_method(ctx, method, nullptr);
    if (!raw) return empty;
    PyObject* args = PyTuple_Pack(1, raw);
    Py_DECREF(raw);
    if (!args) return empty;
    PyObject* flat = call_helper("_f32", args);
    Py_DECREF(args);
    if (!flat) {
        PyErr_Print();
        return empty;
    }
    if (PyObject_GetBuffer(flat, &holder->buf, PyBUF_CONTIG_RO) != 0) {
        PyErr_Print();
        Py_DECREF(flat);
        return empty;
    }
    holder->arr = flat;  // keep the array alive alongside its buffer
    holder->held = true;
    return {static_cast<float const*>(holder->buf.buf),
            static_cast<size_t>(holder->buf.len / sizeof(float))};
}

}  // namespace

extern "C" {

struct llama_model_context_args llama_create_default_context_args(void) {
    llama_model_context_args a{};
    a.embedding_eval_enabled = false;
    a.should_get_all_logits = false;
    a.use_mmap = false;
    a.use_mlock = false;
    a.load_parallel = true;
    a.seed = 0;
    a.n_keep = 200;
    a.n_ctx = 512;
    a.n_threads = 0;
    a.n_batch = 64;
    a.n_load_parallel_blocks = 1;
    a.last_n_tokens = 64;
    a.allocate_extra_mem = 0;
    a.logger = llama_logger{};
    return a;
}

struct llama_model_context* llama_create_context(
        struct llama_model_context_args args) {
    ensure_python();
    auto* ctx = new (std::nothrow) llama_model_context();
    if (!ctx) return nullptr;
    ctx->args = args;

    const llama_logger& lg = args.logger;
    if (lg.log || lg.log_err || lg.log_warn || lg.reset || lg.progress) {
        GilGuard gil;
        PyObject* t = PyTuple_New(5);
        if (t) {
            void* fns[5] = {(void*)lg.log, (void*)lg.log_err,
                            (void*)lg.log_warn, (void*)lg.reset,
                            (void*)lg.progress};
            PyMethodDef* defs[5] = {&kLogDef, &kLogDef, &kLogDef,
                                    &kResetDef, &kProgressDef};
            bool ok = true;
            for (int i = 0; i < 5; ++i) {
                PyObject* w = wrap_c_fn(fns[i], defs[i]);
                if (!w) { ok = false; break; }
                PyTuple_SET_ITEM(t, i, w);
            }
            if (ok) ctx->logger = call_helper("_make_logger", t);
            Py_DECREF(t);
        }
        if (!ctx->logger) {
            PyErr_Print();
            delete ctx;
            return nullptr;
        }
    }
    return ctx;
}

bool llama_load_model(struct llama_model_context* ctx, char const* filepath) {
    if (!ctx || !filepath) return false;
    GilGuard gil;
    if (ctx->model) {
        // the reference rejects double-load on one context; match that
        std::fprintf(stderr, "fastllama_c: model already loaded\n");
        return false;
    }
    const llama_model_context_args& a = ctx->args;
    PyObject* kw = Py_BuildValue(
        "{s:i,s:i,s:i,s:i,s:n,s:O,s:O,s:O,s:O,s:O,s:i,s:I,s:n}",
        "n_ctx", a.n_ctx,
        "seed", a.seed,
        "tokens_to_keep", a.n_keep,
        "n_batch", a.n_batch,
        "last_n_size", static_cast<Py_ssize_t>(a.last_n_tokens),
        "should_get_all_logits", a.should_get_all_logits ? Py_True : Py_False,
        "embedding_eval_enabled",
        a.embedding_eval_enabled ? Py_True : Py_False,
        "use_mmap", a.use_mmap ? Py_True : Py_False,
        "use_mlock", a.use_mlock ? Py_True : Py_False,
        "load_parallel", a.load_parallel ? Py_True : Py_False,
        "num_threads", a.n_threads,
        "n_load_parallel_blocks", a.n_load_parallel_blocks,
        "allocate_extra_mem", static_cast<Py_ssize_t>(a.allocate_extra_mem));
    if (!kw) return false;
    PyObject* args = Py_BuildValue("(sOO)", filepath, kw,
                                   ctx->logger ? ctx->logger : Py_None);
    Py_DECREF(kw);
    if (!args) return false;
    PyObject* model = call_helper("_create", args);
    Py_DECREF(args);
    if (!model) {
        PyErr_Print();
        return false;
    }
    ctx->model = model;
    return true;
}

bool llama_set_stop_words(struct llama_model_context* ctx,
                          char const** words, size_t len) {
    if (!ctx || (!words && len)) return false;
    GilGuard gil;
    PyObject* t = PyTuple_New(static_cast<Py_ssize_t>(len));
    if (!t) return false;
    for (size_t i = 0; i < len; ++i) {
        PyObject* s = PyUnicode_FromString(words[i] ? words[i] : "");
        if (!s) {
            Py_DECREF(t);
            return false;
        }
        PyTuple_SET_ITEM(t, static_cast<Py_ssize_t>(i), s);
    }
    PyObject* r = call_method(ctx, "set_stop_words", t);
    Py_DECREF(t);
    if (!r) return false;
    const bool ok = PyObject_IsTrue(r) == 1;
    Py_DECREF(r);
    return ok;
}

bool llama_ingest_system_prompt(struct llama_model_context* ctx,
                                char const* prompt) {
    if (!prompt) return false;
    GilGuard gil;
    PyObject* args = Py_BuildValue("(sO)", prompt, Py_True);
    if (!args) return false;
    PyObject* r = call_method(ctx, "ingest", args);
    Py_DECREF(args);
    if (!r) return false;
    const bool ok = PyObject_IsTrue(r) == 1;
    Py_DECREF(r);
    return ok;
}

bool llama_ingest(struct llama_model_context* ctx, char const* prompt) {
    if (!prompt) return false;
    GilGuard gil;
    PyObject* args = Py_BuildValue("(sO)", prompt, Py_False);
    if (!args) return false;
    PyObject* r = call_method(ctx, "ingest", args);
    Py_DECREF(args);
    if (!r) return false;
    const bool ok = PyObject_IsTrue(r) == 1;
    Py_DECREF(r);
    return ok;
}

bool llama_generate(struct llama_model_context* ctx,
                    LLAMA_STREAM_FUNC stream_fn,
                    size_t number_of_tokens,
                    float top_k, float top_p, float temp,
                    float repeat_penalty) {
    if (!ctx) return false;
    GilGuard gil;
    g_interrupt = 0;  // a stop requested for a PREVIOUS generate is spent
    PyObject* cb = wrap_c_fn((void*)stream_fn, &kStreamDef);
    if (!cb) return false;
    PyObject* poll = PyCFunction_New(&kPollDef, nullptr);
    if (!poll) {
        Py_DECREF(cb);
        return false;
    }
    PyObject* m = ctx->model
        ? PyObject_GetAttrString(ctx->model, "generate") : nullptr;
    if (!m) {
        if (ctx->model) PyErr_Print();
        Py_DECREF(cb);
        Py_DECREF(poll);
        return false;
    }
    PyObject* kw = Py_BuildValue(
        "{s:n,s:i,s:f,s:f,s:f,s:O,s:O}",
        "num_tokens", static_cast<Py_ssize_t>(number_of_tokens),
        "top_k", static_cast<int>(top_k),
        "top_p", top_p,
        "temp", temp,
        "repeat_penalty", repeat_penalty,
        "streaming_fn", cb,
        "interrupt_fn", poll);
    Py_DECREF(cb);
    Py_DECREF(poll);
    if (!kw) {
        Py_DECREF(m);
        return false;
    }
    PyObject* empty = PyTuple_New(0);
    PyObject* r = empty ? PyObject_Call(m, empty, kw) : nullptr;
    Py_XDECREF(empty);
    Py_DECREF(kw);
    Py_DECREF(m);
    if (!r) {
        PyErr_Print();
        return false;
    }
    const bool ok = PyObject_IsTrue(r) == 1;
    Py_DECREF(r);
    return ok;
}

float llama_perplexity(struct llama_model_context* ctx, char const* prompt) {
    if (!ctx || !prompt) return -1.0f;
    GilGuard gil;
    PyObject* args = Py_BuildValue("(s)", prompt);
    if (!args) return -1.0f;
    PyObject* r = call_method(ctx, "perplexity", args);
    Py_DECREF(args);
    if (!r) return -1.0f;
    float out = -1.0f;
    if (r != Py_None) {
        const double v = PyFloat_AsDouble(r);
        if (!PyErr_Occurred()) out = static_cast<float>(v);
        else PyErr_Clear();
    }
    Py_DECREF(r);
    return out;
}

struct llama_array_view_f llama_get_embeddings(
        struct llama_model_context const* ctx) {
    auto* c = const_cast<llama_model_context*>(ctx);
    return view_method(ctx, "get_embeddings", c ? &c->embeddings : nullptr);
}

struct llama_array_view_f llama_get_logits(
        struct llama_model_context const* ctx) {
    auto* c = const_cast<llama_model_context*>(ctx);
    return view_method(ctx, "get_logits", c ? &c->logits : nullptr);
}

int llama_get_n_vocab(struct llama_model_context const* ctx) {
    if (!ctx || !ctx->model) return 0;
    GilGuard gil;
    PyObject* v = PyObject_GetAttrString(ctx->model, "n_vocab");
    if (!v) {
        PyErr_Print();
        return 0;
    }
    long n = PyLong_AsLong(v);
    Py_DECREF(v);
    if (PyErr_Occurred()) {
        PyErr_Clear();
        return 0;
    }
    return static_cast<int>(n);
}

bool llama_save_state(struct llama_model_context* ctx, char const* filepath) {
    return path_method(ctx, "save_state", filepath);
}

bool llama_load_state(struct llama_model_context* ctx, char const* filepath) {
    return path_method(ctx, "load_state", filepath);
}

bool llama_attach_lora(struct llama_model_context* ctx,
                       char const* filepath) {
    return path_method(ctx, "attach_lora", filepath);
}

bool llama_detach_lora(struct llama_model_context* ctx) {
    return bool_method(ctx, "detach_lora", nullptr);
}

bool llama_reset_model(struct llama_model_context* ctx) {
    return bool_method(ctx, "reset", nullptr);
}

void llama_handle_signal(int signum) {
    // Async-signal-safe: only the sig_atomic_t store. The in-flight
    // llama_generate (if any) sees the flag at its next per-token poll and
    // returns cleanly with the session resumable — unlike the reference,
    // which printf+exit(0)s from the handler (interfaces/c/main.cpp:229-232).
    (void)signum;
    g_interrupt = 1;
}

void llama_free_context(struct llama_model_context* ctx) {
    if (!ctx) return;
    {
        GilGuard gil;
        ctx->logits.release();
        ctx->embeddings.release();
        Py_CLEAR(ctx->model);
        Py_CLEAR(ctx->logger);
    }
    delete ctx;
    // The interpreter (if this library started it) stays up for the
    // process: contexts are independent sessions, and CUDA/PyTorch state is
    // not re-initializable after Py_Finalize anyway.
}

}  // extern "C"
