/* fastllama_tpu_torch C ABI.
 *
 * Drop-in C surface matching the reference bridge header
 * (interfaces/c/fastllama.h of fastLLaMa) so C/C++ callers of the
 * reference library can relink against this framework unchanged. It is
 * byte-compatible with the JAX package's header: the same structs, field
 * order and entry points. The implementation (c_api.cpp) embeds a CPython
 * interpreter and drives the fastllama_tpu_torch.Model session API;
 * compute runs on the CUDA card through PyTorch (or on the CPU when the
 * boot hook below asks for it).
 *
 * Threading: every entry point may be called from any thread — the GIL is
 * acquired/released internally. The interpreter is created lazily on the
 * first llama_create_context() and lives for the process (contexts are
 * independent sessions on top of it). If the environment variable
 * FASTLLAMA_C_INIT is set, its contents run as Python source right after
 * interpreter startup (an embedder hook, e.g.
 * "import fastllama_tpu_torch.config as c; c.set_default_device('cpu')").
 */
#ifndef FASTLLAMA_TPU_C_ABI_H
#define FASTLLAMA_TPU_C_ABI_H

#include <stddef.h>
#include <stdint.h>
#include <stdbool.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Progress phases (mirrors fastllama_tpu_torch.engine.logger.ProgressTag). */
typedef uint8_t progress_type_tag;
#define PROGRESS_TAG_UNKNOWN             ((progress_type_tag)0)
#define PROGRESS_TAG_INIT                ((progress_type_tag)1)
#define PROGRESS_TAG_LOAD                ((progress_type_tag)2)
#define PROGRESS_TAG_SAVE                ((progress_type_tag)3)
#define PROGRESS_TAG_INGEST              ((progress_type_tag)4)
#define PROGRESS_TAG_ATTACH_LORA_ADAPTER ((progress_type_tag)5)
#define PROGRESS_TAG_DETACH_LORA_ADAPTER ((progress_type_tag)6)

typedef void (*LLAMA_LOGGER_FUNC)(char const* function_name,
                                  int function_name_size,
                                  char const* message, int message_size);
typedef void (*LLAMA_LOGGER_RESET_FUNC)(void);
typedef void (*LLAMA_LOGGER_PROGRESS_FUNC)(progress_type_tag tag,
                                           size_t done_size,
                                           size_t total_size);
typedef void (*LLAMA_STREAM_FUNC)(char const* token_stream,
                                  int token_stream_size);

struct llama_model_context;

struct llama_logger {
    LLAMA_LOGGER_FUNC          log;      /* info channel */
    LLAMA_LOGGER_FUNC          log_err;  /* error channel */
    LLAMA_LOGGER_FUNC          log_warn; /* warning channel */
    LLAMA_LOGGER_RESET_FUNC    reset;
    LLAMA_LOGGER_PROGRESS_FUNC progress; /* load/save/ingest phases */
};

/* Borrowed view into a float array owned by the context. Valid until the
 * next call on the same context (or llama_free_context). */
struct llama_array_view_f {
    float const* data;
    size_t size;
};

struct llama_model_context_args {
    bool embedding_eval_enabled;
    bool should_get_all_logits;
    bool use_mmap;   /* no device analog; accepted, warned, ignored */
    bool use_mlock;  /* ditto */
    bool load_parallel;
    int seed;
    int n_keep;      /* tokens preserved across context recycling */
    int n_ctx;
    int n_threads;   /* PyTorch owns scheduling; accepted, ignored */
    int n_batch;
    uint32_t n_load_parallel_blocks;
    size_t last_n_tokens;      /* repeat-penalty window */
    size_t allocate_extra_mem; /* PyTorch owns device allocation; ignored */
    struct llama_logger logger; /* any member may be NULL */
};

/* Defaults matching fastllama_tpu_torch.api.Model's keyword defaults. */
struct llama_model_context_args llama_create_default_context_args(void);

/* NULL on failure (details on the error channel / stderr). */
struct llama_model_context* llama_create_context(
    struct llama_model_context_args args);

/* Load weights (.fltpu / GGML / GGMF / GGJT) into the context. */
bool llama_load_model(struct llama_model_context* ctx, char const* filepath);

/* Replace the generation stop-word set. */
bool llama_set_stop_words(struct llama_model_context* ctx,
                          char const** words, size_t len);

/* Feed a system prompt (survives context recycling up to n_keep tokens). */
bool llama_ingest_system_prompt(struct llama_model_context* ctx,
                                char const* prompt);

/* Feed a conversation prompt. */
bool llama_ingest(struct llama_model_context* ctx, char const* prompt);

/* Decode up to number_of_tokens, streaming UTF-8 text into stream_fn.
 * top_k is float for signature parity with the reference; it is used as an
 * integer cutoff. */
bool llama_generate(struct llama_model_context* ctx,
                    LLAMA_STREAM_FUNC stream_fn,
                    size_t number_of_tokens,
                    float top_k, float top_p, float temp,
                    float repeat_penalty);

/* Perplexity of `prompt` under the model; -1.0f on failure. */
float llama_perplexity(struct llama_model_context* ctx, char const* prompt);

/* Last token's embedding (requires embedding_eval_enabled) — empty view
 * otherwise. */
struct llama_array_view_f llama_get_embeddings(
    struct llama_model_context const* ctx);

/* Logits of the last evaluation (all positions when should_get_all_logits,
 * else the final position's vocab row). */
struct llama_array_view_f llama_get_logits(
    struct llama_model_context const* ctx);

/* Vocabulary size of the loaded model (the width of one logits row);
 * 0 before a model is loaded. */
int llama_get_n_vocab(struct llama_model_context const* ctx);

/* Session state (KV prefix, RNG, token buffer) save / restore. */
bool llama_save_state(struct llama_model_context* ctx, char const* filepath);
bool llama_load_state(struct llama_model_context* ctx, char const* filepath);

/* LoRA adapter attach (ggla / .npz) and O(1) detach. */
bool llama_attach_lora(struct llama_model_context* ctx, char const* filepath);
bool llama_detach_lora(struct llama_model_context* ctx);

/* Reset session memory (keeps the loaded weights). */
bool llama_reset_model(struct llama_model_context* ctx);

/* Signal hook (reference: interfaces/c/main.cpp:229-232 — which exits the
 * process). Here it is async-signal-safe and REQUESTS a clean stop instead:
 * it sets a flag that every in-flight llama_generate polls once per token;
 * the generate returns true at the next token boundary with the session
 * fully resumable (ingest/generate continue to work). Install it directly:
 * signal(SIGINT, llama_handle_signal). The flag clears when the next
 * llama_generate starts. */
void llama_handle_signal(int signum);

void llama_free_context(struct llama_model_context* ctx);

#ifdef __cplusplus
}
#endif

#endif /* FASTLLAMA_TPU_C_ABI_H */
