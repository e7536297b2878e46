"""StepGraph: a step function captured once as a CUDA graph and replayed;
GraphCache: one StepGraph a key, as jax.jit keeps one compile a static
signature.

The port's counterpart of what `jax.jit` does for the JAX package's steps:
the decode steps (`models/llama.forward_jit_decode`, the engine's
`_build_decode` and `_build_decode_paged`, bench.py's `decode_step`) and
the prefill windows and admissions (`models/llama.forward_jit`, the
engine's `_build_prefill*`, `_build_ingest_chunk` and `_build_splice*`,
bench.py's `prefill_step`): a step's hundreds of kernel launches are
enqueued by one `CUDAGraph.replay()` instead of one Python call each.

    graph = StepGraph(device, generators=(gen,))
    out = graph(fn, static, state, *inputs)

  * `inputs` are tensors copied (non_blocking) into static buffers before
    each replay; `fn(*static_inputs)` returns a tensor or a tuple of them,
    the static outputs, which the next call overwrites: a caller that keeps
    one across calls copies it.
  * `state` holds what fn reads and writes in place (parameters, caches,
    slot state, position tables): a graph bakes their addresses. The key is
    `static` (the step's configuration, compared by value), the shapes and
    dtypes of the inputs, and the identity of every object `state` reaches
    (`reached`): its tensors, and the fields of each dataclass in it, so
    that a LoRA term attached to a layer in place is a new key, as a new
    pytree structure retraces under jax.jit. A new key captures a new graph
    and drops the old one; the graph holds the objects of its key, so no id
    of the key is reused while it lives.
  * The first call with a key is the warm-up: it runs fn eagerly on a side
    stream (its launches are the card's, counted by the wrappers as they
    run; lazily made state such as kernels/cuda_lib's scratch and counters
    is made there, outside the capture), then captures fn without running
    it, and copies the warm-up's results into the static outputs. Every
    later call replays. So a step that advances state (the engine's
    sampling, a position counter) advances it once per call, as eager.
  * Launch accounting: a capture records how many launches of each kernel
    (kernels/cuda_lib.COUNTED) the graph holds and takes them back off the
    counters; each replay adds that record. The counters keep meaning
    "kernels the card ran".
  * `generators`: CUDA generators other than the default that fn draws from
    (torch.rand(generator=g)); each is registered with the graph, so a
    replay draws what an eager call at the same generator offset draws and
    advances the generator as that call would.
  * `pool`: a memory pool handle (torch.cuda.graph_pool_handle()) the
    capture allocates from; graphs that never run at once may share one, so
    their intermediates take the same memory. A replay then writes its
    intermediates where another graph of the pool may keep its static
    outputs: a caller copies (or consumes) a graph's outputs before another
    graph of the pool replays (GraphCache gives its graphs one pool).
  * On the card a capture or a replay that fails raises; nothing falls back
    to the eager step. On the CPU (a `device="cpu"` run) the same object
    calls fn on the same static buffers every time and copies its results
    into the same static outputs, without capturing: everything but the
    capture (the input copies, the output aliasing, the keys) is the path
    the card runs.
"""
from __future__ import annotations

import collections
import time

import torch

from ..kernels import cuda_lib

_SEQ = (list, tuple)


def _walk(obj, out: list) -> None:
    if type(obj) in _SEQ:
        for o in obj:
            _walk(o, out)
    elif hasattr(obj, "__dataclass_fields__"):
        fields = obj.__dict__.values()
        out.extend(fields)
        for v in fields:
            if type(v) in _SEQ:
                _walk(v, out)
    else:
        out.append(obj)


def reached(state) -> list:
    """The objects whose identity keys a graph: `state`'s tensors and
    other leaves, walking lists and tuples, and the field values of each
    dataclass (a field that is a list or tuple is walked too; a dataclass
    field's own fields are not: a weight or a LoRA term is replaced whole,
    never edited in place)."""
    out: list = []
    _walk(state, out)
    return out


def pool_bytes(device, pool) -> "int | None":
    """The device bytes the caching allocator holds for a CUDA graph memory
    pool: the sizes of its segments in torch.cuda.memory_snapshot(). 0
    without a pool (the CPU); None where the snapshot does not name each
    segment's pool. A measurement (it walks every segment), not for a
    step's path."""
    if pool is None or torch.device(device).type != "cuda":
        return 0
    segments = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in segments):
        return None
    return sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def step_key(static, state, inputs) -> tuple[tuple, list]:
    """A step's key (the static part, the ids of what `state` reaches, the
    input shapes and dtypes) and the objects whose ids it holds."""
    objs = reached(state)
    return (static, tuple(map(id, objs)),
            tuple((tuple(x.shape), x.dtype) for x in inputs)), objs


class StepGraph:
    """One captured step (see the module docstring)."""

    def __init__(self, device, generators=(), pool=None):
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.pool = pool
        self.key = None
        self.captures = 0           # keys built: a capture each on the card
        self.replays = 0            # calls served by a replay (on the
                                    # CPU: by the static buffers, the
                                    # replay's path there)
        self.build_s = 0.0          # host seconds of the builds (warm-ups
                                    # and captures) so far
        self._graph = None
        self._inputs: list[torch.Tensor] = []
        self._outputs = None
        self._held: list = []       # the key's objects, cuda_lib's buffers
        self._launches: list[tuple[object, str, int]] = []

    def launches_per_replay(self) -> dict[str, int]:
        """Kernel launches one replay adds, by wrapper name."""
        return {w.__name__: n for w, _, n in self._launches}

    def __call__(self, fn, static, state, *inputs):
        return self.run(fn, *step_key(static, state, inputs), inputs)

    def run(self, fn, key, objs, inputs):
        """__call__ with the key already made (GraphCache makes it once)."""
        with torch.inference_mode():
            if key != self.key:
                t0 = time.perf_counter()
                self._build(fn, key, objs, inputs)
                self.build_s += time.perf_counter() - t0
            else:
                for buf, x in zip(self._inputs, inputs):
                    buf.copy_(x, non_blocking=True)
                if self._graph is None:            # the CPU: no capture
                    self._store(fn(*self._inputs))
                else:
                    self._graph.replay()
                    for w, attr, n in self._launches:
                        setattr(w, attr, getattr(w, attr) + n)
                self.replays += 1
        return self._outputs

    def _store(self, out) -> None:
        """Copy fn's results into the static outputs (made on first use)."""
        outs = out if isinstance(out, tuple) else (out,)
        if self._outputs is None:
            self._outputs = (tuple(o.clone() for o in outs)
                             if isinstance(out, tuple) else out.clone())
            return
        static = (self._outputs if isinstance(self._outputs, tuple)
                  else (self._outputs,))
        for s, o in zip(static, outs):
            s.copy_(o)

    def _build(self, fn, key, objs, inputs) -> None:
        """Warm up on the new key (this call's step, run eagerly) and, on
        the card, capture the graph that replays it from now on."""
        self.key = None
        self._graph = self._outputs = None
        self._held, self._launches = [], []
        self._inputs = [torch.empty(x.shape, dtype=x.dtype, device=self.device)
                        for x in inputs]
        for buf, x in zip(self._inputs, inputs):
            buf.copy_(x, non_blocking=True)
        self.captures += 1
        if self.device.type != "cuda":
            self._store(fn(*self._inputs))
            self.key = key
            return
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                warm = fn(*self._inputs)
            current.wait_stream(side)
            warm_t = warm if isinstance(warm, tuple) else (warm,)
            for w in warm_t:
                w.record_stream(current)
            self._capture(fn)
            self._store(warm)
        self._held = objs + self._held
        self.key = key

    def _capture(self, fn) -> None:
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = cuda_lib.counts()
        bufs = cuda_lib.buffers()
        try:
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                out = fn(*self._inputs)
        finally:
            after = cuda_lib.counts()
            for (w, attr), n in zip(cuda_lib.COUNTED, before):
                setattr(w, attr, n)
        if [id(b) for b in cuda_lib.buffers()] != [id(b) for b in bufs]:
            raise RuntimeError(
                "a kernel made its scratch inside the capture: the warm-up "
                "call must make every buffer the step uses")
        self._launches = [(w, attr, a - b) for (w, attr), a, b
                          in zip(cuda_lib.COUNTED, after, before) if a != b]
        self._held = bufs
        self._graph = graph
        # the static outputs are the captured step's; _store fills them
        # with the warm-up's values, the ones a replay would write
        self._outputs = out


class GraphCache:
    """StepGraphs by key, the least recently used dropped past `size`:
    `cache(fn, static, state, *inputs)` replays the graph of a key it has
    seen and builds one (a warm-up and a capture, as StepGraph) for a new
    key. jax.jit's cache of compiles, one a static signature. Each owner
    keeps one: a session's (its decode step and its prefill windows, one
    graph a bucket and config) and an engine's (its decode step and its
    admission steps). `static` is a tuple whose first item names the step
    (entries() finds a step's graphs by it). Every graph of a cache
    allocates from one memory pool (`pool`, made here on the card): they
    never run at once, and each caller consumes a graph's outputs before
    another graph of the cache replays (StepGraph's `pool`).
    Counts: captures (keys built), replays, evictions, build_s; last the
    StepGraph of the latest call; pool_bytes() the pool's device memory."""

    def __init__(self, device, generators=(), size: int = 8):
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.size = size
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)
        self.graphs: "collections.OrderedDict[tuple, StepGraph]" = \
            collections.OrderedDict()
        self.captures = self.replays = self.evictions = 0
        self.build_s = 0.0
        self.last: "StepGraph | None" = None

    def entries(self, kind: str) -> list[StepGraph]:
        """The graphs held for the step named `kind` (static[0])."""
        return [g for key, g in self.graphs.items() if key[0][0] == kind]

    def pool_bytes(self) -> "int | None":
        """Device bytes held for the cache's memory pool (0 on the CPU)."""
        return pool_bytes(self.device, self.pool)

    def __call__(self, fn, static, state, *inputs):
        key, objs = step_key(static, state, inputs)
        graph = self.graphs.get(key)
        if graph is None:
            graph = StepGraph(self.device, self.generators, self.pool)
            self.graphs[key] = graph
            while len(self.graphs) > self.size:
                self.graphs.popitem(last=False)
                self.evictions += 1
        else:
            self.graphs.move_to_end(key)
        before = (graph.captures, graph.replays, graph.build_s)
        out = graph.run(fn, key, objs, inputs)
        self.captures += graph.captures - before[0]
        self.replays += graph.replays - before[1]
        self.build_s += graph.build_s - before[2]
        self.last = graph
        return out
