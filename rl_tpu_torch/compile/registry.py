"""The program registry: hot programs by name, captured as CUDA graphs
(counterpart of :mod:`rl_tpu.compile.registry`).

The reference registers every hot jitted program under a name, compiles
one executable per call signature, and can compile them ahead of the
first call (``aot_warmup``). Here a registered program is a Python
function that runs eagerly, and what it is compiled into is a CUDA graph:

- :meth:`ProgramRegistry.register` returns a :class:`CachedProgram`,
  called like the function. On CPU tensors it runs the function eagerly.
  On a CUDA tensor, a signature it has not seen (tree structure, each
  tensor's shape, dtype and device, every other leaf's value: the shape
  bucket; and the grad mode) captures one graph, which the call and every
  later call of that signature replays. A capture that fails raises; nothing falls back to
  the eager function on the card.
- Capture: the function runs once eagerly on the registry's side stream
  (which initialises what a graph cannot, such as library workspaces),
  then every tensor argument, the program's ``state`` (the tensors and
  generators it updates in place beside its arguments) and every
  generator it drew from are put back as they were, and the function is
  captured on that stream into the graph's own memory pool, or into
  the pool of the :class:`GraphPool` the program was registered with. The
  generators are registered with the graph, so each replay draws new
  numbers, the same ones an eager call from the same generator state
  would draw. Captures take the registry's lock one at a time, and the
  side stream is drained before a capture returns.
- Static buffers: the tensors of the capturing call are the graph's
  inputs, and from then on they belong to the program. A later call that
  passes another tensor for an argument has it copied into them before
  the replay and, where the graph updates that argument in place, copied
  back out after it; another generator has its state
  swapped in and out alike. An output that is an argument is returned as
  the caller's tensor; every other output is copied out of the graph's
  pool, so results of two replays never alias. Non-tensor outputs are
  those of the capturing call.
- A replay runs no Python of the function: Python side effects happen
  at capture only (the kernel wrappers count no launch while a stream is
  being captured, and a replay adds none). Values the function reads on
  the host are fixed per graph, so they belong in the signature: a
  program must not read a tensor's value on the host.

:meth:`CachedProgram.add_signature` records example arguments and
:meth:`ProgramRegistry.aot_warmup` captures them ahead of traffic,
optionally on a background thread (:class:`WarmupHandle`). A capture
works on the program's live arguments and state: while a background
warm-up runs, nothing else may touch them, nor draw from a generator the
program uses or from the default CUDA generator; the owners in this
package (the serving engine, the GRPO trainer) wait for it before they
do. The registry
holds its programs by weak reference: a program usually closes over its
trainer or engine, and a process that builds many of them must not keep
them all alive.
"""

from __future__ import annotations

import gc
import threading
import time
import weakref
from typing import Any, Callable, Iterable

import torch

from ..data.arraydict import ArrayDict
from . import metrics as _metrics
from .store import ExecutableStore, default_store

__all__ = ["CachedProgram", "GraphPool", "ProgramRegistry", "WarmupHandle",
           "get_program_registry", "set_program_registry"]

# only the capturing thread is barred from calls a capture forbids, so
# another thread (a rollout producer, autograd's worker) may keep running
CAPTURE_ERROR_MODE = "thread_local"


def _flatten(x: Any, leaves: list) -> Any:
    """The structure of ``x`` (hashable), appending its leaves in order."""
    if isinstance(x, ArrayDict):
        return ("A", tuple((k, _flatten(x[k], leaves)) for k in x.keys()))
    if isinstance(x, dict):
        return ("D", tuple((k, _flatten(v, leaves)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return ("L" if isinstance(x, list) else "T", tuple(_flatten(v, leaves) for v in x))
    leaves.append(x)
    return None


def _unflatten(struct: Any, leaves: Iterable) -> Any:
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, items = s
        if kind == "A":
            return ArrayDict._unsafe({k: build(v) for k, v in items})
        if kind == "D":
            return {k: build(v) for k, v in items}
        if kind == "L":
            return [build(v) for v in items]
        return tuple(build(v) for v in items)

    return build(struct)


def _leaf_key(x: Any) -> tuple:
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype, x.device, x.requires_grad)
    if isinstance(x, torch.Generator):
        return ("G", x.device)
    if type(x) in (int, float, str, bool, type(None)):
        return ("V", type(x), x)
    return ("O", id(x))  # any other object by identity


def _memkey(struct: Any, leaves: list) -> tuple:
    # grad mode too: it decides whether the outputs carry a graph
    return (struct, tuple(_leaf_key(x) for x in leaves), torch.is_grad_enabled())


class _Captured:
    """One captured graph and its static buffers."""

    def __init__(self, graph, static, gens, mutated, outs, out_struct):
        self.graph = graph
        self.static = static  # the capturing call's tensor arguments
        self.gens = gens  # the capturing call's generator arguments
        self.mutated = mutated  # argument positions the graph updates in place
        self.outs = outs  # per output leaf: ("in", i) | ("gen", k) | ("pool", t) | ("value", v)
        self.out_struct = out_struct

    def replay(self, leaves: list) -> Any:
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        gens = [x for x in leaves if isinstance(x, torch.Generator)]
        swapped = [i for i, (t, s) in enumerate(zip(tensors, self.static))
                   if t is not s and t.data_ptr() != s.data_ptr()]
        gswap = [k for k, (g, s) in enumerate(zip(gens, self.gens)) if g is not s]
        with torch.no_grad():
            for i in swapped:
                self.static[i].copy_(tensors[i])
            for k in gswap:
                self.gens[k].set_state(gens[k].get_state())
            self.graph.replay()
            for k in gswap:
                gens[k].set_state(self.gens[k].get_state())
            for i in swapped:
                if i in self.mutated:
                    tensors[i].copy_(self.static[i])
            out = []
            for kind, v in self.outs:
                if kind == "in":
                    out.append(tensors[v])
                elif kind == "gen":
                    out.append(gens[v])
                elif kind == "pool":
                    out.append(v.clone())
                else:
                    out.append(v)
        return _unflatten(self.out_struct, out)


class GraphPool:
    """One CUDA graph memory pool for the graphs of several programs
    (``ProgramRegistry.register(..., pool=)``), in place of one pool per
    graph. A graph's temporaries are written only while it replays, and
    every output that lives in the pool is copied out right after its
    replay, so graphs that replay one at a time on one stream may reuse
    each other's temporaries' memory: the owner (one serving engine)
    replays its programs so."""

    def __init__(self):
        self._handles: dict = {}
        self._lock = threading.Lock()

    def handle(self, dev: torch.device):
        """The pool's handle on ``dev`` (made at its first capture there)."""
        with self._lock:
            h = self._handles.get(dev)
            if h is None:
                h = self._handles[dev] = torch.cuda.graph_pool_handle()
            return h


class CachedProgram:
    """A registered program: called like ``fn``; on the card, one CUDA
    graph per signature.

    ``state`` (a callable returning tensors and generators) names what
    ``fn`` updates in place besides its arguments, such as parameters and
    optimizer moments: the eager run before a capture puts it back.
    ``pool``: a :class:`GraphPool` whose memory the graphs share.
    ``stats`` counts ``calls``, ``compiles`` (captures), ``replays``,
    ``aot_hits`` (replays of a graph captured by an earlier call),
    ``eager_calls`` (CPU), ``compile_s`` (the eager run, the capture and
    the graph's instantiation) and ``capture_s`` (capture and
    instantiation alone). The graphs are filed in the
    registry's :class:`~rl_tpu_torch.compile.ExecutableStore`."""

    def __init__(self, name: str, fn: Callable, *, registry: "ProgramRegistry",
                 fingerprint: str = "", state: Callable[[], Iterable] | None = None,
                 pool: GraphPool | None = None):
        self.name = name
        self.fn = fn
        self.fingerprint = fingerprint
        self._state = state
        self._pool = pool
        self._registry = registry
        self._lock = threading.RLock()
        self._signatures: list[tuple] = []
        self.stats = {"calls": 0, "replays": 0, "aot_hits": 0, "compiles": 0,
                      "eager_calls": 0, "compile_s": 0.0, "capture_s": 0.0}

    # -- warm-up ---------------------------------------------------------

    def add_signature(self, *args: Any) -> "CachedProgram":
        """Record example arguments for :meth:`ProgramRegistry.aot_warmup`
        (their tensors become the graph's static inputs), under the grad
        mode in force here. Idempotent on the signature."""
        leaves: list = []
        mk = _memkey(_flatten(args, leaves), leaves)
        with self._lock:
            if all(m != mk for m, _ in self._signatures):
                self._signatures.append((mk, args))
        return self

    @property
    def signatures(self) -> list[tuple]:
        with self._lock:
            return [args for _, args in self._signatures]

    def warmup(self, *args: Any) -> tuple[str, float]:
        """Capture the graph for this signature without changing any
        tensor: ``("memory", 0.0)`` if it exists, ``("capture", seconds)``
        after a capture, ``("eager", 0.0)`` for CPU arguments (nothing to
        capture)."""
        leaves: list = []
        struct = _flatten(args, leaves)
        dev = _cuda_device(leaves)
        if dev is None:
            return ("eager", 0.0)
        mk = _memkey(struct, leaves)
        with self._lock:
            if self._registry.store.load(self, mk) is not None:
                return ("memory", 0.0)
            t0 = time.perf_counter()
            self._capture(mk, args, leaves, dev)
            return ("capture", time.perf_counter() - t0)

    # -- capture and dispatch --------------------------------------------

    def _capture(self, mk: tuple, args: tuple, leaves: list, dev: torch.device) -> _Captured:
        with self._registry._capture_lock:  # one capture at a time, on the one side stream
            return self._capture_locked(mk, args, leaves, dev)

    def _capture_locked(self, mk: tuple, args: tuple, leaves: list,
                        dev: torch.device) -> _Captured:
        t0 = time.perf_counter()
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        gens = [x for x in leaves if isinstance(x, torch.Generator)]
        hidden = list(self._state()) if self._state is not None else []
        keep = tensors + [x for x in hidden if isinstance(x, torch.Tensor)]
        default_gen = torch.cuda.default_generators[dev.index if dev.index is not None
                                                    else torch.cuda.current_device()]
        all_gens = list({id(g): g for g in gens + [x for x in hidden
                                                    if isinstance(x, torch.Generator)]
                         + [default_gen]}.values())
        stream = self._registry._stream(dev)
        current = torch.cuda.current_stream(dev)
        try:
            with torch.no_grad():
                snapshot = [t.clone() for t in keep]
            gen_states = [g.get_state() for g in all_gens]
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                self.fn(*args)  # the eager run a capture needs first
                with torch.no_grad():
                    for t, s in zip(keep, snapshot):
                        t.copy_(s)
            for g, s in zip(all_gens, gen_states):
                # put back only what the run drew from: the default
                # generator is another thread's too
                if not torch.equal(g.get_state(), s):
                    g.set_state(s)
            graph = torch.cuda.CUDAGraph()
            for g in all_gens:
                if g.device.type == "cuda" and g is not default_gen:
                    graph.register_generator_state(g)
            versions = [t._version for t in tensors]
            # a collection during the capture could free another program's
            # graph, a call the capture forbids: collect now, then not at all
            gc.collect()
            gc_on = gc.isenabled()
            gc.disable()
            try:
                pool = self._pool.handle(dev) if self._pool is not None else None
                t_cap = time.perf_counter()
                with torch.cuda.graph(graph, pool=pool, stream=stream,
                                      capture_error_mode=CAPTURE_ERROR_MODE):
                    out = self.fn(*args)
                capture_s = time.perf_counter() - t_cap
            finally:
                if gc_on:
                    gc.enable()
            current.wait_stream(stream)
            stream.synchronize()  # done before any stream of any thread uses the state
            del snapshot
        except Exception as e:
            raise RuntimeError(f"program {self.name!r}: CUDA graph capture failed "
                               f"({type(e).__name__}: {e})") from e
        out_leaves: list = []
        out_struct = _flatten(out, out_leaves)
        by_ptr = {(t.data_ptr(), tuple(t.shape), t.stride(), t.dtype): i
                  for i, t in reversed(list(enumerate(tensors)))}
        outs = []
        for x in out_leaves:
            if isinstance(x, torch.Tensor):  # an argument itself, or the graph's own
                i = by_ptr.get((x.data_ptr(), tuple(x.shape), x.stride(), x.dtype))
                outs.append(("in", i) if i is not None else ("pool", x))
            elif isinstance(x, torch.Generator) and any(x is g for g in gens):
                outs.append(("gen", next(k for k, g in enumerate(gens) if x is g)))
            else:
                outs.append(("value", x))
        mutated = {i for i, t in enumerate(tensors) if t._version != versions[i]}
        entry = _Captured(graph, tensors, gens, mutated, outs, out_struct)
        self._registry.store.save(self, mk, entry)
        self.stats["compiles"] += 1  # the reference's compile counter, per program
        self.stats["compile_s"] += time.perf_counter() - t0
        self.stats["capture_s"] += capture_s
        _metrics.record_capture(self.name, time.perf_counter() - t0)
        return entry

    def __call__(self, *args: Any):
        self.stats["calls"] += 1
        leaves: list = []
        struct = _flatten(args, leaves)
        dev = _cuda_device(leaves)
        if dev is None:
            self.stats["eager_calls"] += 1
            return self.fn(*args)
        mk = _memkey(struct, leaves)
        with self._lock:
            entry = self._registry.store.load(self, mk)
            if entry is None:
                entry = self._capture(mk, args, leaves, dev)
            else:
                self.stats["aot_hits"] += 1
            self.stats["replays"] += 1
        return entry.replay(leaves)

    def program_count(self) -> int:
        """Graphs captured so far."""
        return self._registry.store.count(self)


def _cuda_device(leaves: list) -> torch.device | None:
    return next((x.device for x in leaves if isinstance(x, torch.Tensor) and x.is_cuda), None)


class WarmupHandle:
    """A background :meth:`ProgramRegistry.aot_warmup`: :meth:`result`
    joins it and re-raises its failure there, never in the worker."""

    def __init__(self, thread: threading.Thread, box: dict):
        self._thread = thread
        self._box = box

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self, timeout: float | None = None) -> dict:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("aot_warmup still running")
        if "error" in self._box:
            raise self._box["error"]
        return self._box["result"]


class ProgramRegistry:
    """Named hot programs (held weakly) and the store of their graphs."""

    def __init__(self, store: ExecutableStore | None = None):
        self.store = store if store is not None else default_store()
        self._lock = threading.Lock()
        self._programs: dict[str, list] = {}  # name -> [weakref.ref]
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        self._capture_lock = threading.Lock()

    def _stream(self, dev: torch.device) -> torch.cuda.Stream:
        """The side stream every capture on ``dev`` runs on."""
        with self._lock:
            s = self._streams.get(dev)
            if s is None:
                s = self._streams[dev] = torch.cuda.Stream(device=dev)
            return s

    def register(self, name: str, fn: Callable, *, fingerprint: str = "",
                 state: Callable[[], Iterable] | None = None,
                 pool: GraphPool | None = None) -> CachedProgram:
        """A :class:`CachedProgram` for ``fn`` under ``name``;
        ``fingerprint`` tells apart programs of one name whose closures
        differ, ``state`` is what ``fn`` updates in place beside its
        arguments, ``pool`` the :class:`GraphPool` its graphs share."""
        prog = CachedProgram(name, fn, registry=self, fingerprint=fingerprint, state=state,
                             pool=pool)
        with self._lock:
            self._programs.setdefault(name, []).append(weakref.ref(prog))
        return prog

    def _alive(self, name: str) -> list[CachedProgram]:
        with self._lock:
            progs = [p for r in self._programs.get(name, []) if (p := r()) is not None]
            if progs:
                self._programs[name] = [weakref.ref(p) for p in progs]
            else:
                self._programs.pop(name, None)
        return progs

    def names(self) -> list[str]:
        with self._lock:
            names = list(self._programs)
        return sorted(n for n in names if self._alive(n))

    def program(self, name: str) -> CachedProgram:
        """The most recently registered live program under ``name``."""
        progs = self._alive(name)
        if not progs:
            raise KeyError(f"no live program registered as {name!r}")
        return progs[-1]

    def programs(self) -> list[CachedProgram]:
        return [p for n in self.names() for p in self._alive(n)]

    def aot_warmup(self, names: Iterable[str] | None = None, *,
                   programs: Iterable[CachedProgram] | None = None,
                   background: bool = False) -> dict | WarmupHandle:
        """Capture every recorded signature of the named programs (default:
        every live one) or of ``programs``. Returns ``{name: [(source,
        seconds), ...]}``, or a :class:`WarmupHandle` with
        ``background=True``: the thread captures after the work queued so
        far on the caller's current stream, and the caller must leave the
        programs' arguments and state alone until :meth:`WarmupHandle.result`
        returns."""
        if programs is not None:
            todo = list(programs)
        else:
            want = list(names) if names is not None else self.names()
            todo = [p for n in want for p in self._alive(n)]

        def work() -> dict:
            out: dict[str, list] = {}
            for prog in todo:
                with prog._lock:
                    sigs = list(prog._signatures)
                for mk, sig in sigs:
                    with torch.set_grad_enabled(mk[2]):  # as it was recorded
                        out.setdefault(prog.name, []).append(prog.warmup(*sig))
            return out

        if not background:
            return work()
        box: dict = {}
        caller = torch.cuda.current_stream() if torch.cuda.is_available() else None

        def run():
            try:
                with torch.cuda.stream(caller):
                    box["result"] = work()
            except BaseException as e:  # surfaced at .result()
                box["error"] = e

        t = threading.Thread(target=run, name="aot-warmup", daemon=True)
        t.start()
        return WarmupHandle(t, box)

    def stats(self) -> dict:
        """Per name, the stats of its live programs summed, and
        ``executables``: their graphs."""
        out: dict[str, dict] = {}
        for name in self.names():
            agg: dict[str, float] = {}
            n_exec = 0
            for p in self._alive(name):
                n_exec += p.program_count()
                for k, v in p.stats.items():
                    agg[k] = agg.get(k, 0) + v
            agg["executables"] = n_exec
            out[name] = agg
        return out


_default: ProgramRegistry | None = None
_default_lock = threading.Lock()


def get_program_registry() -> ProgramRegistry:
    """The process-default registry (created on first use)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = ProgramRegistry()
        return _default


def set_program_registry(reg: ProgramRegistry | None) -> ProgramRegistry | None:
    """Swap the process default; returns the previous registry."""
    global _default
    with _default_lock:
        prev, _default = _default, reg
        return prev
