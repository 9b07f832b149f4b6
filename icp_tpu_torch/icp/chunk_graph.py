"""The ICP loop's chunk as one CUDA graph (``torch.cuda.CUDAGraph``).

A chunk of the loop (:data:`icp_tpu_torch.icp.run.CHUNK` steps over every
lane) enqueues some 200-280 launches a step from Python, and on the card the
host's launch path, not the device, sets the pace. :class:`ChunkGraph`
captures one chunk once and replays it with one ``cudaGraphLaunch``. It owns
static copies of the chunk's inputs (loop-invariant: the moving sets, the
search targets, the params, the moving normals) and of its carry (each
lane's state and done flag, and whether any lane still runs), the graph,
which runs the chunk's body on them and writes the new carry over the old,
and the graph's private memory pool.

:func:`chunk_graph` keeps the graphs of the last :data:`MAX_GRAPHS` keys
used in the process; a key is what a capture depends on (see
:func:`signature`), so a registration whose shapes and configuration were
seen before copies its tensors into that key's buffers and replays. Like the
span recorder, the cache serves one thread: one registration at a time per
process.

A replay runs the kernels that were captured: a caller that swaps a module's
kernel wrapper for another function calls :func:`clear` first. Each
replay adds the captured chunk's launches to the wrappers' ``launches``
counters, so they count kernel launches whether Python or a graph enqueued
them.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib

import torch

from icp_tpu_torch.runtime.timing import count

MAX_GRAPHS = 4  # keys held; using a fifth evicts the least recently used

_KERNEL_MODULES = ("bin_search", "brute_nn", "fused_gn", "fused_step",
                   "knn_moments", "table_build")


def _parts(x):
    """The parts of a container of the loop's tensors (a dataclass, a
    NamedTuple, a tuple or a list), or None for a leaf."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return list(x)
    return None


def _rebuild(x, parts):
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: p for f, p in zip(dataclasses.fields(x), parts)})
    if hasattr(x, "_fields"):  # a NamedTuple
        return type(x)(*parts)
    return type(x)(parts)


def tree_map(fn, x):
    """``x`` with every tensor ``t`` in it replaced by ``fn(t)``."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    parts = _parts(x)
    return x if parts is None else _rebuild(x, [tree_map(fn, p) for p in parts])


def leaves(x) -> list:
    """The tensors in ``x``, in the order :func:`tree_map` visits them."""
    if isinstance(x, torch.Tensor):
        return [x]
    parts = _parts(x)
    return [] if parts is None else [t for p in parts for t in leaves(p)]


def signature(x):
    """What a capture of code reading ``x`` depends on: each tensor's shape,
    strides, dtype and device, every other leaf (None, a number) by value,
    and each container's type and length. Hashable."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device)
    parts = _parts(x)
    return x if parts is None else (type(x), tuple(signature(p) for p in parts))


def _static(t: torch.Tensor) -> torch.Tensor:
    """A buffer of ``t``'s shape, strides and dtype on its device."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)


def _launch_counters() -> list:
    """Every kernel wrapper with a ``launches`` counter (one call, one
    launch)."""
    found = {}
    for name in _KERNEL_MODULES:
        module = importlib.import_module(f"icp_tpu_torch.kernels.{name}")
        for fn in vars(module).values():
            if callable(fn) and hasattr(fn, "launches"):
                found[id(fn)] = fn
    return list(found.values())


class ChunkGraph:
    """One captured chunk: ``body(inputs, carry) -> carry`` on static copies
    of ``inputs`` and ``carry``, replayed in place.

    Construction copies ``inputs`` and ``carry`` in, runs ``body`` once
    eagerly on a side stream (every kernel and library handle is set up
    there before the capture; the result is dropped, the carry is as it
    was), then captures ``body`` and the copy of its result over
    :attr:`carry` on that stream. After that, :meth:`replay` advances
    :attr:`carry` by one chunk, :meth:`load` starts a new registration and
    :meth:`take` returns the carry's copy."""

    def __init__(self, body, inputs, carry):
        self.device = leaves(carry)[0].device
        self.inputs = tree_map(_static, inputs)
        self.carry = tree_map(_static, carry)
        self._free = torch.cuda.Event()  # recorded once a result is taken
        self._graph = torch.cuda.CUDAGraph()
        self.load(inputs, carry)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        counters = _launch_counters()
        with torch.cuda.stream(side):
            body(self.inputs, self.carry)
            before = [fn.launches for fn in counters]
            self._graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = body(self.inputs, self.carry)
                for dst, src in zip(leaves(self.carry), leaves(out)):
                    dst.copy_(src)
            finally:
                # The capture launched nothing: each replay launches its calls.
                self._launches = [(fn, fn.launches - n) for fn, n in zip(counters, before)
                                  if fn.launches != n]
                for fn, n in zip(counters, before):
                    fn.launches = n
                self._graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(side)

    def load(self, inputs, carry) -> None:
        """Copy a registration's inputs and first carry in, on the current
        stream, after the previous result was taken on any stream."""
        torch.cuda.current_stream(self.device).wait_event(self._free)
        for dst, src in zip(leaves(self.inputs) + leaves(self.carry),
                            leaves(inputs) + leaves(carry)):
            dst.copy_(src)

    def replay(self) -> None:
        """One chunk on the current stream."""
        self._graph.replay()
        count("icp.chunk_graph.replays")
        for fn, n in self._launches:
            fn.launches += n

    def take(self):
        """A copy of the carry, which the next :meth:`load` overwrites."""
        out = tree_map(torch.clone, self.carry)
        self._free.record(torch.cuda.current_stream(self.device))
        return out


_graphs: collections.OrderedDict = collections.OrderedDict()


def chunk_graph(key, body, inputs, carry) -> ChunkGraph:
    """The graph of ``key`` with ``inputs`` and ``carry`` loaded: captured
    now if the key is not held (evicting the least recently used key and its
    memory pool when :data:`MAX_GRAPHS` are), else the held one."""
    graph = _graphs.pop(key, None)
    if graph is None:
        while len(_graphs) >= MAX_GRAPHS:
            _graphs.popitem(last=False)
        graph = ChunkGraph(body, inputs, carry)
        count("icp.chunk_graph.captures")
    else:
        graph.load(inputs, carry)
    _graphs[key] = graph
    return graph


def clear() -> None:
    """Drop every held graph, its buffers and its memory pool."""
    _graphs.clear()
