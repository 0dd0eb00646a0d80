"""Captured CUDA graphs: the port's counterpart of ``jax.jit``, for
generation and for the training step.

``CapturedFunction(fn)`` runs ``fn`` (a function of tensors, or of nested
tuples, lists and dicts of them) as a ``torch.cuda.CUDAGraph``: one device
program, recorded once for each input signature (tree structure, shapes,
dtypes, device and the values of the non-tensor arguments) and replayed
after that with the new inputs copied into its static buffers.  A
signature's first call is the warm-up PyTorch documents: ``fn`` runs
eagerly on a side stream and its outputs are the call's result, so the
host-side work of a first use (a kernel's shared-memory attribute, cached
host queries, cuBLAS handles) is done before capture.  The second call
captures and replays; every later call replays.  A failed capture raises:
a CUDA call never falls back to eager work.  On CPU tensors ``fn`` is
called eagerly; that is the tests' path, taken only where the caller put
the inputs on the CPU.

The launch counts of ``ops/kernels.py`` count in Python, where a kernel's
wrapper runs, so a replay adds nothing by itself: the launches counted
while a graph was captured (where nothing runs) are taken back and added
again on every replay, so ``launch_counts()`` still counts device
launches.  ``utils/flops.py``'s tally is not replayed; count FLOPs on an
eager call.

Spans (``utils/profiling.py``).  A call opens ``pdr.graphs.warmup``,
``pdr.graphs.capture`` or ``pdr.graphs.replay`` (the copies into the
static inputs and the replay); the seconds inside ``_capture`` add to the
counter ``graphs.capture_s``.  The device spans ``fn`` opens are captured
as marks of the graph, and a replay made while tracing is read from them.

Lifetime.  A graph reads the tensors it was captured with at their
addresses: the model's parameters and buffers, and its own static inputs
and outputs, which live in the graph's private memory pool.  Updating a
parameter in place (an optimizer step, ``load_state_dict``,
``copy_``) is seen by the next replay.  Replacing one (``module.to(dtype)``
or ``.to(device)``, assigning ``param.data``, as ``parallel.full_parameters``
does for a sharded model) leaves the graph reading freed memory: release
the graphs first (``release()``), and capture inside the scope in which the
parameters stay put.  The pools live as long as the ``CapturedFunction``
that owns them (a sampler, a refiner or a train step holds one), or until
``release()`` or the end of a ``with`` block on it.
``fn`` must not write to its inputs, and must not synchronise with the host
(no ``.item()``, no host copy of a device tensor): capture refuses both.

Training (``train/step.py``, ``compiled=True``).  ``fn`` is one whole
update: forward, loss, ``backward()`` and the optimizer's step, with grad
mode on (part of the signature).  A non-tensor argument such as the
optimizer is part of the signature too, compared by identity.  The warm-up
call is a real eager step, so the optimizer's moments exist before the
capture, and it settles the first-use choices (cuDNN's algorithms, a
kernel's shared-memory attribute) outside it.  ``fn`` sets the gradients
to None before its backward, so the captured backward allocates them in the
graph's pool and every replay writes them anew; after a replay the
parameters' ``.grad`` are those pool tensors.  The optimizer must be
capturable (``torch.optim.Adam(capturable=True)``: its step count lives on
the device), and its state must stay where the capture found it:
``utils/weights.py::load_optimizer_state`` refills it in place.  The
backward runs on the autograd engine's thread with the forward's stream as
its current stream, so a hand-written kernel's backward launches on the
capture stream like any other op.  Over an NCCL process group
(``train/step.py::jit_step_for_mesh``) the update also holds the
collectives of the gradients' reduction and of the loss's mean: the
warm-up runs each of them eagerly, so every communicator the update uses
exists before the capture, and every rank captures at the same call.
gloo's collectives cannot be captured.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch
import torch.utils._pytree as pytree

from ..ops import kernels
from . import profiling


class _Graph:
    """One captured signature: the graph, its static inputs and outputs,
    the kernel launches one replay makes and the device spans' marks."""

    def __init__(self, graph, inputs, outputs, launches, capture_ms, marks):
        self.graph = graph
        self.inputs: List[torch.Tensor] = inputs
        self.outputs = outputs
        self.launches: Dict[str, int] = launches
        self.capture_ms = capture_ms
        self.marks: profiling.Marks = marks


class CapturedFunction:
    """``fn`` captured once per input signature and replayed after that.

    ``clone_outputs=True`` returns clones of the static outputs, which the
    caller may keep; with False the call returns the static outputs
    themselves, which the signature's next replay overwrites (a caller that
    feeds one step's output to the next copies nothing it does not need).
    """

    def __init__(self, fn: Callable, *, clone_outputs: bool = True):
        self.fn = fn
        self.clone_outputs = clone_outputs
        self._graphs: Dict[tuple, _Graph] = {}
        self._warm: set = set()
        self._stream = None

    # ---- bookkeeping ------------------------------------------------------
    def release(self) -> None:
        """Drop every graph and its memory pool (the pool's bytes go back to
        PyTorch's cache); the next call of a signature warms up again."""
        for g in self._graphs.values():
            g.marks.read()  # a reading made while tracing
        self._graphs.clear()
        self._warm.clear()

    def __enter__(self) -> "CapturedFunction":
        return self

    def __exit__(self, *exc) -> None:
        """A ``with`` block scopes the graphs: they are released at its end."""
        self.release()

    @property
    def num_graphs(self) -> int:
        return len(self._graphs)

    def stats(self) -> List[dict]:
        """Per captured signature: capture ms (host clock around the
        capture, synchronised) and the kernel launches a replay adds."""
        return [{"capture_ms": g.capture_ms, "launches": dict(g.launches)}
                for g in self._graphs.values()]

    # ---- the call ---------------------------------------------------------
    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
        devices = {t.device for t in tensors}
        if not devices or devices == {torch.device("cpu")}:
            return self.fn(*args)
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"a captured function takes tensors on one CUDA device, "
                             f"got {sorted(map(str, devices))}")
        key = (spec, tuple((tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor)
                           else ("static", x) for x in leaves), torch.is_grad_enabled())
        g = self._graphs.get(key)
        if g is None:
            if key not in self._warm:
                self._warm.add(key)
                return self._warm_up(args)
            g = self._graphs[key] = self._capture(leaves, spec)
        with profiling.span("pdr.graphs.replay"):
            for dst, src in zip(g.inputs, tensors):
                dst.copy_(src)
            profiling.replayed(g.marks)
            g.graph.replay()
        kernels.add_launches(g.launches)
        if self.clone_outputs:
            return pytree.tree_map(
                lambda t: t.clone() if isinstance(t, torch.Tensor) else t, g.outputs)
        return g.outputs

    def _warm_up(self, args):
        """The signature's first call: ``fn`` eagerly on a side stream."""
        cur = torch.cuda.current_stream()
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream), profiling.span("pdr.graphs.warmup"):
            out = self.fn(*args)
        cur.wait_stream(self._stream)
        # the outputs were allocated on the side stream and are used on this one
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(cur)
        return out

    def _capture(self, leaves, spec) -> _Graph:
        t0 = time.perf_counter()
        with profiling.span("pdr.graphs.capture"):
            static = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
            inputs = [x for x in static if isinstance(x, torch.Tensor)]
            static_args = pytree.tree_unflatten(static, spec)
            graph = torch.cuda.CUDAGraph()
            before = kernels.launch_counts()
            try:
                with profiling.capturing() as marks, torch.cuda.graph(graph):
                    outputs = self.fn(*static_args)
                torch.cuda.synchronize()
            except RuntimeError as e:
                name = getattr(self.fn, "__name__", self.fn)
                raise RuntimeError(f"CUDA graph capture of {name} failed: {e}") from e
            finally:
                # nothing ran while the graph was captured: its counts come back
                # with each replay
                after = kernels.launch_counts()
                launches = {n: after[n] - before[n] for n in before if after[n] != before[n]}
                kernels.add_launches({n: -k for n, k in launches.items()})
        seconds = time.perf_counter() - t0
        profiling.COUNTERS["graphs.capture_s"] += seconds
        return _Graph(graph, inputs, outputs, launches, seconds * 1e3, marks)
