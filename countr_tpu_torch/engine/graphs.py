"""CUDA graphs of the port's fixed-shape calls (the counterpart of the JAX
package's ``jax.jit``: one compiled program per shape).

``GraphRunner`` captures a function once per key as a
``torch.cuda.CUDAGraph`` and replays it: static input buffers that each
call copies its inputs into, one static output (a tensor, or a dict of
them), one memory pool for all its graphs, one side stream for warm-up
and capture. Replays run on the caller's current stream, one after
another, so graphs that share the pool never run at once. A failed
capture raises; nothing falls back to eager.

Before a capture the function runs eagerly on the side stream (WARMUP
times): Triton compiles B1 there, a CUDA kernel's first launch sets its
shared-memory attribute, cuBLAS gets the side stream's workspace, and the
caches filled at first use (the bf16 weight copies of ``models/vit.py
cast_param``, the head's constants of ``ops.device_constant``) exist
before the capture reads them.

A function with side effects (a training step: it updates parameters,
moments and step counts, and draws from a generator) names them: the
runner's ``mutable`` tensors are saved before the warm-up and copied back
after it, and its ``generators``' states are put back too, so the warm-up
leaves no trace and the first replay makes the first real step. Each
generator is registered with every graph (``register_generator_state``):
a replay draws from the generator's state at that moment and advances it
by what the capture drew, as the eager call would, so every replay draws
fresh values and ``manual_seed`` between replays repeats a draw.

A replay runs no Python, so no kernel wrapper counts it: each graph keeps
the counts its capture recorded (and the wrappers' counters are put back
as they were, since a capture launches nothing), and ``launched`` adds
them up at each replay.

``GraphedForward`` is ``CounTR.forward_tokens`` through a runner, one
graph per (windows, tokens) shape. A graph holds the addresses of the
weights and of their cached bf16 copies, so it is keyed on every
parameter's and buffer's address and version: when weights change
(``load_state_dict``, the weight bridge), every graph is dropped and
captured again. The training and eval steps (``engine/train.py``) cast
inside their graphs instead (``casts_at_use``), so their graphs hold only
the weights' own addresses and stay valid while the optimizer or a
checkpoint restore changes the weights in place.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

from countr_tpu_torch.ops.launches import KERNELS, launch_counts, set_launch_counts
from countr_tpu_torch.utils.profiling import span

WARMUP = 2


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: list
    output: object  # a tensor, or a dict of tensors
    counts: dict  # kernel launches one replay makes


class GraphRunner:
    """``fn(*inputs)`` captured once per ``key`` and replayed.

    ``mutable`` (a callable returning tensors) and ``generators`` name a
    function's side effects, for a training step: see the module's
    docstring."""

    def __init__(self, device: torch.device, mutable=None, generators=()):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device; got {device}")
        self.device = device
        self._stream = torch.cuda.Stream(device)
        self._mutable = mutable
        self._generators = tuple(generators)
        self.zero_counts()
        self.reset()

    def zero_counts(self) -> None:
        """Set ``replays`` and ``launched`` (kernel launches made by
        replays, by kernel id) to 0."""
        self.replays = 0
        self.launched = dict.fromkeys(KERNELS, 0)

    def reset(self) -> None:
        """Drop every graph, and with them their pool."""
        self._graphs: dict = {}
        self._pool = torch.cuda.graph_pool_handle()

    def __len__(self) -> int:
        return len(self._graphs)

    def _warm_up(self, fn, static) -> None:
        """WARMUP eager calls on the side stream; the ``mutable`` tensors
        and the generators' states are as before them afterwards."""
        current = torch.cuda.current_stream(self.device)
        tensors = list(self._mutable()) if self._mutable is not None else []
        with torch.no_grad():
            saved = [t.clone() for t in tensors]
        states = [g.get_state() for g in self._generators]
        self._stream.wait_stream(current)
        try:
            with torch.cuda.stream(self._stream):
                for _ in range(WARMUP):
                    fn(*static)
        finally:
            current.wait_stream(self._stream)
            with torch.no_grad():
                for t, s in zip(tensors, saved):
                    t.copy_(s)
            for g, s in zip(self._generators, states):
                g.set_state(s)
            self._stream.wait_stream(current)

    def _capture(self, fn, inputs) -> _Graph:
        with span("graph.capture"):
            static = [x.clone() for x in inputs]
            self._warm_up(fn, static)
            before = launch_counts()
            graph = torch.cuda.CUDAGraph()
            for g in self._generators:
                graph.register_generator_state(g)
            try:
                # relaxed: a kernel's first launch may set function attributes,
                # which is not a stream operation (the warm-up made those launches)
                with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                      capture_error_mode="relaxed"):
                    output = fn(*static)
                after = launch_counts()
            finally:
                set_launch_counts(before)
        return _Graph(graph, static, output, {k: after[k] - before[k] for k in KERNELS})

    def capture(self, key, fn, *inputs) -> None:
        """Capture ``key``'s graph if there is none, without replaying it
        (for a function with side effects: no step is taken)."""
        if key not in self._graphs:
            self._graphs[key] = self._capture(fn, inputs)

    def __call__(self, key, fn, *inputs):
        """Copy ``inputs`` into the static buffers of ``key``'s graph
        (capturing it first if there is none) and replay it. The output is
        the graph's own buffer, and the graphs share their pool: read it
        before the runner's next replay, of any key."""
        self.capture(key, fn, *inputs)
        g = self._graphs[key]
        with span("graph.replay"):
            for buf, x in zip(g.inputs, inputs):
                buf.copy_(x)
            g.graph.replay()
        self.replays += 1
        for k, v in g.counts.items():
            self.launched[k] += v
        return g.output


class GraphedForward:
    """``model.forward_tokens(windows, y)`` replayed from one CUDA graph
    per input shape, recaptured whenever a parameter or buffer changes."""

    def __init__(self, model):
        self.model = model
        self.runner = GraphRunner(next(model.parameters()).device)
        self._weights = None

    def _signature(self) -> tuple:
        return tuple((t.data_ptr(), t._version)
                     for t in itertools.chain(self.model.parameters(), self.model.buffers()))

    @torch.inference_mode()
    def __call__(self, windows: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with span("graph.check"):
            sig = self._signature()
            if sig != self._weights:
                self.runner.reset()
                self._weights = sig
        key = (tuple(windows.shape), windows.dtype, tuple(y.shape), y.dtype)
        return self.runner(key, self.model.forward_tokens, windows, y)
