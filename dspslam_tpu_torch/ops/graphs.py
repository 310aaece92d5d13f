"""CUDA graphs for the port's host-bound solves: one mechanism for all.

Eagerly such a solve is paced by the host's enqueue of many small ops; a
graph replays it in one launch. An entry point holds an `Entry`, one
`Graphs` per `key` for the process. A key's first call warms each body up
once, in order, on a side stream (capture needs the libraries' handles
and workspaces), then captures one graph per body there (counter
`<name>_graph_capture`); later calls count `<name>_graph_replay`. Inside
an outer capture and on the CPU an entry point runs eagerly (`eager`).

The benchmark taps an entry point by replacing its module attribute, so it
keeps its signature, captures inside itself and returns `Graphs.outputs()`,
clones that no later replay overwrites. Next users (ROADMAP P2b, P1 step 3,
P5): the object GN, the tracker's frame program, the loop closer.
"""

from __future__ import annotations

import torch

from ..utils import timing


def eager(t: torch.Tensor) -> bool:
    """Whether an entry point runs its ops directly: on the CPU, in a capture."""
    return not t.is_cuda or torch.cuda.is_current_stream_capturing()


def key(tensors, *settings) -> tuple:
    """What a graph bakes in: device, TF32 switch, settings, shapes, dtypes."""
    return (tensors[0].device, torch.backends.cuda.matmul.allow_tf32, settings,
            tuple((tuple(x.shape), x.dtype) for x in tensors))


class Graphs:
    """One key's static inputs, static state and graphs. A body is a function
    `(inputs, state) -> state` of the static tensors (state None at first)."""

    def __init__(self, inputs, bodies):
        self.inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=inputs[0].device) for x in inputs)
        self.bodies, self.state, self.graphs = tuple(bodies), None, None

    def load(self, inputs):
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src, non_blocking=True)

    def run(self, body):
        """Run `body` and copy its state into the static state."""
        state = body(self.inputs, self.state)
        if self.state is None:
            self.state = tuple(torch.empty_like(t) for t in state)
        for dst, src in zip(self.state, state):
            dst.copy_(src)   # a no-op where src is dst

    def capture(self):
        current = torch.cuda.current_stream(self.inputs[0].device)
        stream = torch.cuda.Stream(current.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            for body in self.bodies:
                self.run(body)
        current.wait_stream(stream)
        graphs = tuple(torch.cuda.CUDAGraph() for _ in self.bodies)
        for graph, body in zip(graphs, self.bodies):
            with torch.cuda.graph(graph, stream=stream):
                self.run(body)
        self.graphs = graphs

    def outputs(self, n: int | None = None) -> tuple:
        """Clones of the first `n` static state tensors (all by default)."""
        return tuple(t.clone() for t in self.state[:n])


class Entry:
    """An entry point's `Graphs` by key, built from `bodies(*settings)`. A
    test that changes what a body computes empties `cache` first."""

    def __init__(self, name, bodies):
        self.name, self.bodies, self.cache = name, bodies, {}

    def __call__(self, inputs, *settings) -> Graphs:
        """The key's `Graphs`, loaded with `inputs` and ready to replay."""
        k = key(inputs, *settings)
        if k not in self.cache:
            self.cache[k] = Graphs(inputs, self.bodies(*settings))
        graphs = self.cache[k]
        graphs.load(inputs)
        if graphs.graphs is None:
            graphs.capture()
            timing.count(f"{self.name}_graph_capture")
        else:
            timing.count(f"{self.name}_graph_replay")
        return graphs
