"""CUDA graphs over the denoise step's two model evaluations, BrushNet and
the UNet: one graph per module and step shape, captured at the shape's
first step and replayed at every later one, so that a step costs its
device time and two graph launches instead of ~1,770 eager launches.

`StepGraphs(modules, max_keys)` puts a `GraphedForward` on each module instance as
its `forward`.  `module(...)` therefore still runs the module's hooks, and
a span around the call still encloses the graph's launch.  A call without
`graph_key` runs the module's own forward, unchanged.  A call with
`graph_key=K`:

- at K's first sighting, runs the forward once eagerly on a side stream
  (kernel libraries load, cuDNN and cuBLAS set up, at the real inputs),
  captures it into a graph whose memory comes from the one pool every
  graph of the `StepGraphs` shares (they never run at once), and replays it;
- afterwards, copies the call's tensors into the graph's static inputs
  (one `_foreach_copy_`) and replays.

It returns the graph's static outputs: they hold until the next replay of
any graph of the `StepGraphs` (a later capture may have put its
temporaries where an earlier graph's outputs lie), so a caller consumes
them within its step and keeps none.

At most `max_keys` keys hold graphs: a new key past that drops the graphs
of the key used least recently (their static inputs and outputs go back
to the allocator and the pool), so a caller whose shapes keep changing
recaptures, and its memory stays bounded.

A graph fixes what the forward decided on the host at capture: the shapes,
dtypes and non-tensor arguments (the key must determine them; a replay
whose arguments differ raises), the routing of each attention and norm,
and the weights' addresses.  Moving the modules or replacing their
parameters needs `clear()`.

The kernel wrappers count the launches the host makes (`.launches`): the
warm-up and the capture of a key, and no replay.  What a replay ran shows
in a profiler trace, as the kernels under its `cudaGraphLaunch`.
"""

from __future__ import annotations

import collections
from typing import Iterable

import torch
from torch.utils import _pytree as pytree


def _signature(leaves) -> tuple:
    return tuple((x.shape, x.dtype, x.device) if isinstance(x, torch.Tensor) else x
                 for x in leaves)


class _Graph:
    __slots__ = ("graph", "spec", "signature", "inputs", "outputs")


class GraphedForward:
    """A module's `forward` that captures and replays CUDA graphs by key
    (see the module's doc)."""

    def __init__(self, module: torch.nn.Module, owner: "StepGraphs"):
        self.module, self.owner = module, owner
        self.fn = type(module).forward.__get__(module)
        self.graphs = {}

    def __deepcopy__(self, memo):
        # a copied module (a data-parallel replica) gets a graphed forward of
        # its own, with no graphs: a graph holds the original's addresses
        return GraphedForward(memo[id(self.module)], self.owner)

    def __call__(self, *args, graph_key=None, **kwargs):
        if graph_key is None:
            return self.fn(*args, **kwargs)
        leaves, spec = pytree.tree_flatten((args, kwargs))
        self.owner.use(graph_key)
        g = self.graphs.get(graph_key)
        if g is None:
            g = self.graphs[graph_key] = self._capture(leaves, spec)
            self.owner.captures += 1
        else:
            if spec != g.spec or _signature(leaves) != g.signature:
                raise ValueError(f"graph key {graph_key!r} was captured for other arguments")
            torch._foreach_copy_(g.inputs, [x for x in leaves if isinstance(x, torch.Tensor)])
        g.graph.replay()
        self.owner.replays += 1
        return g.outputs

    def _capture(self, leaves, spec) -> _Graph:
        g = _Graph()
        g.spec, g.signature = spec, _signature(leaves)
        static = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        g.inputs = [x for x in static if isinstance(x, torch.Tensor)]
        args, kwargs = pytree.tree_unflatten(static, spec)
        _warm_up(self.fn, args, kwargs)
        g.graph, g.outputs = _record(self.fn, args, kwargs, self.owner)
        return g


def _warm_up(fn, args, kwargs) -> None:
    """fn run eagerly once on a side stream, so that what it sets up at its
    first call at these shapes is set up before the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args, **kwargs)
    torch.cuda.current_stream().wait_stream(side)


def _record(fn, args, kwargs, owner: "StepGraphs"):
    """fn captured into a CUDA graph on the owner's pool -> (graph, outputs)."""
    if owner.pool is None:
        owner.pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    # thread_local: the server's handler threads may call CUDA meanwhile
    with torch.cuda.graph(graph, pool=owner.pool, capture_error_mode="thread_local"):
        outputs = fn(*args, **kwargs)
    return graph, outputs


class StepGraphs:
    """The graphs of a pipeline's denoise-step modules, at most `max_keys`
    keys of them, and their counters: `captures` and `replays` (graphs),
    `eager_steps` (the steps that ran without graphs, `count_eager`)."""

    def __init__(self, modules: Iterable[torch.nn.Module], max_keys: int):
        if max_keys < 1:
            raise ValueError("max_keys must be >= 1")
        self.modules = list(modules)
        self.max_keys = max_keys
        self.keys = collections.OrderedDict()   # the keys with graphs, least recent first
        self.pool = None
        self.captures = self.replays = self.eager_steps = 0
        for m in self.modules:
            m.forward = GraphedForward(m, self)

    def use(self, key) -> None:
        """key as the most recent; a new key past `max_keys` drops the
        least recent key's graphs."""
        if key in self.keys:
            self.keys.move_to_end(key)
            return
        if len(self.keys) >= self.max_keys:
            old, _ = self.keys.popitem(last=False)
            for m in self.modules:
                m.forward.graphs.pop(old, None)
        self.keys[key] = None

    def count_eager(self) -> None:
        self.eager_steps += 1

    def stats(self) -> dict:
        return {"captures": self.captures, "replays": self.replays,
                "eager_steps": self.eager_steps}

    def clear(self) -> None:
        """Drop every graph (their memory returns to the allocator's cache)."""
        for m in self.modules:
            m.forward.graphs.clear()
        self.keys.clear()
        self.pool = None

    def close(self) -> None:
        """Drop the graphs and give each module its own forward back."""
        self.clear()
        for m in self.modules:
            del m.forward


def graph_mode(module: torch.nn.Module, key) -> str:
    """The `graph` attribute of a step's span: "eager" without a key, else
    what the module's graphed forward will do with it."""
    if key is None:
        return "eager"
    return "replay" if key in module.forward.graphs else "capture"


def step_key(rows: int, latent_hw, embeds_shape, dtype: torch.dtype, do_cfg: bool,
             guess_mode: bool, dedup: bool, cond_scale: float) -> tuple:
    """The key of a denoise step's graphs: everything that fixes the shapes
    and the host-side choices of the BrushNet and UNet calls."""
    return (int(rows), tuple(latent_hw), tuple(embeds_shape), dtype, bool(do_cfg),
            bool(guess_mode), bool(dedup), float(cond_scale))
