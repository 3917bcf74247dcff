"""The compiled solver's execution model: CUDA graphs, captured once per
input shape and replayed, and the device constants that capture needs.

The JAX package jits its solver's stages (graphik_tpu/api.py make_solver
and solve_ik_jit, graphik_tpu/parallel/mesh.py make_restart_solver): each
stage is one compiled device program, traced once per input shape. The
port's counterpart is a CUDA graph per stage (`StageGraphs`): the first
call with a new (stage, input shapes, dtypes, device) runs the stage once
eagerly on a side stream (the warm-up, which also builds every cached
constant and library handle; its results are that call's) and captures it
into a `torch.cuda.CUDAGraph` whose memory pool the solver's graphs on
that device share; every later call copies its inputs into the graph's
static buffers and replays it. Each call returns clones of the outputs, so
a caller that keeps one call's results never sees them change, as with
JAX's fresh arrays. A replay runs the captured kernels with the captured
arguments, so its results are the eager stage's, bit for bit, and each
call launches each kernel of the stage once, the first one too.

CPU tensors run the stage eagerly: that is the device the caller asked
for. On a card a capture that fails raises `CaptureError`, naming the
stage and the line that called the operator that failed (the innermost
frame outside torch, with its source); there is no eager retry.

Python does not run on a replay, so the kernels' launch counters
(`solve_tr_cuda.launches` and the others) would stop at the capture: each
graph records how many launches of each counter it holds, the capture's
own count is taken back (a capture launches nothing), and every replay
adds the graph's count.

`device_const` (and `cached`, for tables built from several arrays) makes
a host constant - a numpy array of a structure, a template or an edge
problem - on a device once and hands the same tensor to every later call:
a copy from pageable host memory cannot be captured, and a stage that
reads its constants from this cache copies nothing from the host once it
has run.
"""

from __future__ import annotations

import os
import traceback
import weakref

import torch

_TORCH = os.path.dirname(os.path.abspath(torch.__file__))

# owner (a ProblemStructure, RobotTemplate or EdgeProblem, hashed by
# identity) -> {key: value}; an entry lives as long as its owner.
_CACHE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def cached(owner, key, build):
    """build(), made on the first call for (owner, key) and the same
    object on every later one. `key` names the value within its owner: an
    owner's data never changes, so one key always means one value. The
    value must not refer to its owner, or the entry would keep it alive."""
    per_owner = _CACHE.get(owner)
    if per_owner is None:
        per_owner = _CACHE[owner] = {}
    if key not in per_owner:
        per_owner[key] = build()
    return per_owner[key]


def device_const(owner, key, value, dtype=None, device=None):
    """`value` (what torch.as_tensor takes: a numpy array, a list, a
    number) as a tensor of `dtype` on `device`, made once per (owner, key,
    dtype, device) by `cached`. The tensor is shared: read it, never write
    it."""
    device = None if device is None else torch.device(device)
    return cached(owner, (key, dtype, device),
                  lambda: torch.as_tensor(value, dtype=dtype, device=device))


def _counters():
    """The kernels' launch counters: (wrapper function, attribute)."""
    from graphik_tpu_torch.ops.edge import cost_and_egrad_cuda, ehess_cuda
    from graphik_tpu_torch.ops.tr_solve import solve_tr_cuda

    return ((solve_tr_cuda, "launches"), (solve_tr_cuda, "anchored_launches"),
            (cost_and_egrad_cuda, "launches"), (ehess_cuda, "launches"))


def _read_counters():
    return [getattr(f, a) for f, a in _counters()]


def _add_counters(counts):
    for (f, a), n in zip(_counters(), counts):
        setattr(f, a, getattr(f, a) + n)


class CaptureError(RuntimeError):
    """A stage could not be captured into a CUDA graph (an operation that
    synchronises with the host, or copies from pageable host memory)."""


def _flatten(args):
    """Positional args, each a tensor or a dict of tensors -> (tensors,
    layout)."""
    leaves, layout = [], []
    for a in args:
        if isinstance(a, dict):
            layout.append(tuple(a))
            leaves.extend(a.values())
        else:
            layout.append(None)
            leaves.append(a)
    return leaves, tuple(layout)


def _unflatten(leaves, layout):
    args, i = [], 0
    for keys in layout:
        if keys is None:
            args.append(leaves[i])
            i += 1
        else:
            args.append(dict(zip(keys, leaves[i:i + len(keys)])))
            i += len(keys)
    return args


def _calling_line(err):
    """'file:line: source' of the innermost frame of err's traceback that
    is not torch's own: the line that called the operator that failed."""
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if not f.filename.startswith(_TORCH) and f.filename != __file__]
    if not frames:
        return "?"
    f = frames[-1]
    return f"{f.filename}:{f.lineno}: {f.line}"


class _Graph:
    """One captured stage: its graph, static inputs and outputs, and the
    launches of each counter it holds."""

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs, self.outputs, self.launches = graph, inputs, outputs, launches


class StageGraphs:
    """A solver's captured stages, keyed by (stage, input shapes, dtypes,
    device): `run(name, fn, *args)` is fn(*args), through a CUDA graph on a
    card. The args are tensors or dicts of tensors on one device; fn
    returns a dict of tensors and reads nothing else that changes between
    calls."""

    def __init__(self):
        self.graphs = {}
        self.pools = {}  # device -> the memory pool its graphs share
        self._streams = {}  # device -> the side stream of warm-ups and captures

    def run(self, name, fn, *args):
        leaves, layout = _flatten(args)
        dev = leaves[0].device
        if dev.type != "cuda":
            return fn(*args)
        key = (name, dev, layout, tuple((tuple(t.shape), t.dtype) for t in leaves))
        with torch.cuda.device(dev):
            g = self.graphs.get(key)
            if g is None:
                self.graphs[key], out = self._capture(name, fn, leaves, layout, dev)
                return out
            for buf, t in zip(g.inputs, leaves):
                buf.copy_(t)
            g.graph.replay()
            _add_counters(g.launches)
            return {k: v.clone() for k, v in g.outputs.items()}

    def _capture(self, name, fn, leaves, layout, dev):
        """Warm-up and capture of fn on a copy of the inputs -> (the graph,
        clones of the warm-up's outputs)."""
        current = torch.cuda.current_stream(dev)
        side = self._streams.get(dev)
        if side is None:
            side = self._streams[dev] = torch.cuda.Stream(dev)
        pool = self.pools.get(dev)
        if pool is None:
            pool = self.pools[dev] = torch.cuda.graph_pool_handle()
        inputs = [t.clone() for t in leaves]
        args = _unflatten(inputs, layout)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm = fn(*args)  # the warm-up: its launches are real and stay counted
        torch.cuda.synchronize(dev)
        before = _read_counters()
        graph = torch.cuda.CUDAGraph()
        failure = None
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool)
            try:
                outputs = fn(*args)
            except Exception as err:
                failure = err
            finally:
                captured = [a - b for a, b in zip(_read_counters(), before)]
                _add_counters([-n for n in captured])
                try:
                    graph.capture_end()
                except RuntimeError as err:
                    failure = failure or err  # an invalid capture ends in an error too
        if failure is not None:
            # an invalid capture can leave its pool marked as recording, and
            # the pool's next capture would refuse it: the next capture takes
            # a new pool and stream
            del self.pools[dev], self._streams[dev]
            raise CaptureError(f"capturing stage {name!r} into a CUDA graph failed at "
                               f"{_calling_line(failure)}: {failure}") from failure
        current.wait_stream(side)
        return _Graph(graph, inputs, outputs, captured), {k: v.clone() for k, v in warm.items()}
