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
(`solve_tr_cuda.launches`, `sym_eigh_cuda.launches` and the others) would
stop at the capture: each
graph records how many launches of each counter it holds, the capture's
own count is taken back (a capture launches nothing), and every replay
adds the graph's count.

The JAX package also runs every solver loop as a `lax.while_loop` or
`lax.scan`: one device program, whether its caller jits it or not. The
port's counterpart is `Loop`: a loop's carried state lives in buffers on
the device, and the loop advances it by pieces - a fixed number of steps
in which a finished lane keeps its state through `torch.where`, so the
result does not depend on how the steps are cut into pieces - each piece
captured once into a CUDA graph that reads and writes those buffers in
place, and replayed. Between pieces the host reads the flags the loop
decides on, as many times as the eager loop reads them; what goes away is
the launches in between. CPU tensors, a loop without graphs, and loops
inside `eager_loops()` run the same pieces eagerly.

`device_const` (and `cached`, for tables built from several arrays) makes
a host constant - a numpy array of a structure, a template or an edge
problem - on a device once and hands the same tensor to every later call:
a copy from pageable host memory cannot be captured, and a stage that
reads its constants from this cache copies nothing from the host once it
has run. A graph reads those tensors, so the `StageGraphs` that captures
it keeps each owner whose constants the capture read alive for as long as
it keeps the graph.
"""

from __future__ import annotations

import contextlib
import os
import traceback
import weakref

import torch

_TORCH = os.path.dirname(os.path.abspath(torch.__file__))

# owner (a ProblemStructure, RobotTemplate or EdgeProblem, hashed by
# identity) -> {key: value}; an entry lives as long as its owner.
_CACHE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


# the owners whose cached values the capture in progress has read (a stack:
# one set a capture)
_READ_BY_CAPTURE: list = []


def cached(owner, key, build):
    """build(), made on the first call for (owner, key) and the same
    object on every later one. `key` names the value within its owner: an
    owner's data never changes, so one key always means one value. The
    value must not refer to its owner, or the entry would keep it alive."""
    if _READ_BY_CAPTURE:
        _READ_BY_CAPTURE[-1].add(owner)
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
    from graphik_tpu_torch.ops.eigh import sym_eigh_cuda
    from graphik_tpu_torch.ops.linalg import spd_solve_cuda
    from graphik_tpu_torch.ops.tr_solve import solve_tr_cuda

    return ((solve_tr_cuda, "launches"), (solve_tr_cuda, "anchored_launches"),
            (cost_and_egrad_cuda, "launches"), (ehess_cuda, "launches"),
            (sym_eigh_cuda, "launches"), (spd_solve_cuda, "launches"))


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
    """One captured stage or loop piece: its graph, static inputs and
    outputs, and the launches of each counter it holds."""

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs, self.outputs, self.launches = graph, inputs, outputs, launches

    def replay(self):
        self.graph.replay()
        _add_counters(self.launches)


class StageGraphs:
    """A solver's captured stages, keyed by (stage, input shapes, dtypes,
    device): `run(name, fn, *args)` is fn(*args), through a CUDA graph on a
    card. The args are tensors or dicts of tensors on one device; fn
    returns a dict of tensors and reads nothing else that changes between
    calls. It also holds the buffers and graphs of the `Loop`s run with
    it, and every owner of a cached constant that its graphs read."""

    def __init__(self):
        self.graphs = {}
        self.loops = {}  # (name, device, state and constant signature) -> _LoopBuffers
        self.pools = {}  # device -> the memory pool its graphs share
        self.owners = set()  # owners of the cached constants its graphs read
        self._streams = {}  # device -> the side stream of warm-ups and captures

    def run(self, name, fn, *args):
        leaves, layout = _flatten(args)
        dev = leaves[0].device
        if dev.type != "cuda":
            return fn(*args)
        key = (name, dev, layout, _signature(leaves))
        with torch.cuda.device(dev):
            g = self.graphs.get(key)
            if g is None:
                inputs = [t.clone() for t in leaves]
                stage_args = _unflatten(inputs, layout)
                g, warm = self._capture(name, dev, lambda: fn(*stage_args))
                g.inputs = inputs
                self.graphs[key] = g
                return {k: v.clone() for k, v in warm.items()}
            for buf, t in zip(g.inputs, leaves):
                buf.copy_(t)
            g.replay()
            return {k: v.clone() for k, v in g.outputs.items()}

    def release(self):
        """Drop every graph, loop buffer and held owner, and give the
        graphs' memory pools back to the card (torch.cuda.empty_cache: a
        pool's memory returns only once no graph uses it)."""
        had_pools = bool(self.pools)
        for g in list(self.graphs.values()) + [p for b in self.loops.values()
                                                 for p in b.pieces.values()]:
            g.graph.reset()
        self.graphs, self.loops, self.pools, self.owners, self._streams = {}, {}, {}, set(), {}
        if had_pools:
            torch.cuda.empty_cache()

    def _capture(self, name, dev, fn):
        """Warm-up and capture of fn() (a dict of tensors) -> (the graph,
        the warm-up's outputs). The warm-up runs fn once eagerly on a side
        stream: its launches are real and stay counted."""
        current = torch.cuda.current_stream(dev)
        side = self._streams.get(dev)
        if side is None:
            side = self._streams[dev] = torch.cuda.Stream(dev)
        pool = self.pools.get(dev)
        if pool is None:
            pool = self.pools[dev] = torch.cuda.graph_pool_handle()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm = fn()
        torch.cuda.synchronize(dev)
        before = _read_counters()
        graph = torch.cuda.CUDAGraph()
        failure = None
        _READ_BY_CAPTURE.append(set())
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool)
            try:
                outputs = fn()
            except Exception as err:
                failure = err
            finally:
                self.owners |= _READ_BY_CAPTURE.pop()
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
            raise CaptureError(f"capturing {name!r} into a CUDA graph failed at "
                               f"{_calling_line(failure)}: {failure}") from failure
        current.wait_stream(side)
        return _Graph(graph, None, outputs, captured), warm


def _signature(tensors):
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


# loops made while this is set run eagerly on a card too (eager_loops)
_EAGER_LOOPS = [False]


@contextlib.contextmanager
def eager_loops():
    """Within this block every `Loop` runs its pieces eagerly, on a card
    too: the form a loop's graphs are held against."""
    before = _EAGER_LOOPS[0]
    _EAGER_LOOPS[0] = True
    try:
        yield
    finally:
        _EAGER_LOOPS[0] = before


class _LoopBuffers:
    """A loop's state and constant buffers on its device, and the graphs of
    its pieces, keyed by (piece, static arguments)."""

    def __init__(self, state, consts):
        self.state = {k: v.clone() for k, v in state.items()}
        self.consts = {k: v.clone() for k, v in consts.items()}
        self.pieces = {}


class Loop:
    """A device loop's carried state, advanced by pieces, as a
    `lax.while_loop` carries its state through its body.

    state, consts: dicts of tensors on one device - what the loop carries,
    and what its pieces read and never write. `run(piece, *static)` is
    state.update(piece(state, consts, *static)): a piece returns new values
    for some of the state's keys, with the same shapes and dtypes. `static`
    holds every Python value the piece depends on (counts, parameters,
    flags of the step indices), hashable; the piece is a module-level
    function. The host reads the loop's flags with `read`, and takes its
    results with `take`.

    With `graphs` (a StageGraphs) on a card, the state and constants live
    in buffers that `graphs` keeps per (name, shapes and dtypes): making a
    Loop copies the values in, each (piece, static) is captured on its
    first run - run once eagerly on the buffers (the warm-up, whose results
    that run keeps), then captured - and replayed in place after; a capture
    that fails raises CaptureError. Otherwise (CPU tensors, no graphs, or
    inside `eager_loops()`) each piece runs eagerly.
    """

    def __init__(self, graphs, name, state, consts=None):
        consts = {} if consts is None else consts
        dev = next(iter(state.values())).device
        if graphs is None or dev.type != "cuda" or _EAGER_LOOPS[0]:
            self._graphs, self.state, self.consts = None, dict(state), dict(consts)
            return
        self._graphs, self._dev, self._name = graphs, dev, name
        key = (name, dev, tuple(state), _signature(state.values()), tuple(consts),
               _signature(consts.values()))
        bufs = graphs.loops.get(key)
        if bufs is None:
            bufs = graphs.loops[key] = _LoopBuffers(state, consts)
        else:
            for group, new in ((bufs.state, state), (bufs.consts, consts)):
                for k, v in new.items():
                    group[k].copy_(v)
        self._bufs, self.state, self.consts = bufs, bufs.state, bufs.consts

    def run(self, piece, *static):
        if self._graphs is None:
            self.state.update(_checked(self.state, piece(self.state, self.consts, *static)))
            return
        key = (piece, static)
        g = self._bufs.pieces.get(key)
        if g is not None:
            with torch.cuda.device(self._dev):
                g.replay()
            return
        state, consts = self.state, self.consts

        def fn():
            out = _unaliased(state, _checked(state, piece(state, consts, *static)))
            for k, v in out.items():
                if v is not state[k]:
                    state[k].copy_(v)
            return {}

        with torch.cuda.device(self._dev):
            self._bufs.pieces[key], _ = self._graphs._capture(
                f"{self._name}: {piece.__name__}{static}", self._dev, fn)

    def read(self, key):
        """The state's `key` on the host (a Python number or list): one
        read, which waits for the device."""
        return self.state[key].tolist()

    def take(self, *keys):
        """The state's values of `keys` (a tuple), copies when they live in
        the loop's buffers, which the next run of the loop overwrites."""
        if self._graphs is None:
            return tuple(self.state[k] for k in keys)
        return tuple(self.state[k].clone() for k in keys)


def _checked(state, out):
    for k, v in out.items():
        old = state.get(k)
        if old is None or v.shape != old.shape or v.dtype != old.dtype:
            raise ValueError(f"a loop piece returned {k!r} as {tuple(v.shape)} {v.dtype}, "
                             f"not as the state's "
                             f"{None if old is None else (tuple(old.shape), old.dtype)}")
    return out


def _unaliased(state, out):
    """out, with a copy of each value (other than a buffer itself) that
    shares memory with a buffer: copying the values into the buffers one
    after another would otherwise read one that was already overwritten."""
    ptrs = {v.untyped_storage().data_ptr() for v in state.values()}
    return {k: v.clone() if v is not state[k] and v.untyped_storage().data_ptr() in ptrs else v
            for k, v in out.items()}
