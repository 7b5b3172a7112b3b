"""Compiled programs: a function over fixed buffers, captured once as a
CUDA graph and replayed.

Counterpart of a jitted function of the JAX package, together with the
serving engine's compile log (``mxnet_tpu/serving/engine.py``
``_compile_log`` and ``compile_counts``, l.1789-1818). A :class:`Program`
owns the operand buffers its function reads; a call copies the caller's
operands into them and runs the function over them.

On a CUDA device the first call makes :data:`WARMUP` runs of the function
on the device's capture stream (so every kernel's first-launch setup, and
every per-stream buffer the kernels keep, exists before capture), puts the
``mutable`` tensors back to their values from before those runs, captures
the function with ``torch.cuda.graph`` on the same stream and replays the
graph; every later call replays it. The function must then keep to what a
graph can hold: fixed addresses (state is updated in place, never
rebound), no host reads of device values, and launch shapes that do not
depend on the operands' values. A capture or a replay that fails raises
``MXNetError`` naming the program; nothing falls back to running the
function uncaptured.

On the CPU a call runs the function over the same buffers, so the tests
here hold the fixed-address discipline that capture needs.

A :class:`ProgramChain` runs programs with host stages between them: a
step whose collectives go over gloo (which a graph cannot hold) is the
captured compute, the host collective on the buffers it wrote, then the
captured update (``ParallelTrainer`` on a mesh across processes).

``capture=False`` (a graph holding a host op: ``operator.PythonOp``,
``torch.TorchModuleOp``) runs the function uncaptured on the card at
every call instead; each such run adds one to the
``program.uncaptured_runs`` telemetry counter.

A program with a ``stats`` name is COUNTED in one uncaptured run (the
first warm-up before the capture; the first run on the CPU, or
uncaptured): its operations and bytes go to
``profiler.register_program``'s registry as ``program.<stats>.flops``
and ``.bytes_accessed``.

Each capture, and on the CPU each program's first call, appends the
program's ``tag`` to ``log`` (the engine's ``compile_counts`` reads it).
The kernel wrappers count a launch when they launch
(``ops.kernels._LAUNCHES``), which inside a capture records a node and
runs nothing: the program keeps the counts its capture added and adds
them again at every replay, so the counts stay the launches that ran.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..ops import kernels
from .. import telemetry as tele

__all__ = ["Program", "ProgramChain", "copy_in"]

# uncaptured runs on the capture stream before the capture
WARMUP = 2

_TM_UNCAPTURED = tele.counter("program.uncaptured_runs")

_STREAMS = {}


def capture_stream(device):
    """The one stream per device on which every program warms up and is
    captured (the kernels' per-stream arrival counts, ``ops.kernels.
    _zeroed_counts``, then live in one buffer that the programs share;
    their replays run one after another on the caller's stream, so no two
    of them use it at once)."""
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device)
    return s


def _host_tensor(v):
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


def copy_in(dst, v):
    """Copy ``v`` (a tensor or an array of ``dst``'s shape; another dtype
    is converted) into ``dst`` without blocking the host: a host value
    through pinned memory (the caching host allocator keeps a pinned block
    until the copy that reads it has run, so the block is never rewritten
    under a pending copy)."""
    src = _host_tensor(v)
    if dst.device.type == "cuda" and src.device.type == "cpu":
        pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        pinned.copy_(src)
        src = pinned
    dst.copy_(src, non_blocking=True)


class Program:
    """``fn()`` over fixed buffers, captured on the card.

    Parameters
    ----------
    fn : callable
        Takes no arguments; reads ``operands`` and the caller's state and
        returns its outputs (a tensor or a sequence of tensors).
    operands : dict name -> tensor, optional
        The buffers ``fn`` reads, on ``device``; a call copies the values
        it is given into them (a host value through pinned memory, one
        copy that does not block the host).
    mutable : sequence of tensors
        The state ``fn`` updates in place; put back after the warm-up runs
        that come before a capture.
    generators : sequence of torch.Generator
        Generators ``fn`` draws from; registered with the graph, so that
        each replay draws as an uncaptured run from the same state would.
    name : str
        Names the program in errors.
    tag : hashable, optional
        What a build appends to ``log`` (default ``name``).
    log : list, optional
        The compile log.
    device : torch.device
    stats : str, optional
        The name the program's count registers under (the profiler's
        ``program.<stats>.*`` gauges); None counts nothing.
    capture : bool
        False runs ``fn`` uncaptured at every call on the card (a graph
        holding a host op).
    """

    def __init__(self, fn, operands=None, mutable=(), generators=(),
                 name="program", tag=None, log=None, device=None,
                 stats=None, capture=True):
        self.name = name
        self.operands = dict(operands or {})
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self._fn = fn
        self._mutable = list(mutable)
        self._generators = list(generators)
        self._tag = name if tag is None else tag
        self._log = log
        self._built = False
        self._graph = None
        self._outs = None
        self._launches = {}
        self._stats = stats
        self._capture_ok = capture

    def __call__(self, **values):
        """Copy ``values`` into the operand buffers of the same names and
        run the program; returns its outputs, which the next call
        overwrites on the card."""
        self.load(**values)
        return self.run()

    def load(self, **values):
        """Copy ``values`` (tensors or arrays of each buffer's shape; a
        value of another dtype is converted) into the operand buffers."""
        for name, v in values.items():
            dst = self.operands.get(name)
            if dst is None:
                raise MXNetError("%s: no operand %r (it has %s)"
                                 % (self.name, name, sorted(self.operands)))
            shape = tuple(np.shape(v))
            if shape != tuple(dst.shape):
                raise MXNetError("%s: operand %r has shape %s, the program "
                                 "was built for %s" % (
                                     self.name, name, shape,
                                     tuple(dst.shape)))
            copy_in(dst, v)

    def run(self):
        """Run over the operands as they stand (replay on the card)."""
        if self.device.type != "cuda" or not self._capture_ok:
            if self.device.type == "cuda":
                _TM_UNCAPTURED.inc()
            if not self._built:
                self._built = True
                self._record()
                return self._counted()
            return self._fn()
        if self._graph is None:
            self._capture()
        try:
            self._graph.replay()
        except RuntimeError as e:
            raise MXNetError("%s: CUDA graph replay failed: %s"
                             % (self.name, e)) from e
        for entry, n in self._launches.items():
            kernels._LAUNCHES[entry] += n
        return self._outs

    def _run_eager(self, **values):
        """``fn`` over the operands, uncaptured, on the caller's stream: a
        check holds the captured program against it. No path of the
        package calls it."""
        self.load(**values)
        return self._fn()

    def _counted(self):
        """``fn()``, counted into the profiler's registry when the program
        has a ``stats`` name."""
        if self._stats is None:
            return self._fn()
        from .. import profiler
        with profiler._count() as cost:
            outs = self._fn()
        profiler._register_counted(self._stats, cost)
        return outs

    def _record(self):
        if self._log is not None:
            self._log.append(self._tag)

    def _capture(self):
        s = capture_stream(self.device)
        saved = [m.clone() for m in self._mutable]
        states = [g.get_state() for g in self._generators]
        s.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(s):
                self._counted()
                for _ in range(WARMUP - 1):
                    self._fn()
                for m, v in zip(self._mutable, saved):
                    m.copy_(v)
            for g, st in zip(self._generators, states):
                g.set_state(st)
                graph.register_generator_state(g)
            before = dict(kernels._LAUNCHES)
            try:
                with torch.cuda.graph(graph, stream=s):
                    outs = self._fn()
            finally:
                added = {e: kernels._LAUNCHES[e] - before[e]
                         for e in before}
                kernels._LAUNCHES.update(before)
        except (RuntimeError, AttributeError, MXNetError) as e:
            raise MXNetError("%s: CUDA graph capture failed: %s"
                             % (self.name, e)) from e
        self._launches = {e: n for e, n in added.items() if n}
        self._graph, self._outs = graph, outs
        self._record()


class ProgramChain:
    """Programs and host stages run in order, one call a step.

    ``stages``: :class:`Program` objects and host callables; a program
    runs (replays on the card) and a host callable takes the previous
    stage's result, so a host collective reads the buffers the program
    before it wrote (gloo orders itself after the producing stream) and
    writes the buffers the program after it reads. The first program owns
    the operands (``load``). ``run()`` returns the last stage's result."""

    def __init__(self, stages, name="chain"):
        self.stages = list(stages)
        self.name = name
        self.programs = [st for st in self.stages
                         if isinstance(st, Program)]
        if not self.programs:
            raise MXNetError("%s: no program among its stages" % name)
        self.operands = self.programs[0].operands

    @property
    def host_stages(self):
        """The host stages a run makes (collectives between programs)."""
        return len(self.stages) - len(self.programs)

    @property
    def captured(self):
        """The programs that run as CUDA graphs (none on the CPU)."""
        return sum(1 for p in self.programs
                   if p._capture_ok and p.device.type == "cuda")

    def load(self, **values):
        self.programs[0].load(**values)

    def run(self):
        val = None
        for st in self.stages:
            val = st.run() if isinstance(st, Program) else st(val)
        return val

    def _run_eager(self, **values):
        """Every program's function uncaptured, with the host stages
        between them (a check holds the chain against it)."""
        self.load(**values)
        val = None
        for st in self.stages:
            val = st._fn() if isinstance(st, Program) else st(val)
        return val
