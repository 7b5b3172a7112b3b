"""Tracing / profiling.

Counterpart of ``mxnet_tpu/profiler.py``: a stable mxnet-style surface
over ``torch.profiler`` so traces can be captured around any region and
opened in Perfetto or ``chrome://tracing``.

Usage::

    mx.profiler.start("traces")          # or profiler_set_config + start
    ... training steps ...
    path = mx.profiler.stop()            # traces/<...>.pt.trace.json

    with mx.profiler.scope("epoch-3"):   # named sub-regions in the trace
        train_epoch()

The program-cost registry: the port's compiled programs
(``parallel/program.py``: ``ParallelTrainer``'s step, the serving
engine's decode, verify, draft, prefill, copy and handoff programs) are
COUNTED once when they are built, in one uncaptured run (the first
warm-up before a CUDA-graph capture; the first run on the CPU), and
register the count here: ``torch.utils.flop_counter``'s formulas (the
ones ``FlopCounterMode`` applies) for the ATen ops, plus what each
kernel wrapper of ``ops/kernels.py`` adds for its own launch while a
count is active (the kernels launch through ctypes, which a dispatch
mode does not see; PERF.md's bound column counts them the same way). Bytes accessed are each ATen op's
tensor inputs read once and outputs written once (views move nothing),
plus each kernel's operands. ``collect_program_stats`` sets the
``program.<name>.flops`` and ``program.<name>.bytes_accessed`` gauges
that ``/metrics`` shows. Outside a count, a kernel launch pays one
``None`` check.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import threading as _threading
import time as _time
import weakref as _weakref

import torch

from . import telemetry

__all__ = ["profiler_set_config", "start", "stop", "scope",
           "device_memory_profile", "record_step", "reset_step_stats",
           "get_step_stats", "benchmark_chain", "compiled_stats",
           "collecting", "register_program", "collect_program_stats",
           "registered_programs", "device_memory"]

_state = {"dir": None, "running": False, "prof": None, "traces": 0}


def profiler_set_config(output_dir: str):
    """Configure the trace output directory before :func:`start`."""
    _state["dir"] = output_dir


def start(output_dir: str | None = None):
    """Begin capturing a host trace, and a device trace (CUPTI) on a
    process that can see a card."""
    if output_dir is not None:
        _state["dir"] = output_dir
    if _state["dir"] is None:
        raise ValueError("profiler: no output dir configured")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _state["prof"] = prof
    _state["running"] = True


def stop():
    """End the capture and write it to the output directory as a Chrome
    trace; returns the file's path (None when nothing was running)."""
    if not _state["running"]:
        return None
    prof = _state["prof"]
    prof.__exit__(None, None, None)
    _state["running"] = False
    _state["prof"] = None
    _state["traces"] += 1
    os.makedirs(_state["dir"], exist_ok=True)
    path = os.path.join(_state["dir"], "mxnet_tpu_torch.%d.%d.pt.trace.json"
                        % (os.getpid(), _state["traces"]))
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def scope(name: str):
    """Annotate a named region: a ``torch.profiler.record_function`` (in
    the :func:`start` trace), an NVTX range on a process that can see a
    card, AND an ``mx.telemetry`` span (in the ``MXNET_TRACE_DIR``
    host-side Chrome trace) — one ``with`` statement marks the region in
    every capture, so the timelines line up by name."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            with telemetry.span(name, cat="profiler.scope"):
                yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def device_memory_profile() -> bytes:
    """Snapshot of the card's caching allocator: the pickled dict of
    ``torch.cuda.memory._snapshot()`` (its ``segments`` with every block
    and ``device_traces``; load with ``pickle.loads``, view with PyTorch's
    ``torch/cuda/_memory_viz.py``). The JAX package returns pprof bytes
    instead. On a process that never touched CUDA: empty lists."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        snap = torch.cuda.memory._snapshot()
    else:
        snap = {"segments": [], "device_traces": []}
    return pickle.dumps(snap)


# ---------------------------------------------------------------------------
# step statistics (Speedometer-adjacent, but library-level: accumulates
# step wall-times so regressions are visible without a trace viewer)

_steps = {"times": []}


@contextlib.contextmanager
def record_step():
    """Time one training step:  ``with mx.profiler.record_step(): step()``.
    Includes the device's time only if the caller waits for it (as
    FeedForward's metric update does); pair with get_step_stats()."""
    tic = _time.perf_counter()
    try:
        yield
    finally:
        _steps["times"].append(_time.perf_counter() - tic)


def reset_step_stats():
    _steps["times"] = []


def get_step_stats():
    """dict(count, mean_ms, p50_ms, p99_ms, total_s) over recorded steps."""
    ts = sorted(_steps["times"])
    if not ts:
        return {"count": 0, "mean_ms": 0.0, "p50_ms": 0.0, "p99_ms": 0.0,
                "total_s": 0.0}
    n = len(ts)
    return {
        "count": n,
        "mean_ms": 1e3 * sum(ts) / n,
        "p50_ms": 1e3 * ts[n // 2],
        "p99_ms": 1e3 * ts[min(n - 1, (99 * n) // 100)],
        "total_s": sum(ts),
    }


# ---------------------------------------------------------------------------
# the two-chain methodology as a library API: time two DEPENDENT chain
# lengths that each end in a real host read of the state and difference
# them, cancelling the constant dispatch and flush overhead

def _first_tensor(state):
    leaves = torch.utils._pytree.tree_leaves(state)
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            return leaf
        if hasattr(leaf, "_tensor"):    # an NDArray
            return leaf._tensor
    raise ValueError("benchmark_chain: the state holds no tensor")


def benchmark_chain(step_fn, state, *, steps=15, reps=3,
                    fetch=None):
    """Seconds per call of ``state = step_fn(state)``.

    ``step_fn`` MUST thread its output back as its input — that data
    dependence is what makes the timing honest. ``fetch(state)`` forces
    completion (default: a host read of the first element of the state's
    first tensor). Returns ``(seconds_per_step, spread)`` where spread is
    the relative max-min range across ``reps`` measurements — distrust
    results with spread > 0.1.
    """
    if fetch is None:
        def fetch(s):
            _first_tensor(s).reshape(-1)[:1].cpu()

    def chain(n, s):
        tic = _time.perf_counter()
        for _ in range(n):
            s = step_fn(s)
        fetch(s)
        return _time.perf_counter() - tic, s

    _, state = chain(3, state)  # warm-up
    diffs = []
    for _ in range(reps):
        t1, state = chain(steps, state)
        t2, state = chain(2 * steps, state)
        if t2 - t1 > 0:
            diffs.append((t2 - t1) / steps)
    if not diffs:
        raise RuntimeError(
            "benchmark_chain: no positive chain difference — rerun, or "
            "raise `steps` so compute dominates the flush-cost variance")
    dt = float(sorted(diffs)[len(diffs) // 2])
    spread = (max(diffs) - min(diffs)) / dt if len(diffs) > 1 else 0.0
    return dt, spread


# ---------------------------------------------------------------------------
# counting: one dispatch mode for the ATen ops' operations and bytes, and
# the kernel wrappers' own reckoning (ops.kernels._COST)

_collecting = _threading.local()


def collecting():
    """True on the thread currently counting a program."""
    return getattr(_collecting, "active", False)


def _nbytes(x):
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


class _CostMode(torch.utils._python_dispatch.TorchDispatchMode):
    """Adds each ATen op's operations (``torch.utils.flop_counter``'s
    formulas, the ones FlopCounterMode applies: products, convolutions,
    attention) to ``cost["flops"]`` and its tensor inputs and outputs (read
    once, written once) to ``cost["bytes_accessed"]``; views and fresh
    allocations move nothing. One dispatch a op: a count runs on the
    program's build path."""

    _SKIP = ("empty", "empty_like", "empty_strided", "detach", "alias",
             "lift_fresh")

    @classmethod
    def _should_skip_dynamo(cls):
        # a count runs eagerly, never under torch.compile: without this a
        # mode's first dispatch imports torch._dynamo (seconds, once a
        # process)
        return False

    def __init__(self, cost):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flops = flop_registry
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        formula = self.flops.get(packet)
        if formula is not None:
            self.cost["flops"] += float(formula(*args, **kwargs,
                                                out_val=out))
        if not (func.is_view or packet.__name__ in self._SKIP):
            self.cost["bytes_accessed"] += _nbytes(list(args)) \
                + _nbytes(list(kwargs.values())) + _nbytes(out)
        return out


@contextlib.contextmanager
def _count():
    """Count what runs inside: yields the dict that ends up holding
    ``flops`` and ``bytes_accessed``."""
    from .ops import kernels
    cost = {"flops": 0.0, "bytes_accessed": 0.0}
    prev = kernels._COST
    kernels._COST = cost
    _collecting.active = True
    try:
        with _CostMode(cost):
            yield cost
    finally:
        kernels._COST = prev
        _collecting.active = False


def compiled_stats(compiled):
    """FLOPs, bytes accessed and the operands' sizes of one run of
    ``compiled``: an Executor (its forward, ``is_train=False``) or a
    callable taking no arguments (run once, counted). Returns
    ``{"flops", "bytes_accessed", "argument_size_in_bytes",
    "output_size_in_bytes"}`` (the last two for an Executor). It never
    resets the card's peak-memory counter (the JAX package's temp-size
    analysis has no counterpart here)."""
    out = {}
    if hasattr(compiled, "arg_arrays") and hasattr(compiled, "forward"):
        exe = compiled
        with _count() as cost:
            with torch.no_grad():
                exe.forward(is_train=False)
        out["argument_size_in_bytes"] = int(sum(
            _nbytes(a._tensor) for a in list(exe.arg_arrays)
            + list(exe.aux_arrays)))
        out["output_size_in_bytes"] = int(sum(_nbytes(o._tensor)
                                              for o in exe.outputs))
    else:
        with _count() as cost:
            compiled()
    out["flops"] = cost["flops"]
    out["bytes_accessed"] = cost["bytes_accessed"]
    return out


# ---------------------------------------------------------------------------
# the program registry: name -> counted stats (a program counts itself at
# its build and registers the count); register_program also takes a
# callable and its arguments, counted at once (eager) or at the next
# collection (held by weak reference, as the JAX package holds its jit
# wrappers)

_programs = {}          # name -> ("stats", dict) | ("fn", weakref, args)
_collected_stats = {}   # name -> stats dict, gauges set


def _set_gauges(name, stats):
    for k, v in stats.items():
        telemetry.gauge("program.%s.%s" % (name, k)).set(v)
    _collected_stats[name] = dict(stats)


def _register_counted(name, stats):
    """A program's own count, made at its build (``parallel/program.py``):
    registered and its gauges set at once."""
    _programs[name] = ("stats", dict(stats))
    _set_gauges(name, stats)


def register_program(name, fn, args, eager=True):
    """Register a program for introspection: ``fn(*args)`` is run once
    under a count (``eager=True``, the default: the gauges are set here)
    or at the next :func:`collect_program_stats` (``fn`` then held by
    weak reference; a dropped owner's registration is pruned).
    Re-registering a name (a rebuild) replaces its stats. Introspection
    never raises."""
    args = tuple(args)
    if eager:
        try:
            with _count() as cost:
                fn(*args)
        except Exception:
            return
        _register_counted(name, cost)
        return
    try:
        ref = _weakref.ref(fn)
    except TypeError:
        ref = (lambda f: (lambda: f))(fn)
    _programs[name] = ("fn", ref, args)
    _collected_stats.pop(name, None)


def collect_program_stats(compile=False):
    """Set the ``program.<name>.*`` gauges of every registered program
    not collected yet; returns ``{name: {stat: value}}`` for those.
    ``compile`` is accepted for the JAX signature: a count here is
    already of the program that runs."""
    out = {}
    for name, entry in list(_programs.items()):
        if name in _collected_stats:
            continue
        if entry[0] == "stats":
            _set_gauges(name, entry[1])
            out[name] = dict(entry[1])
            continue
        fn = entry[1]()
        if fn is None:              # owner dropped: prune
            _programs.pop(name, None)
            continue
        try:
            with _count() as cost:
                fn(*entry[2])
        except Exception:
            continue
        _set_gauges(name, cost)
        out[name] = dict(cost)
    return out


def registered_programs():
    """Names currently registered for introspection."""
    return sorted(_programs)


# ---------------------------------------------------------------------------
# device memory: the caching allocator's counters of every card this
# process initialized, and the live tensor census's watermark

_dev_peak = {"live": 0.0}


def device_memory():
    """Device-memory occupancy, refreshed into ``device.*`` gauges and
    returned as a dict: ``bytes_in_use`` (``torch.cuda.memory_allocated``),
    ``peak_bytes_in_use`` (``max_memory_allocated``; read, never reset),
    ``bytes_reserved`` and ``bytes_limit`` (the card's total memory),
    summed over the cards this process initialized, and the live
    watermark ``live_array_peak_bytes``. Empty on a process that never
    touched CUDA."""
    out = {}
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return out
    devs = range(torch.cuda.device_count())
    in_use = sum(torch.cuda.memory_allocated(d) for d in devs)
    out["bytes_in_use"] = in_use
    out["peak_bytes_in_use"] = sum(torch.cuda.max_memory_allocated(d)
                                   for d in devs)
    out["bytes_reserved"] = sum(torch.cuda.memory_reserved(d) for d in devs)
    out["bytes_limit"] = sum(torch.cuda.get_device_properties(d).total_memory
                             for d in devs)
    _dev_peak["live"] = max(_dev_peak["live"], float(in_use))
    out["live_array_peak_bytes"] = _dev_peak["live"]
    for k, v in out.items():
        telemetry.gauge("device." + k).set(v)
    return out
