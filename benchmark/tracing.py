"""Reading a ``torch.profiler`` trace of a run's traced window: the device's
busy time (the union of its events' intervals, every stream together), the
device operations that took most time, the longest idle gaps by what the
host was doing, and the device time of the port's own kernels; CUDA events
around graph replays; a CUDA graph's kernel nodes (after
``chip_smoke.py``'s ``ReplayClock``, ``busy_ms`` and ``graph_kernel_nodes``)."""

from __future__ import annotations

import contextlib
import ctypes
import time

import torch

import costs

WINDOW = "bench.traced_window"


def _device_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA]


def _window(prof):
    for e in prof.events():
        if e.name == WINDOW and getattr(e, "device_type", None) != _cuda_type():
            return e.time_range.start, e.time_range.end
    raise RuntimeError("the traced window's range is not in the trace")


def _cuda_type():
    from torch.autograd import DeviceType

    return DeviceType.CUDA


def read(prof) -> dict:
    """Busy and window seconds, the top device operations, the longest idle
    gaps and the port's kernels' device seconds by family, inside the
    traced window's range."""
    w0, w1 = _window(prof)
    spans = []
    by_name: dict = {}
    fam_s: dict = {}
    for e in _device_events(prof):
        if e.name.startswith("bench."):  # the window's own range, mirrored on the device
            continue
        a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if b <= a:
            continue
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e6
        fam = costs.kernel_family(e.name)
        if fam is not None:
            fam_s[fam] = fam_s.get(fam, 0.0) + (b - a) / 1e6
    spans.sort()
    busy, end, gaps = 0.0, w0, []
    for a, b in spans:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    host = [e for e in prof.events() if getattr(e, "device_type", None) != _cuda_type()
            and e.time_range.end > w0 and e.time_range.start < w1 and e.name != WINDOW]
    idle = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        inside = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        bench = [e.name for e in inside if e.name.startswith("bench.")]
        inner = min(inside, key=lambda e: e.time_range.end - e.time_range.start).name if inside else "none"
        label = f"{bench[-1] if bench else 'host'}/{inner}" if inner not in bench else inner
        idle.append([label, (b - a) / 1e6])
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return dict(busy_s=busy / 1e6, window_s=(w1 - w0) / 1e6, device_ops=[[k[:120], v] for k, v in top],
                idle_gaps=idle, kernel_device_s=fam_s, device_events=len(spans))


class ReplayClock:
    """CUDA events around every replay of a graph while ``on``: its device
    milliseconds (a graph runs back to back on the device)."""

    def __init__(self, graph):
        self.events = []
        self.replays = 0
        self.on = False
        replay = graph.replay

        def timed():
            self.replays += 1
            if not self.on:
                return replay()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            replay()
            b.record()
            self.events.append((a, b))

        graph.replay = timed

    def ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


class HostClock:
    """Host seconds of each call of a method, kept while ``on``."""

    def __init__(self, obj, name):
        self.spans = []
        self.on = False
        fn = getattr(obj, name)

        def timed(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.spans.append((t, time.perf_counter()))

        setattr(obj, name, timed)


class DispatchClock:
    """Host seconds of each ``RealtimePipeline._replay`` while ``on``, in two
    parts: the wait for the staging rows' last upload (the device's
    backpressure on a host that runs ahead), then the host's own work
    (staging, upload and graph launch). The wait is taken here, just before
    ``_replay`` would take it itself, so the pipeline does the same."""

    def __init__(self, pipe):
        self.spans = []  # (start, wait seconds, work seconds)
        self.on = False
        fn = pipe._replay

        def timed(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            ev = pipe._staging[pipe._staging_next]["event"]
            if ev is not None:
                ev.synchronize()
            t1 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.spans.append((t0, t1 - t0, time.perf_counter() - t1))

        pipe._replay = timed


def graph_kernel_nodes(graph) -> int:
    """Kernel nodes of a kept CUDA graph (libcuda's ``cuGraphGetNodes`` /
    ``cuGraphNodeGetType``)."""
    raw = graph.raw_cuda_graph()
    cu = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(count)) != 0:
        return -1
    nodes = (ctypes.c_void_p * count.value)()
    cu.cuGraphGetNodes(ctypes.c_void_p(raw), nodes, ctypes.byref(count))
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


class CostRecorder:
    """The bound of every call of the port's kernel wrappers: while a graph
    is captured, per graph (in capture order); while ``on``, eager calls.
    Installed over every reference the port's modules hold to a wrapper."""

    def __init__(self, port: str):
        import importlib
        import sys

        self.graph = -1
        self.per_graph: dict = {}
        self.eager = 0.0
        self.on = False
        for mod_name, fns in costs.WRAPPERS.items():
            mod = importlib.import_module(f"{port}.kernels.{mod_name}")
            for fn_name, cost in fns.items():
                orig = getattr(mod, fn_name)
                wrapped = self._wrap(orig, cost)
                for m in list(sys.modules.values()):
                    if getattr(m, "__name__", "").split(".")[0] != port:
                        continue
                    for attr, val in list(vars(m).items()):
                        if val is orig:
                            setattr(m, attr, wrapped)

    def _wrap(self, fn, cost):
        def recorded(*a, **kw):
            if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
                self.per_graph[self.graph] = self.per_graph.get(self.graph, 0.0) + cost(*a, **kw)
            elif self.on:
                self.eager += cost(*a, **kw)
            return fn(*a, **kw)

        recorded.__dict__ = fn.__dict__  # the launch counters stay the wrapper's
        return recorded
