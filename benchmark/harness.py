"""One run of one cell: set-up, the measured window, the traced window, the
check against the plain reference, and the result line.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json``, its configuration (``configs/<config>.json``), its
traffic mix (``traffic/<traffic>.json``), its limits
(``limits/<cell>.json``) and each metric's reader (``metrics/<metric>.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PORT = "open3d_slam_private_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "open3d_slam_private_tpu")


class RunError(Exception):
    """A run that cannot give a result."""


# ---------------------------------------------------------------------------
# The cell's files.
# ---------------------------------------------------------------------------


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Spec:
    root: Path
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    readers: dict


def load_spec(workload: str, root: Path) -> Spec:
    """The cell ``workload`` of ``root/BENCHMARK.json`` and its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moves = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in moves else [])]
    readers = {m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py") for m in e2e + layer}
    return Spec(root, cell, config, traffic, limits, e2e, layer, readers)


def slam_config(d):
    """A configuration dict (nested ``__class__`` entries) -> the objects."""
    if isinstance(d, dict) and "__class__" in d:
        mod, name = d["__class__"].split(":")
        cls = getattr(importlib.import_module(mod), name)
        return cls(**{k: slam_config(v) for k, v in d.items() if k != "__class__"})
    if isinstance(d, list):
        return tuple(slam_config(v) for v in d)
    return d


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: the port's name begins with the last)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# The run.
# ---------------------------------------------------------------------------


class Run:
    def __init__(self, spec: Spec, seed: int, seconds: float, trace: bool, t_start: float,
                 device: str = "cuda"):
        import torch

        self.torch = torch
        self.spec, self.seed, self.seconds, self.trace = spec, int(seed), float(seconds), bool(trace)
        self.t_start = t_start
        self.dev = torch.device(device)
        self.on_card = self.dev.type == "cuda"
        t = spec.traffic
        self.warmup = t["warmup_scans"]
        self.paced = t["arrivals"] == "paced"
        self.rate = t.get("rate_hz")
        if self.paced:
            self.n_scans = self.warmup + int(math.ceil(self.rate * self.seconds))
        else:
            self.n_scans = self.warmup + int(math.ceil(t["max_rate_hz"] * self.seconds))
        self.obs: dict = {}
        self.counts: dict = {}

    # -- set-up ----------------------------------------------------------

    def build_kernels(self) -> None:
        """Every kernel library of the port, one nvcc each, all at once (a
        library already built for its source and flags is found)."""
        if not self.on_card:
            return
        import concurrent.futures

        from open3d_slam_private_tpu_torch.kernels import _build

        names = [p.stem for p in sorted(_build.CSRC.glob("*.cu"))]
        with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
            list(pool.map(_build.build, names))

    def setup(self) -> None:
        import world
        from open3d_slam_private_tpu_torch.ops import pointcloud as pc
        from open3d_slam_private_tpu_torch.slam import realtime as rt

        torch = self.torch
        self.build_kernels()
        self.cfg = slam_config(self.spec.config["slam"])
        self.scene = world.make_scene(self.spec.traffic, self.n_scans, self.dev, self.seed)
        N = self.spec.traffic["sensor"]["points"]
        pin = self.on_card
        self.host_xyz = torch.empty((self.n_scans, N, 3), pin_memory=pin)
        for k in range(self.n_scans):
            fed, _ = world.make_scan(self.scene, k)
            self.host_xyz[k].copy_(fed, non_blocking=True)
        if self.on_card:
            torch.cuda.synchronize()
        ones = torch.ones(N, dtype=torch.bool)
        self.scans = [pc.PointBatch(xyz=self.host_xyz[k], mask=ones, extras={}) for k in range(self.n_scans)]
        if self.trace and self.on_card:
            import tracing as tr

            self.costs = tr.CostRecorder(PORT)
            capture = rt._Graphs._capture

            def counted(fn, capture=capture):
                self.costs.graph += 1
                return capture(fn)

            rt._Graphs._capture = staticmethod(counted)
        self.pipe = rt.RealtimePipeline(self.cfg, poll_every=self.spec.traffic["poll_every"], device=self.dev)
        self._install_hooks()
        # Warm-up: the first scans, back to back (the first captures the graphs).
        for k in range(self.warmup):
            self._dispatch(k)
        self.pipe.poll()
        self._sync()
        self.replays = {}
        if self.pipe._graphs is not None:
            self._graph_hooks()
        self.setup_s = time.time() - self.t_start

    def _sync(self):
        if self.on_card:
            self.torch.cuda.synchronize()

    def _install_hooks(self) -> None:
        """What the check and the metrics read, from the benchmark's side:
        each attempt's host span (``_run_loop_closure``), the loop
        constraints and solves with their inputs (the wrappers below), the
        live bank before and after the sampled scans and the step's last
        motion after each scan (``pipe._state``)."""
        import tracing as tr
        from open3d_slam_private_tpu_torch.slam import place_recognition as pr_mod
        from open3d_slam_private_tpu_torch.slam import pose_graph as pg_mod

        pipe = self.pipe
        self.attempts = tr.HostClock(pipe, "_run_loop_closure")
        self.attempts.on = True
        rng = np.random.default_rng([self.seed & 0xFFFFFFFF, self.seed >> 32, 7])
        # Drawn among the scans a run reaches at the sensor's rate or faster.
        span = min(self.n_scans - self.warmup, int(self.spec.traffic["check"]["insert_span_hz"] * self.seconds))
        self.snap_at = set(int(k) for k in self.warmup + rng.choice(
            span, size=min(self.spec.traffic["check"]["insert_samples"], span), replace=False))
        self.snaps: dict = {}
        self.motions: dict = {}
        self.moved_at: set = set()  # scans whose dispatch moved the live pose and bank
        self.constraints: list = []
        self.solves: list = []
        self.dispatch_clock = tr.DispatchClock(pipe) if self.on_card else None
        move = pipe._move_live_state

        def moved(inc):  # a loop-closure increment applied at this dispatch
            self.moved_at.add(self._k)
            return move(inc)

        pipe._move_live_state = moved
        orig_build = pr_mod.build_loop_closure_constraints

        def build(collection, query_idx, *a, **kw):
            def bank(i):  # copied on the worker's stream, masked after the window
                e = collection.submaps[i]
                return (e.state.cloud.xyz.clone(), e.state.cloud.mask.clone()), np.array(e.anchor)

            banks = {query_idx: bank(query_idx)}
            out = orig_build(collection, query_idx, *a, **kw)
            for c in out:
                banks[c.target_idx] = bank(c.target_idx)
                self.constraints.append(dict(c=c, src=banks[query_idx], tgt=banks[c.target_idx],
                                             t=time.perf_counter()))
            return out

        pr_mod.build_loop_closure_constraints = build
        orig_opt = pg_mod.optimize

        def optimize(graph, cfg=pg_mod.PoseGraphConfig(), *a, **kw):
            out = orig_opt(graph, cfg, *a, **kw)
            g = {f.name: getattr(graph, f.name).detach().cpu().numpy() for f in dataclasses.fields(graph)}
            self.solves.append(dict(graph=g, out=out.poses.detach().double().cpu().numpy(), cfg=cfg,
                                    t=time.perf_counter()))
            return out

        pg_mod.optimize = optimize

    def _graph_hooks(self) -> None:
        import tracing as tr

        g = self.pipe._graphs
        self.replays = {name: tr.ReplayClock(getattr(g, name)) for name in ("step", "rebuild", "seed")}

    def _dispatch(self, k: int) -> None:
        """One scan through ``process_scan`` (scan ``k``, stamped 0.1 k s),
        with the snapshots the check reads."""
        pipe = self.pipe
        st = pipe._state
        self._k = k
        if k in self.snap_at and st is not None:
            b = st.bank.cloud
            self.snaps[k] = dict(before=(b.xyz.clone(), b.mask.clone()), submaps=len(pipe.submaps.submaps),
                                 active=pipe.submaps.active_idx)
        pipe.process_scan(self.scans[k], self.spec.traffic["scan_period_s"] * k)
        st = pipe._state
        self.motions[k] = st.last_motion.clone()
        if k in self.snaps:
            b = st.bank.cloud
            s = self.snaps[k]
            s.update(after=(b.xyz.clone(), b.mask.clone()), submaps_after=len(pipe.submaps.submaps),
                     active_after=pipe.submaps.active_idx)

    # -- the window ------------------------------------------------------

    def window(self) -> None:
        prof = None
        tcfg = self.spec.traffic["trace"]
        if self.dispatch_clock is not None:
            self.dispatch_clock.on = True
        if self.trace:
            for c in self.replays.values():
                c.on = True
        polled0 = self._polled()
        t0 = time.perf_counter()
        t_end = t0 + self.seconds
        trace_at, trace_until = t0 + tcfg["start_share"] * self.seconds, None
        lat, late, polls = [], [], [(t0, polled0)]
        t_prof = float("inf")
        k = self.warmup
        while True:
            now = time.perf_counter()
            if self.trace and prof is None and now >= trace_at:
                t_prof = now
                prof, rng_ctx = self._trace_start()
                trace_until = time.perf_counter() + tcfg["seconds"]
            if prof is not None and trace_until is not None and time.perf_counter() >= trace_until:
                self._trace_stop(prof, rng_ctx)
                trace_until = None
            if self.paced:
                i = k - self.warmup
                if i >= self.n_scans - self.warmup:
                    break
                due = t0 + i / self.rate
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                start = time.perf_counter()
                self._dispatch(k)
                done = time.perf_counter()
                lat.append((done - due) * 1e3)
                late.append((start - due) * 1e3)
            else:
                # The closed loop's window ends at its first poll at or after
                # ``--seconds``: every scan dispatched by then is polled, so
                # the rate takes all the work over all the time.
                if polls[-1][0] >= t_end:
                    break
                if k >= self.n_scans:
                    raise RunError(f"the drive's {self.n_scans} scans ran out inside the window: the "
                                   f"traffic's max_rate_hz is below the system's rate")
                self._dispatch(k)
                p = self._polled()
                if p != polls[-1][1]:
                    polls.append((time.perf_counter(), p))
            k += 1
        t_close = time.perf_counter()
        if prof is not None and trace_until is not None:
            self._trace_stop(prof, rng_ctx)
        if prof is not None:
            self._trace_read()
        self.last_dispatched = k - 1
        self.t_window = (t0, t_end, t_close)
        self.obs.update(
            mode="online" if self.paced else "replay",
            window_s=self.seconds if self.paced else polls[-1][0] - t0,
            latencies_ms=lat, lateness_ms=late,
            polled_in_window=polls[-1][1] - polled0,
            dispatched=k - self.warmup,
        )
        spans = [b - a for a, b in self.attempts.spans if b <= t_close]
        self.obs["attempt_s"] = spans
        self.counts["attempt_s"] = dict(completed=len(spans), mean=float(np.mean(spans)) if spans else None)
        if self.dispatch_clock is not None:
            self.dispatch_clock.on = False
            spans = [(w, h) for a, w, h in self.dispatch_clock.spans if a <= t_close]
            # The profiler slows the host's graph launches from its start to
            # the window's end: a traced run's metric reads the calls before.
            self.obs["dispatch_ms"] = [h * 1e3 for a, w, h in self.dispatch_clock.spans if a <= min(t_close, t_prof)]
            self.counts["dispatch_ms"] = dict(p50=float(np.median([h for _, h in spans]) * 1e3) if spans else None,
                                              staging_wait_p50=float(np.median([w for w, _ in spans]) * 1e3)
                                              if spans else None,
                                              staging_wait_s=float(sum(w for w, _ in spans)), calls=len(spans))
        if self.trace:
            self.obs["step_graph_ms"] = self.replays["step"].ms() if self.replays else []

    def _polled(self) -> int:
        return sum(1 for r in self.pipe.frames if r.stats is not None)

    def _trace_start(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.on_card else [])
        prof = profile(activities=acts)
        prof.start()
        if hasattr(self, "costs"):
            self.costs.on = True
        self._trace_replays = {n: c.replays for n, c in self.replays.items()}
        ctx = record_function("bench.traced_window")
        ctx.__enter__()
        return prof, ctx

    def _trace_stop(self, prof, ctx) -> None:
        self._sync()
        ctx.__exit__(None, None, None)
        if hasattr(self, "costs"):
            self.costs.on = False
        self._traced_replays = {n: c.replays - self._trace_replays[n] for n, c in self.replays.items()}
        prof.stop()
        self._prof = prof

    def _trace_read(self) -> None:
        """The traced window's readings, once the measured window has closed
        (reading the trace takes the host many seconds)."""
        import tracing as tr

        got = tr.read(self._prof)
        self._prof = None
        replays = self._traced_replays
        costs = getattr(self, "costs", None)
        bound = 0.0 if costs is None else costs.eager + sum(
            costs.per_graph.get(i, 0.0) * replays[n] for i, n in enumerate(("step", "rebuild", "seed")))
        got.update(kernel_bound_s=bound, traced_replays=replays)
        self.obs["trace"] = got
        self.counts["traced"] = dict(replays=replays, kernel_device_s=got["kernel_device_s"], kernel_bound_s=bound,
                                     bound_per_graph=None if costs is None else costs.per_graph,
                                     device_events=got["device_events"])

    # -- after the window --------------------------------------------------

    def close(self) -> None:
        """Stop the worker (an attempt in flight runs to its end), drain the
        stats, read the peak memory, keep the program's outputs the check
        reads and free the rest."""
        torch = self.torch
        pipe = self.pipe
        if pipe._lc_thread is not None:
            pipe._lc_stop.set()
            pipe._lc_thread.join(timeout=300)
            if pipe._lc_thread.is_alive():
                raise RunError("the loop-closure worker did not stop within 300 s")
            while not pipe._lc_queue.empty():
                pipe._lc_queue.get_nowait()
        pipe.finish(wait_loop_closures=False)
        self._sync()
        self.memory_peak = int(torch.cuda.max_memory_allocated(self.dev)) if self.on_card else 0
        frames = pipe.frames
        from open3d_slam_private_tpu_torch.slam import realtime as rt

        self.stats = np.stack([r.stats if r.stats is not None else np.full(rt.STATS_LEN, np.nan)
                               for r in frames[1:]]) if len(frames) > 1 else np.zeros((0, rt.STATS_LEN))
        self.poses = np.concatenate([np.eye(4)[None], self.stats[:, :16].reshape(-1, 4, 4)]).astype(np.float64)
        self.inserted = np.concatenate([[True], self.stats[:, rt.IDX_INSERTED] > 0.5])
        window = self.poses[self.warmup:self.last_dispatched + 1]
        self.counts["failed_scans"] = int((~np.isfinite(window).all(axis=(1, 2))).sum())
        self.carved = np.concatenate([[False], self.stats[:, rt.IDX_CARVED] > 0.5])
        d = pipe._state.dense
        self.dense = None if d is None else dict(key_hi=d.key_hi.clone(), key_lo=d.key_lo.clone(),
                                                 count=d.count.clone(), sum_xyz=d.sum_xyz.clone())
        self.counts.update(
            frames=len(frames), graph_replays=pipe.graph_replays, submaps=len(pipe.submaps.submaps),
            carvings=int(self.carved.sum()), inserted=int(self.inserted.sum()),
            attempts=len(pipe.loop_closure_trace),
            attempts_tried=sum(len(t["tried"]) for t in pipe.loop_closure_trace),
            closures_accepted=pipe.loop_closure_count, solves=pipe.pose_graph_solves,
            loop_closure_errors=len(pipe.loop_closure_errors))
        if self.on_card and pipe._graphs is not None:
            import tracing as tr

            self.counts["graph_kernel_nodes"] = {n: tr.graph_kernel_nodes(getattr(pipe._graphs, n))
                                                 for n in ("step", "rebuild", "seed")}
        import costs

        launches = {}
        for mod_name, fns in costs.WRAPPERS.items():
            mod = importlib.import_module(f"{PORT}.kernels.{mod_name}")
            for fn_name in fns:
                n = getattr(getattr(mod, fn_name), "launches", None)
                if n is not None:
                    launches[fn_name] = n
        self.counts["eager_launches"] = launches
        if self.dense is not None:
            occupied = int((self.dense["count"] > 0).sum())
            self.counts["dense_occupied"] = occupied
            self.counts["dense_fill"] = occupied / self.dense["count"].numel()
        lat = self.obs.get("lateness_ms") or [0.0]
        self.counts["generator_lateness_ms"] = dict(max=float(np.max(lat)), p95=float(np.percentile(lat, 95)))
        if self.obs.get("latencies_ms"):
            self.counts["scan_latency_ms"] = dict(p50=float(np.median(self.obs["latencies_ms"])),
                                                  samples=len(self.obs["latencies_ms"]))
        if pipe.loop_closure_errors:
            raise RunError(f"the loop-closure worker failed: {pipe.loop_closure_errors[0]!r}")
        self.pipe = None
        del pipe
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    # -- metrics -----------------------------------------------------------

    def metrics(self) -> dict:
        obs = dict(self.obs, setup_s=self.setup_s)
        wanted = self.spec.per_layer if self.trace else self.spec.end_to_end
        out = {}
        for m in wanted:
            v = self.spec.readers[m["name"]].read(obs)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return out
