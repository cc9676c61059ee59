"""The benchmark of the port (``open3d_slam_private_tpu_torch``) on one
CUDA card: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up (kernels built or found, the world and the drive made from the
seed, the pipeline's graphs captured, the warm-up scans), measures for
``--seconds`` (``--trace 1``: the per-layer metrics, with a profiled
window inside), checks what the timed path produced against the plain
reference, and prints the result as the last line of its standard output.
Exits with another code than 0, and prints no result, without a card, with
fewer cards than the cell asks for, when a JAX module was loaded, or when
the run fails.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The wall time this process started (from /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Compile caches at fixed paths inside the checkout; no JAX through transformers.
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton_cache"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)


def main(argv=None) -> int:
    import argparse
    import json
    from pathlib import Path

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import harness

    spec = harness.load_spec(args.workload, Path(ROOT))
    need = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: needs {need} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = measure(spec, args.seed, args.seconds, bool(args.trace), "cuda")
    if result is None:
        return 1
    print(json.dumps(result), flush=True)
    return 0


def measure(spec, seed: int, seconds: float, trace: bool, device: str, t_start: float = None):
    """One run -> the result dict (None, with the reason on standard error,
    when it cannot give one)."""
    import json

    import torch

    import compare
    import harness

    torch.set_num_threads(4)  # one process with few threads: a steadier host
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    run = harness.Run(spec, seed, seconds, trace, T_START if t_start is None else t_start, device)
    try:
        run.setup()
        run.window()
        run.close()
    except harness.RunError as e:
        say(f"benchmark: {e}")
        return None
    bad = harness.forbidden_modules()
    if bad:
        say(f"benchmark: JAX modules were loaded: {bad}")
        return None
    metrics = run.metrics()
    print(json.dumps({"counts": run.counts}), flush=True)
    t = time.perf_counter()
    vals, info = compare.numbers(run)
    need = spec.limits.get("minimum", {})
    have = {k: info.get(k, 0) for k in need}
    ok, rows = compare.judge(vals, spec.limits["limits"], {k: (have[k], n) for k, n in need.items()})
    reported = {k: v for k, v in vals.items() if k not in spec.limits["limits"]}
    print(json.dumps({"check_s": time.perf_counter() - t, "reported": reported, "check_info": info}), flush=True)
    dev = torch.device(device)
    out = {
        "correct": bool(ok),
        "attempted": int(run.obs.get("dispatched", 0)),
        "failed": int(run.counts["failed_scans"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": run.memory_peak,
        },
    }
    if trace and "trace" in run.obs:
        tr = run.obs["trace"]
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["checks"] = rows
    for name, row in rows.items():
        say(f"check {name}: {row['value']} (limit {row['limit']})")
    return out


if __name__ == "__main__":
    sys.exit(main())
