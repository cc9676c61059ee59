"""Where a relocalisation seed's result starts to depend on the batch it
runs in, on a CUDA card.

    python3 tests/torch_batch_dependence.py

Runs the relocalisation burst's chain (``chip_smoke.hypotheses_setup``:
4,096 seeds, a 512-point skeleton, the brute_pallas matcher, against the
smoke's headline reference) on every seed and on the first 64, and records
each iteration's intermediates of those 64 problems in both runs. It does
so twice: with the normal equations of ``normal_eq``'s plain version (two
cuBLAS einsums, whose reduction order depends on the batch) and with
``normal_eq``. For each it prints the first (iteration, op) where the two
runs part in any bit, or ``first_op: null`` when none does. Exits 1 if the
runs part with ``normal_eq``: ``chip_smoke.py`` then fails its check that
the 4,096-seed run's first 64 poses equal the 64-seed run's.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from open3d_slam_private_tpu_torch.kernels.normal_eq import normal_eq, normal_eq_plain  # noqa: E402
from open3d_slam_private_tpu_torch.models import icp as icp_mod  # noqa: E402


def locate(icp_mod, skel, ref_cloud, seeds, cfg, normal_eq_fn, small=64):
    """Run the burst's chain on every seed and on the first ``small``, the
    normal equations formed by ``normal_eq_fn``, recording each iteration's
    intermediates of those first problems: the moved reading, the matcher's
    ids and distances, the weights, A, b, the solve's x, the increment and
    the new pose. Returns the first (iteration, op) where the two runs
    differ in any bit, with the first seed that differs there, how many do,
    and the largest difference."""
    mins = icp_mod.minimizers
    chain = {k: getattr(icp_mod, k) for k in ("_match", "_weights", "normal_eq", "_advance")}
    solve, delta = mins.solve_spd_unrolled, mins.delta_transform_from_x

    def run(init):
        rec = []

        def keep(op, t):
            rec.append((op, t[:small].detach().clone()))
            return t

        def match(src, *a):
            keep("moved reading", src)
            res = chain["_match"](src, *a)
            keep("matcher ids", res.ids)
            keep("matcher d2", res.dists)
            return res

        def equations(*a):
            A, b = normal_eq_fn(*a)
            return keep("A", A), keep("b", b)

        def advance(*a):
            new = chain["_advance"](*a)
            keep("T", new["T"])
            return new

        icp_mod._match, icp_mod.normal_eq, icp_mod._advance = match, equations, advance
        icp_mod._weights = lambda *a, **k: keep("weights", chain["_weights"](*a, **k))
        mins.solve_spd_unrolled = lambda *a: keep("x", solve(*a))
        mins.delta_transform_from_x = lambda x: keep("dT", delta(x))
        try:
            icp_mod.register_hypotheses(skel, ref_cloud, init, cfg)
        finally:
            for k, v in chain.items():
                setattr(icp_mod, k, v)
            mins.solve_spd_unrolled, mins.delta_transform_from_x = solve, delta
        torch.cuda.synchronize()
        return rec

    big, few = run(seeds), run(seeds[:small])
    iteration = -1
    for (op, a), (op_few, b) in zip(big, few):
        if op != op_few:
            raise RuntimeError(f"locate: the runs' ops part ({op} vs {op_few})")
        iteration += op == "moved reading"
        differs = (a.reshape(small, -1).view(torch.int32) != b.reshape(small, -1).view(torch.int32)).any(1)
        if bool(differs.any()):
            return dict(first_op=op, iteration=iteration, seed=int(differs.nonzero()[0]),
                        seeds_differing=int(differs.sum()),
                        max_abs_diff=float((a.double() - b.double()).abs().max()))
    return dict(first_op=None, iterations_compared=iteration + 1)


def main() -> int:
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    hs = chip_smoke.headline_setup(torch.device("cuda", 0))
    skel, seeds, hyp_cfg = chip_smoke.hypotheses_setup(hs)
    cfg = dataclasses.replace(hyp_cfg, matcher="brute_pallas")
    located = {name: locate(icp_mod, skel, hs["ref_cloud"], seeds, cfg, fn)
               for name, fn in (("einsum", normal_eq_plain), ("normal_eq", normal_eq))}
    chip_smoke.say("batch_dependence", seeds=int(seeds.shape[0]), against=64, **located)
    return 0 if located["normal_eq"]["first_op"] is None else 1


if __name__ == "__main__":
    sys.exit(main())
