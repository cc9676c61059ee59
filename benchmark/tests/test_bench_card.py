"""On the card: a short run of each one-chip cell gives a result line with
its metrics, and the check passes."""

import time

import pytest

import harness
from conftest import BENCH


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["default-online-street", "default-replay-street"])
def test_a_short_run_is_correct(card, cell):
    import run as bench_run

    spec = harness.load_spec(cell, BENCH.parent)
    out = bench_run.measure(spec, 2**31 + 101, 4.0, False, "cuda", t_start=time.time())
    assert out is not None and out["correct"], out
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
    assert set(out["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert list(out)[-1] == "checks"
