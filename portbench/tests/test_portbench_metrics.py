"""Each metric's reader computes its number from a recorded sample, and
every metric of BENCHMARK.json has its reader."""

import numpy as np
import pytest

from portbench.harness import ROOT, Run, metric_reader


def _att(requests, **stages):
    return {"requests": requests,
            "stages": {k: {"seconds": v, "share_of_wall": 0.0} for k, v in stages.items()}}


def _counters(t, requests, batches, mean, **stages):
    return {"t": t, "attribution": _att(requests, **stages),
            "pipeline": {"batches": batches, "mean_batch": mean}}


@pytest.fixture
def run():
    before = _counters(0.0, 100, 10, 4.0, admission=1.0, queue=2.0, serialize=0.5, reply=0.5,
                       encode=1.0, launch=0.0, kernel=3.0, decode=1.0)
    after = _counters(1.0, 300, 30, 6.0, admission=2.0, queue=4.0, serialize=1.0, reply=1.0,
                      encode=2.0, launch=1.0, kernel=6.0, decode=2.0)
    trace = {"busy_s": 3.0, "window_s": 4.0, "counters": (before, after),
             "kernels": {"packed_propagate_kernel(int4 const*)": [6, 0.012],
                         "Memcpy DtoD": [2, 0.004]}}
    ok = np.ones(4, np.int8)

    def rec(i, send, recv, allowed):
        return {"client": 0, "i": i, "send": send, "recv": recv, "status": 200, "rows": 4,
                "allowed": allowed}

    return Run(window=(before, after), trace=trace,
               t0=100.0, end=130.0, deadline=190.0, seconds=30.0,
               setup={"setup_s": 20.0, "ingest_s": 2.0, "start_all_s": 3.0},
               roofline={"n_nodes": 1000, "n_edges": 5000, "distinct_sources": 800,
                         "rows": 4096},
               requests=[rec(0, 100.0, 100.2, ok), rec(1, 100.2, 100.5, ok),
                         rec(2, 129.9, 130.5, ok), rec(3, 100.5, 100.6, np.ones(0, np.int8))])


def test_attribution_readers(run):
    assert metric_reader("rest.http_ms")(run) == pytest.approx(1e3 * 2.0 / 200)
    assert metric_reader("batcher.queue_ms")(run) == pytest.approx(1e3 * 2.0 / 200)
    assert metric_reader("engine.ms_per_request")(run) == pytest.approx(1e3 * 6.0 / 200)
    assert metric_reader("batcher.mean_batch")(run) == pytest.approx((180 - 40) / 20)


def test_trace_readers(run):
    assert metric_reader("device.idle_share")(run) == pytest.approx(25.0)
    assert metric_reader("packed.device_ms_per_batch")(run) == pytest.approx(16.0 / 200)
    from portbench.roofline import b2_bound_s

    bound = b2_bound_s(1000, 5000, 800, 4096)
    assert metric_reader("packed_propagate_roofline")(run) == pytest.approx(100 * bound / 0.002)
    run.trace = None
    assert metric_reader("packed_propagate_roofline")(run) is None
    assert metric_reader("device.idle_share")(run) is None


def test_b2_bytes():
    from portbench.roofline import b2_bytes

    # W = 128 words of 4 bytes; rows of real nodes and probes; two indices an edge
    assert b2_bytes(10, 20, 5, 4096) == 5 * 512 + (10 + 4096) * 512 + (20 + 4096) * 8


def test_setup_readers(run):
    assert metric_reader("setup_s")(run) == 20.0
    assert metric_reader("setup.ingest_s")(run) == 2.0
    assert metric_reader("setup.start_all_s")(run) == 3.0


def test_batch_readers(run):
    # rows of answered requests that came back inside the window: two of four
    assert metric_reader("checks_per_s")(run) == pytest.approx(8 / 30)
    lat = [0.2, 0.3, 0.6, 190.0 - 100.5]
    assert metric_reader("batch_p95_ms")(run) == pytest.approx(1e3 * np.percentile(lat, 95))


def test_every_metric_has_a_reader(bench):
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    files = {p.name[:-3] for p in (ROOT / "metrics").glob("*.py")}
    # the batcher's readers wait for a single-check cell (PERF.md, open questions)
    assert names <= files and files - names == {"batcher.queue_ms", "batcher.mean_batch"}
