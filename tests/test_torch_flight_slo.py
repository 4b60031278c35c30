"""keto_tpu_torch's flight recorder, check telemetry and SLO tracker against
keto_tpu's, on the CPU.

The cases of ``tests/test_observability.py`` ``TestFlightRecorder`` and
``TestSLOBurnRate`` run for each package; then one script drives both
packages under one injected clock: the ring's records and its disk flush
(``flight.json``), ``CheckTelemetry``'s outcome classification, flight
records, per-transport counts and metrics, and the SLO tracker's burn rates,
budget, snapshot and alerts. Tolerance: exact, except ``pytest.approx`` on
the burn-rate floats the reference's own cases compare that way.
"""

import json
from types import SimpleNamespace

import pytest

import keto_tpu.telemetry.flight as jflight
import keto_tpu.telemetry.metrics as jmetrics
import keto_tpu.telemetry.slo as jslo
import keto_tpu_torch.telemetry.flight as tflight
import keto_tpu_torch.telemetry.metrics as tmetrics
import keto_tpu_torch.telemetry.slo as tslo

PKGS = {
    "torch": SimpleNamespace(flight=tflight, slo=tslo, metrics=tmetrics),
    "jax": SimpleNamespace(flight=jflight, slo=jslo, metrics=jmetrics),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# -- the reference's cases, per package --------------------------------------------


def test_ring_eviction_newest_first(pkg):
    fr = pkg.flight.FlightRecorder(capacity=3)
    for i in range(5):
        fr.record(idx=i)
    recs = fr.records()
    assert [r["idx"] for r in recs] == [4, 3, 2]
    assert recs[0]["seq"] == 4
    assert fr.total_recorded == 5
    assert fr.records(1)[0]["idx"] == 4
    assert fr.stats()["size"] == 3


def test_fatal_dump_writes_ring_and_stacks(pkg, tmp_path):
    import sys

    hook = sys.excepthook
    fr = pkg.flight.FlightRecorder(capacity=8, dump_dir=str(tmp_path), flush_interval_s=60)
    try:
        fr.record(trace_id="abc123", outcome="error:Boom")
        fr.install_fatal_dump()
        assert sys.excepthook is not hook
        fr.dump_fatal()
        doc = json.loads((tmp_path / "flight.json").read_text())
        assert doc["records"][0]["trace_id"] == "abc123"
        stacks = (tmp_path / "fatal.stacks").read_text()
        assert "File" in stacks or "Thread" in stacks
    finally:
        fr.close()
    assert sys.excepthook is hook  # close() restores the hook


def test_burn_rate_math(pkg):
    clk = [1000.0]
    t = pkg.slo.SLOTracker(objective=0.9, latency_target_s=0.1, fast_window_s=60,
                           slow_window_s=600, clock=lambda: clk[0])
    for _ in range(9):
        assert t.record(0.01) is False
    assert t.record(0.01, error=True) is True
    assert t.burn_rate(60) == pytest.approx(1.0)
    assert t.budget_remaining() == pytest.approx(0.0)
    assert t.record(0.5) is True  # slower than the target: bad without an error


def test_window_expiry(pkg):
    clk = [1000.0]
    t = pkg.slo.SLOTracker(objective=0.9, fast_window_s=60, slow_window_s=600,
                           clock=lambda: clk[0])
    t.record(0.01, error=True)
    assert t.burn_rate(600) > 0
    clk[0] += 700
    t.record(0.01)
    assert t.burn_rate(600) == pytest.approx(0.0)


def test_alert_fires_once_per_cooldown(pkg):
    warnings = []

    class FakeLog:
        def warning(self, msg, **fields):
            warnings.append((msg, fields))

    clk = [1000.0]
    t = pkg.slo.SLOTracker(logger=FakeLog(), objective=0.9, alert_burn_rate=1.0,
                           alert_cooldown_s=300, fast_window_s=60, slow_window_s=600,
                           clock=lambda: clk[0])
    t.record(0.01, error=True)
    assert t.alerts_fired == 1
    assert warnings and warnings[0][0] == "slo_burn_alert"
    assert warnings[0][1]["fast_burn_rate"] >= 1.0
    clk[0] += 10
    t.record(0.01, error=True)
    assert t.alerts_fired == 1
    clk[0] += 300
    t.record(0.01, error=True)
    assert t.alerts_fired == 2


def test_an_objective_outside_zero_one_is_refused(pkg):
    for bad in (0.0, 1.0, 1.5):
        with pytest.raises(ValueError):
            pkg.slo.SLOTracker(objective=bad)


# -- one script, one clock, both packages ------------------------------------------


class DeadlineExceeded(Exception):
    pass


def _slo_script(p):
    clk = [5000.0]
    warnings = []

    class Log:
        def warning(self, msg, **fields):
            warnings.append((msg, fields))

    m = p.metrics.MetricsRegistry()
    t = p.slo.SLOTracker(metrics=m, logger=Log(), objective=0.99, latency_target_s=0.05,
                         fast_window_s=30, slow_window_s=300, alert_burn_rate=4.0,
                         alert_cooldown_s=60, clock=lambda: clk[0])
    trail = []
    for step in range(400):
        clk[0] += 0.75
        latency = 0.2 if step % 17 == 0 else 0.01
        bad = t.record(latency, error=(step % 41 == 0))
        if step % 25 == 0:
            trail.append((step, bad, t.burn_rate(30), t.burn_rate(300),
                          t.budget_remaining(), t.alerts_fired))
    return trail, t.snapshot(), warnings, m.expose()


def test_burn_rates_and_alerts_agree_under_one_clock():
    tt, ts, tw, texp = _slo_script(PKGS["torch"])
    jt, js, jw, jexp = _slo_script(PKGS["jax"])
    assert tt == jt
    assert ts == js
    assert tw == jw and tw  # the alert fired, with the same fields
    assert texp == jexp


def _telemetry_script(p, tmp_path):
    """CheckTelemetry over a recorder with a disk flush, an SLO and metrics,
    under one clock: ok, slow, deadline-missed and errored checks, with and
    without a caller's traceparent and the hedge tag."""
    clk = [2000.0]
    m = p.metrics.MetricsRegistry()
    fr = p.flight.FlightRecorder(capacity=4, dump_dir=str(tmp_path), flush_interval_s=60,
                                 clock=lambda: clk[0])
    slo = p.slo.SLOTracker(metrics=m, objective=0.9, latency_target_s=0.5,
                           clock=lambda: clk[0])
    tel = p.flight.CheckTelemetry(metrics=m, flight=fr, slo=slo, slow_s=10.0,
                                  stages_fn=lambda: {"encode": {"p50_ms": 1.0}})
    tp = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    outcomes = []
    for i, (exc, traceparent, hedge) in enumerate((
        (None, None, False), (None, tp, True), (DeadlineExceeded, tp, False),
        (TimeoutError, None, False), (KeyError, tp, False), (None, None, False),
    )):
        clk[0] += 1.0
        try:
            with tel.record_check("rest" if i % 2 else "grpc", batch_size=i + 1,
                                  detail={"namespace": "n"}, traceparent=traceparent,
                                  hedge=hedge) as rec:
                rec.mark("serialize")
                if exc is not None:
                    raise exc("x")
        except Exception as e:
            outcomes.append(type(e).__name__)
    tel.slow_s = 0.0  # every check is slow from here: flight-recorded when ok
    with tel.record_check("rest_batch", batch_size=8, traceparent=tp):
        pass
    path = fr.flush_to_disk()
    disk = json.loads(open(path).read())
    fr.close()

    def scrub(rec):  # wall times and durations differ run to run
        rec = dict(rec)
        for k in ("t", "duration_ms", "bucket_le", "ledger_ms", "deadline_slack_ms"):
            rec.pop(k, None)
        return rec

    exposition = [line for line in m.expose().splitlines()
                  if line.startswith(("keto_check_requests_total", "keto_slo_"))]
    stats = tel.stats()
    stats["flight"].pop("dump_dir")
    return (outcomes, [scrub(r) for r in fr.records()],
            [scrub(r) for r in disk["records"]], stats, exposition, slo.snapshot())


def test_the_check_telemetry_records_alike(tmp_path):
    got = {name: _telemetry_script(p, tmp_path / name) for name, p in PKGS.items()}
    assert got["torch"] == got["jax"]
    outcomes, records, disk, stats, exposition, _ = got["torch"]
    assert outcomes == ["DeadlineExceeded", "TimeoutError", "KeyError"]
    assert [r["outcome"] for r in records] == [
        "ok", "error:KeyError", "deadline_missed", "deadline_missed"]
    assert records == disk
    assert records[0]["trace_id"] == "0af7651916cd43dd8448eb211c80319c"
    assert stats["by_outcome"] == {"ok": 4, "deadline_missed": 2, "error:KeyError": 1}
