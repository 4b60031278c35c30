"""keto_tpu_torch's metrics registry and exposition parser against keto_tpu's,
on the CPU.

The cases of ``tests/test_observability.py`` ``TestMetricsPrimitives``,
``TestLabelEscaping`` and ``TestExemplars`` run for each package's
``telemetry/metrics.py``; then one script of counters, gauges, labelled
series, histograms (with exemplars under a fixed clock) and the helper
families drives both registries, and their Prometheus text and OpenMetrics
expositions must be byte-equal. Each package's ``telemetry/openmetrics.py``
parser reads the other's output with no error, and both parsers give the
same families, samples and exemplars for the same text. Tolerance: exact,
on bytes and on parsed values.
"""

from types import SimpleNamespace

import pytest

import keto_tpu.telemetry.metrics as jmetrics
import keto_tpu.telemetry.openmetrics as jom
import keto_tpu_torch.telemetry.metrics as tmetrics
import keto_tpu_torch.telemetry.openmetrics as tom

PKGS = {
    "torch": SimpleNamespace(metrics=tmetrics, om=tom),
    "jax": SimpleNamespace(metrics=jmetrics, om=jom),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# -- the reference's cases, per package --------------------------------------------


def test_histogram_percentile_and_expose(pkg):
    m = pkg.metrics.MetricsRegistry()
    h = m.histogram("x_seconds", "test", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 0.5):
        h.observe(v)
    assert h.count == 4
    assert h.percentile(0.5) == 0.1
    text = m.expose()
    assert 'x_seconds_bucket{le="+Inf"} 4' in text
    assert "x_seconds_count 4" in text


def test_labeled_counter_series(pkg):
    m = pkg.metrics.MetricsRegistry()
    c = m.counter("reqs_total", "test", labelnames=("code",))
    c.labels(code="200").inc()
    c.labels(code="200").inc()
    c.labels(code="500").inc()
    text = m.expose()
    assert 'reqs_total{code="200"} 2' in text
    assert 'reqs_total{code="500"} 1' in text


def test_fmt_labels_escapes_newlines_quotes_backslashes(pkg):
    out = pkg.metrics._fmt_labels({"msg": 'a\nb"c\\d'})
    assert out == '{msg="a\\nb\\"c\\\\d"}'
    assert "\n" not in out


def test_newline_label_value_stays_one_exposition_line(pkg):
    m = pkg.metrics.MetricsRegistry()
    c = m.counter("esc_total", "t", labelnames=("detail",))
    c.labels(detail="line1\nline2").inc()
    lines = [line for line in m.expose().splitlines() if line.startswith("esc_total{")]
    assert len(lines) == 1
    assert "\\n" in lines[0]


def test_exemplars_only_in_openmetrics_exposition(pkg):
    m = pkg.metrics.MetricsRegistry()
    h = m.histogram("ex_seconds", "t", buckets=(0.1, 1.0))
    h.observe(0.05, exemplar={"trace_id": "deadbeef"})
    plain = m.expose()
    om = m.expose(openmetrics=True)
    assert "# {" not in plain
    assert "# EOF" not in plain
    assert '# {trace_id="deadbeef"} 0.05' in om
    assert om.rstrip("\n").endswith("# EOF")


def test_last_exemplar_per_bucket_wins(pkg):
    m = pkg.metrics.MetricsRegistry()
    h = m.histogram("ex2_seconds", "t", buckets=(0.1, 1.0))
    h.observe(0.01, exemplar={"trace_id": "old"})
    h.observe(0.02, exemplar={"trace_id": "new"})
    om = m.expose(openmetrics=True)
    assert 'trace_id="new"' in om
    assert 'trace_id="old"' not in om


def test_parser_flags_an_openmetrics_body_read_as_text(pkg):
    m = pkg.metrics.MetricsRegistry()
    h = m.histogram("rt_seconds", "t", buckets=(0.1, 1.0))
    h.observe(0.05, exemplar={"trace_id": "abc"})
    assert pkg.om.parse_text(m.expose()).errors == []
    assert pkg.om.parse_text(m.expose(openmetrics=True), openmetrics=True).errors == []
    errors = pkg.om.parse_text(m.expose(openmetrics=True)).errors
    assert any("exemplar" in e for e in errors)
    assert any("EOF" in e for e in errors)


def test_parser_catches_broken_families(pkg):
    bad = (
        "# HELP bad_counter c\n"
        "# TYPE bad_counter counter\n"
        "bad_counter 1\n"
        "orphan_metric 2\n"
        'dup{a="1"} 1\n'
        "# HELP twice_total t\n"
        "# TYPE twice_total counter\n"
        "twice_total 1\n"
        "twice_total 2\n"
    )
    errors = pkg.om.parse_text(bad).errors
    assert any("orphan_metric" in e for e in errors)
    assert any("duplicate series twice_total" in e for e in errors)


# -- one script through both registries -------------------------------------------


def _script(mod, monkeypatch):
    """Every metric kind and helper family, with exemplars stamped under a
    fixed wall clock."""
    monkeypatch.setattr(mod.time, "time", lambda: 1700000000.123456)
    m = mod.MetricsRegistry()
    c = m.counter("keto_x_total", "a counter", labelnames=("code", "route"))
    c.labels(code="200", route="/check").inc()
    c.labels(code="200", route="/check").inc(2.5)
    c.labels(code="404", route="unmatched").inc()
    c.labels(code="500", route='we"ird\\path\nx').inc()
    m.counter("keto_plain_total", "no labels").inc(7)
    g = m.gauge("keto_depth", "a gauge")
    g.set(3)
    g.dec(0.5)
    m.gauge("keto_sampled", "sampled at scrape", fn=lambda: 41.0)
    lg = m.gauge("keto_lab", "labelled sampler", labelnames=("window",))
    lg.labels(window="fast").set_fn(lambda: 0.25)
    lg.labels(window="slow").set(1.5)
    h = m.histogram("keto_lat_seconds", "latency", labelnames=("transport",))
    for v, tid in ((0.0004, "a" * 32), (0.0025, "b" * 32), (0.003, None),
                   (0.7, "c" * 32), (42.0, "d" * 32)):
        h.labels(transport="rest").observe(v, exemplar={"trace_id": tid} if tid else None)
    h.labels(transport="grpc").observe(0.01)
    stage = mod.pipeline_stage_histogram(m)
    stage.labels(stage="encode").observe(0.0002)
    mod.time_attribution_counter(m).labels(stage="kernel").inc(0.5)
    mod.deadline_expired_counter(m).labels(stage="admission").inc()
    replayed, seconds, age, gap = mod.recovery_metrics(m, checkpoint_age_fn=lambda: 12.0)
    replayed.inc(3)
    seconds.set(0.25)
    gap.set(1)
    failovers, recovery = mod.device_failover_metrics(m)
    failovers.inc()
    recovery.observe(2.0)
    for i, ctr in enumerate(mod.hedge_counters(m)):
        ctr.inc(i)
    return m


def test_one_script_gives_byte_equal_expositions(monkeypatch):
    t = _script(tmetrics, monkeypatch)
    j = _script(jmetrics, monkeypatch)
    assert t.expose() == j.expose()
    assert t.expose(openmetrics=True) == j.expose(openmetrics=True)
    assert t.expose(openmetrics=True).endswith("# EOF\n")
    assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    assert tmetrics.PIPELINE_STAGE_BUCKETS == jmetrics.PIPELINE_STAGE_BUCKETS
    assert tmetrics.RECOVERY_BUCKETS == jmetrics.RECOVERY_BUCKETS


@pytest.mark.parametrize("openmetrics", [False, True], ids=["text", "openmetrics"])
def test_each_parser_reads_the_others_exposition(monkeypatch, openmetrics):
    texts = {
        "torch": _script(tmetrics, monkeypatch).expose(openmetrics=openmetrics),
        "jax": _script(jmetrics, monkeypatch).expose(openmetrics=openmetrics),
    }
    parsed = {}
    for writer, text in texts.items():
        for reader, mod in (("torch", tom), ("jax", jom)):
            doc = mod.parse_text(text, openmetrics=openmetrics)
            assert doc.errors == [], (writer, reader)
            assert doc.saw_eof == openmetrics
            parsed[(writer, reader)] = [
                (f.name, f.type, f.help,
                 [(s.name, s.labels, s.value, s.exemplar) for s in f.samples])
                for f in doc.families.values()
            ]
    first = parsed[("torch", "torch")]
    assert all(v == first for v in parsed.values())
    doc = tom.parse_text(texts["jax"], openmetrics=openmetrics)
    assert doc.value("keto_x_total", {"code": "404"}) == 1.0
    assert doc.sum_counter("keto_x_total") == 5.5
    assert doc.value("keto_lab", {"window": "fast"}) == 0.25
    exemplars = [s.exemplar for s in doc.samples_named("keto_lat_seconds_bucket")
                 if s.exemplar]
    assert len(exemplars) == (4 if openmetrics else 0)
