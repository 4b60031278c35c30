"""keto_tpu_torch's cluster plane against keto_tpu's, on the CPU.

The membership, health-rollup, federation-scraper and heartbeater cases of
``tests/test_cluster.py`` (not its ``TestBench*`` classes, which test
``bench.py``), each run for both packages under one canned exposition and
one clock script, with the same assertions; then both packages' outcomes
are compared: the membership rows, the rollup levels and reasons, the
scraper's member views and cluster summary (timing fields aside) and its
re-exported ``keto_cluster_*`` series, parsed by each package's own
``openmetrics.py``, must be equal. Tolerance: exact.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

import keto_tpu.cluster as jcluster
import keto_tpu.telemetry as jtelemetry
import keto_tpu_torch.cluster as tcluster
import keto_tpu_torch.telemetry as ttelemetry

PKGS = {
    "torch": SimpleNamespace(cluster=tcluster, telemetry=ttelemetry),
    "jax": SimpleNamespace(cluster=jcluster, telemetry=jtelemetry),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def both(scenario):
    """Run ``scenario(pkg)`` for each package and return (torch, jax)."""
    return scenario(PKGS["torch"]), scenario(PKGS["jax"])


EXPOSITION = """\
# HELP keto_replication_lag_versions versions behind
# TYPE keto_replication_lag_versions gauge
keto_replication_lag_versions 3
# HELP keto_http_requests_total requests
# TYPE keto_http_requests_total counter
keto_http_requests_total{code="200"} 90
keto_http_requests_total{code="503"} 10
# HELP keto_slo_events_total events
# TYPE keto_slo_events_total counter
keto_slo_events_total 1000
# HELP keto_slo_bad_events_total bad events
# TYPE keto_slo_bad_events_total counter
keto_slo_bad_events_total 20
# HELP keto_slo_burn_rate burn
# TYPE keto_slo_burn_rate gauge
keto_slo_burn_rate{window="fast"} 0.5
keto_slo_burn_rate{window="slow"} 0.25
"""

# the scraper's timing fields: wall time of this run, not an answer
_TIMING = ("last_cycle_ms",)


def _strip_timing(status: dict) -> dict:
    doc = json.loads(json.dumps(status, default=str))
    for key in _TIMING:
        doc["cluster"].get("scrape", {}).pop(key, None)
    return doc


# -- membership -------------------------------------------------------------------


def test_upsert_requires_instance_id(pkg):
    m = pkg.cluster.ClusterMembership()
    with pytest.raises(ValueError, match="missing instance_id"):
        m.upsert({"role": "follower"})


def test_heartbeats_accumulate_and_first_seen_sticks():
    def scenario(pkg):
        t = [100.0]
        m = pkg.cluster.ClusterMembership(member_timeout_s=5.0, clock=lambda: t[0])
        m.upsert({"instance_id": "f0"})
        t[0] = 101.0
        row = m.upsert({"instance_id": "f0", "version": 7})
        assert row["heartbeats"] == 2 and row["first_seen"] == 100.0
        assert m.get("f0")["version"] == 7
        return row, m.members()

    assert_equal(*both(scenario))


def test_liveness_ages_out_but_row_survives():
    def scenario(pkg):
        t = [100.0]
        m = pkg.cluster.ClusterMembership(member_timeout_s=5.0, clock=lambda: t[0])
        m.upsert({"instance_id": "f0"})
        assert m.members()[0]["alive"]
        t[0] = 106.0
        rows = m.members()
        assert len(rows) == 1 and not rows[0]["alive"] and rows[0]["age_s"] == 6.0
        assert m.alive() == [] and len(m) == 1
        return rows

    assert_equal(*both(scenario))


def test_members_sorted_by_join_order():
    def scenario(pkg):
        t = [1.0]
        m = pkg.cluster.ClusterMembership(clock=lambda: t[0])
        for inst in ("c", "a", "b"):
            m.upsert({"instance_id": inst})
            t[0] += 1.0
        assert [r["instance_id"] for r in m.members()] == ["c", "a", "b"]
        return m.members()

    assert_equal(*both(scenario))


# -- health rollup ----------------------------------------------------------------

ROLLUP_VIEWS = [
    ({"alive": True, "lag_versions": None, "burn_rate": None}, None, "green"),
    ({"alive": False, "age_s": 42}, None, "red"),
    ({"lag_versions": 99}, None, "green"),
    ({"lag_versions": 100}, None, "yellow"),
    ({"lag_versions": 10000}, None, "red"),
    ({"burn_rate": 1.5}, None, "yellow"),
    ({"burn_rate": 2.0}, None, "red"),
    ({"staleness_seconds": 60.0}, None, "red"),
    ({"lag_seconds": 6.0, "burn_rate": 1.0}, None, "yellow"),
    ({"breaker": 1.0}, None, "red"),
    ({"breaker": 0.5}, None, "yellow"),
    ({"recovering": True}, None, "yellow"),
    ({"breaker": 0.0}, None, "green"),
    ({"lag_versions": 50}, {"lag_versions_yellow": 10}, "yellow"),
    # a None override falls back to the default
    ({"lag_versions": 50}, {"lag_versions_yellow": None}, "green"),
]


@pytest.mark.parametrize("view,thresholds,level", ROLLUP_VIEWS)
def test_rollup_health(view, thresholds, level):
    got = both(lambda pkg: pkg.telemetry.rollup_health(view, thresholds))
    assert got[0][0] == level
    assert_equal(*got)


# -- federation scraper -----------------------------------------------------------


def _scraper(pkg, expositions: dict, clock, **kw):
    """A scraper over a canned {url: exposition text} fleet."""
    membership = kw.pop("membership", None)
    if membership is None:
        membership = pkg.cluster.ClusterMembership(member_timeout_s=60.0)

    def fetch(url: str, timeout_s: float) -> str:
        if url not in expositions:
            raise OSError(f"no route to {url}")
        return expositions[url]

    metrics = pkg.telemetry.MetricsRegistry()
    scraper = pkg.telemetry.FederationScraper(
        membership, metrics, objective=kw.pop("objective", 0.99), fetch_fn=fetch,
        clock=clock, **kw,
    )
    return scraper, membership, metrics


def _cluster_series(pkg, metrics) -> dict:
    """The keto_cluster_* samples of ``metrics``, parsed by the package's own
    parser, keyed by the sample name and its sorted labels."""
    parsed = pkg.telemetry.parse_text(metrics.expose())
    assert not parsed.errors
    out = {}
    for fam in parsed.families.values():
        for s in fam.samples:
            if s.name.startswith("keto_cluster_") and s.name != "keto_cluster_scrape_cycle_ms":
                out[f"{s.name}{sorted(s.labels.items())}"] = s.value
    return out


def test_pre_cycle_status_is_unknown():
    def scenario(pkg):
        scraper, membership, _ = _scraper(pkg, {}, clock=lambda: 0.0)
        membership.upsert({"instance_id": "f0"})
        st = scraper.status()
        assert st["cluster"]["health"] == "unknown" and st["cluster"]["members"] == 1
        return st["cluster"]

    assert_equal(*both(scenario))


def test_run_once_federates_and_reexports():
    def scenario(pkg):
        t = [100.0]
        scraper, membership, metrics = _scraper(
            pkg, {"http://f0/metrics": EXPOSITION}, clock=lambda: t[0]
        )
        membership.upsert({"instance_id": "f0", "role": "follower", "read_url": "http://f0"})
        st = scraper.run_once()
        (view,) = st["members"]
        assert view["scrape_ok"] and view["lag_versions"] == 3.0
        assert view["burn_rate"] == 0.5 and view["health"] == "green"
        parsed = pkg.telemetry.parse_text(metrics.expose())
        assert parsed.value("keto_cluster_replication_lag_versions", {"instance": "f0"}) == 3.0
        assert parsed.value("keto_cluster_member_up", {"instance": "f0"}) == 1.0
        assert scraper.status() is st  # cached: no scrape inline
        return _strip_timing(st), _cluster_series(pkg, metrics)

    got = both(scenario)
    for m in (g[0]["members"][0] for g in got):
        m.pop("age_s")  # membership's wall clock (time.time) in both
    assert_equal(*got)


def test_qps_and_aggregate_burn_from_counter_deltas():
    def scenario(pkg):
        t = [100.0]
        expositions = {"http://f0/metrics": EXPOSITION}
        scraper, membership, metrics = _scraper(pkg, expositions, clock=lambda: t[0])
        membership.upsert({"instance_id": "f0", "role": "follower", "read_url": "http://f0"})
        st = scraper.run_once()  # the first cycle records the counters only
        assert st["members"][0]["qps"] is None
        assert st["cluster"]["aggregate_burn_rate"] == 0.0
        # +200 requests and +200 events (+10 bad) over 10 s
        expositions["http://f0/metrics"] = (
            EXPOSITION.replace('code="200"} 90', 'code="200"} 280')
            .replace('code="503"} 10', 'code="503"} 20')
            .replace("keto_slo_events_total 1000", "keto_slo_events_total 1200")
            .replace("keto_slo_bad_events_total 20", "keto_slo_bad_events_total 30")
        )
        t[0] = 110.0
        st = scraper.run_once()
        assert st["members"][0]["qps"] == 20.0
        # (10 bad / 200 events) / (1 - 0.99) budget = 5x burn: the alert
        # degrades the fleet's QoS and the directives say so
        assert st["cluster"]["aggregate_burn_rate"] == 5.0
        assert st["cluster"]["degraded"] and scraper.directives()["qos_scale"] == 0.25
        assert pkg.telemetry.parse_text(metrics.expose()).value(
            "keto_cluster_slo_burn_rate_aggregate") == 5.0
        return st["cluster"]["aggregate_burn_rate"], scraper.directives(), \
            _cluster_series(pkg, metrics)

    assert_equal(*both(scenario))


def test_degradation_tightens_qos_and_recovers_with_hysteresis():
    """The aggregate alert sets the fleet scale on the leader's own QoS and
    in every heartbeat reply's directives; recovery waits for the burn to
    fall below half the alert line."""
    import keto_tpu.engine.qos as jqos
    import keto_tpu_torch.engine.qos as tqos

    qos_of = {id(PKGS["torch"]): tqos, id(PKGS["jax"]): jqos}

    def scenario(pkg):
        t = [0.0]
        bad = [0]
        events = [0]

        def expo():
            return (f"# TYPE keto_slo_events_total counter\nketo_slo_events_total {events[0]}\n"
                    f"# TYPE keto_slo_bad_events_total counter\n"
                    f"keto_slo_bad_events_total {bad[0]}\n")

        qos = qos_of[id(pkg)].NamespaceQos(rate=100.0, burst=100.0,
                                            metrics=pkg.telemetry.MetricsRegistry())
        membership = pkg.cluster.ClusterMembership(member_timeout_s=60.0)
        metrics = pkg.telemetry.MetricsRegistry()
        scraper = pkg.telemetry.FederationScraper(
            membership, metrics, objective=0.99, qos=qos,
            fetch_fn=lambda url, timeout_s: expo(), clock=lambda: t[0],
        )
        membership.upsert({"instance_id": "f0", "role": "follower", "read_url": "http://f0"})
        trace = []
        # burn per cycle: 0 (first), 5 (alert at 2), 1.5 (above 1: stays),
        # 0.5 (recovers)
        for d_events, d_bad in ((0, 0), (100, 5), (100, 1.5), (100, 0.5)):
            events[0] += d_events
            bad[0] += d_bad
            t[0] += 1.0
            st = scraper.run_once()
            trace.append((st["cluster"]["aggregate_burn_rate"], scraper.degraded,
                          qos._scale, scraper.directives()["qos_scale"]))
        return trace

    got = both(scenario)
    assert [row[1] for row in got[0]] == [False, True, True, False]
    assert [row[2] for row in got[0]] == [1.0, 0.25, 0.25, 1.0]
    assert_equal(*got)


def test_leader_lag_defaults_to_zero():
    def scenario(pkg):
        scraper, membership, _ = _scraper(
            pkg, {"http://l/metrics": "# TYPE x gauge\nx 1\n"}, clock=lambda: 0.0
        )
        membership.upsert({"instance_id": "l0", "role": "leader", "read_url": "http://l"})
        (view,) = scraper.run_once()["members"]
        assert view["lag_versions"] == 0.0 and view["staleness_seconds"] == 0.0
        assert view["health"] == "green"
        view.pop("age_s")
        return view

    assert_equal(*both(scenario))


def test_scrape_failure_is_counted_not_fatal():
    def scenario(pkg):
        scraper, membership, metrics = _scraper(pkg, {}, clock=lambda: 0.0)
        membership.upsert({"instance_id": "f0", "role": "follower",
                           "read_url": "http://gone"})
        st = scraper.run_once()
        (view,) = st["members"]
        assert not view["scrape_ok"] and "OSError" in view["scrape_error"]
        assert st["cluster"]["scrape"]["errors"] == 1
        parsed = pkg.telemetry.parse_text(metrics.expose())
        assert parsed.value("keto_cluster_scrape_errors_total", {"instance": "f0"}) == 1.0
        return view["scrape_error"], _cluster_series(pkg, metrics)

    assert_equal(*both(scenario))


def test_self_payload_makes_standalone_a_member():
    def scenario(pkg):
        scraper, _, _ = _scraper(
            pkg, {}, clock=lambda: 0.0,
            self_payload_fn=lambda: {"instance_id": "me", "role": "leader"},
        )
        st = scraper.run_once()
        assert [m["instance_id"] for m in st["members"]] == ["me"]
        assert st["cluster"]["alive"] == 1
        return st["cluster"]["alive"], st["cluster"]["health"]

    assert_equal(*both(scenario))


def test_member_read_urls_skips_dead_and_selfless():
    def scenario(pkg):
        t = [100.0]
        membership = pkg.cluster.ClusterMembership(member_timeout_s=5.0, clock=lambda: t[0])
        scraper, _, _ = _scraper(pkg, {}, clock=lambda: t[0], membership=membership)
        membership.upsert({"instance_id": "f0", "read_url": "http://f0"})
        membership.upsert({"instance_id": "f1"})  # no read_url
        t[0] = 102.0
        membership.upsert({"instance_id": "f2", "read_url": "http://f2"})
        t[0] = 107.0  # f0 and f1 aged out, f2 still fresh
        assert scraper.member_read_urls() == [("f2", "http://f2")]
        return scraper.member_read_urls()

    assert_equal(*both(scenario))


def test_status_json_round_trips(pkg):
    scraper, membership, _ = _scraper(pkg, {}, clock=lambda: 0.0)
    membership.upsert({"instance_id": "f0"})
    json.dumps(scraper.run_once())  # must not raise


# -- heartbeater ------------------------------------------------------------------


def test_beat_once_posts_payload_to_cluster_route():
    def scenario(pkg):
        posted = []
        hb = pkg.cluster.ClusterHeartbeater(
            "http://leader:4467/",
            lambda: {"instance_id": "f0", "version": 9},
            post_fn=lambda url, payload: posted.append((url, payload)),
        )
        assert hb.beat_once()
        assert posted == [("http://leader:4467/cluster/heartbeat",
                           {"instance_id": "f0", "version": 9})]
        assert hb.beats == 1 and hb.errors == 0
        return posted

    assert_equal(*both(scenario))


def test_failures_are_swallowed_and_counted():
    def scenario(pkg):
        def post(url, payload):
            raise ConnectionError("leader is restarting")

        hb = pkg.cluster.ClusterHeartbeater(
            "http://leader:4467", lambda: {"instance_id": "f0"}, post_fn=post
        )
        assert not hb.beat_once()
        assert hb.beats == 0 and hb.errors == 1
        assert "leader is restarting" in hb.last_error
        st = hb.status()
        assert st["errors"] == 1 and not st["running"]
        return st

    assert_equal(*both(scenario))


def test_directives_in_the_reply_reach_the_follower():
    def scenario(pkg):
        applied = []
        hb = pkg.cluster.ClusterHeartbeater(
            "http://leader:4467", lambda: {"instance_id": "f0"},
            post_fn=lambda url, payload: {
                "ok": True, "directives": {"qos_scale": 0.25, "degraded": True}},
            on_directives=applied.append,
        )
        assert hb.beat_once()
        assert applied == [{"qos_scale": 0.25, "degraded": True}]
        return hb.status()["last_directives"]

    assert_equal(*both(scenario))


def assert_equal(torch_out, jax_out):
    assert json.loads(json.dumps(torch_out, default=str)) == json.loads(
        json.dumps(jax_out, default=str)
    )
