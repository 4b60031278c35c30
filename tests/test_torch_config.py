"""keto_tpu_torch's config and CLI vs keto_tpu's, on the CPU.

The same values and files go into both packages' ``Config``: the keys the
port reads come back equal, and invalid values raise ErrMalformedInput
with the same message. Config files load from JSON and TOML (YAML only
where PyYAML is installed). ``python -m keto_tpu_torch.cli serve`` starts
both REST planes and stops on SIGTERM.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import pytest
import torch

from keto_tpu.driver import Config as JConfig
from keto_tpu.utils.errors import ErrMalformedInput as JMalformed
from keto_tpu_torch.cli import main as cli_main
from keto_tpu_torch.driver import Config as TConfig
from keto_tpu_torch.driver import Registry, registry as registry_mod
from keto_tpu_torch.driver.config import DEFAULTS
from keto_tpu_torch.utils.errors import ErrMalformedInput as TMalformed

REPO = Path(__file__).resolve().parent.parent

VALUES = {
    "dsn": "columnar",
    "namespaces": [{"id": 3, "name": "videos"}, {"name": "n"}],
    "serve": {
        "read": {"port": 0, "host": "127.0.0.1", "max-depth": 7,
                 "max_freshness_wait_s": 2.5},
        "write": {"port": 0, "host": "127.0.0.1"},
    },
    "engine": {"mode": "closure", "freshness": "bounded", "max_batch": 128,
               "rebuild_debounce_ms": 5, "strong_freshness_edges": 1000,
               "max_queue": 512, "fallback": False,
               "memory": {"hbm_budget_frac": 0.5, "bytes_per_row": 512},
               "failover": {"probe_mode": "inproc", "allow_cpu": False}},
    "overload": {"enabled": True, "target_delay_ms": 5.0, "dwell_ms": 200,
                 "throttle_window_s": 2.0, "default_criticality": "sheddable"},
    "scrub": {"enabled": True, "interval_s": 0.5, "sample_rows": 1024,
              "max_repairs_per_cycle": 1},
    "debug": {"token": "t", "profile_max_s": 5},
    "log": {"level": "error"},
}


@pytest.mark.parametrize("values", [{}, VALUES])
def test_keys_match_the_reference(values):
    j, t = JConfig(values=values, env={}), TConfig(values=values)
    for key in DEFAULTS:
        assert t.get(key) == j.get(key), key
    assert t.get("no.such.key", default=0) == 0
    for accessor in ("dsn", "read_api_host", "read_api_port", "write_api_host",
                     "write_api_port", "read_api_max_depth", "engine_mode"):
        assert getattr(t, accessor)() == getattr(j, accessor)(), accessor
    tnm, jnm = t.namespace_manager(), j.namespace_manager()
    for ns in values.get("namespaces", []):
        assert tnm.get_namespace_by_name(ns["name"]).id == (
            jnm.get_namespace_by_name(ns["name"]).id
        )


@pytest.mark.parametrize(
    "values",
    [
        {"engine": {"mode": "warp"}},
        {"engine": {"freshness": "eventual"}},
        {"engine": {"max_batch": 0}},
        {"engine": {"max_batch": "many"}},
        {"engine": {"max_batch": True}},
        {"engine": {"rebuild_debounce_ms": -1}},
        {"serve": {"read": {"max-depth": 0}}},
        {"serve": {"read": {"port": "4466"}}},
        {"serve": {"write": {"host": 7}}},
        {"dsn": 5},
        {"namespaces": [{"id": 1}]},
        {"serve": {"read": {"list": "yes"}}},
        {"engine": {"reverse_index": 1}},
        {"engine": {"expand_page_size": -1}},
        {"engine": {"fallback_threshold": 0}},
        {"engine": {"fallback_cooldown_ms": -5}},
        {"engine": {"cache_size": -1}},
        {"engine": {"encoded_cache_size": "big"}},
        {"engine": {"pipeline_depth": -1}},
        {"engine": {"encode_workers": 0}},
        {"serve": {"read": {"encoded": 1}}},
        {"qos": {"enabled": "yes"}},
        {"qos": {"rate": "fast"}},
        {"qos": {"burst": 0.5}},
        {"qos": {"overrides": 3}},
        {"qos": {"overrides": {"n": {"rate": 1, "ceiling": 2}}}},
        {"qos": {"overrides": {"n": {"burst": 0}}}},
        {"qos": {"overrides": {"n": {"rate": "x"}}}},
        {"overload": {"enabled": "yes"}},
        {"overload": {"target_delay_ms": 0}},
        {"overload": {"interval_ms": -1}},
        {"overload": {"min_limit": 0}},
        {"overload": {"tolerance": 0.5}},
        {"overload": {"decrease": 1.5}},
        {"overload": {"decrease": 0}},
        {"overload": {"additive": 0}},
        {"overload": {"hysteresis_ms": 0}},
        {"overload": {"dwell_ms": -1}},
        {"overload": {"throttle_window_s": 0}},
        {"overload": {"throttle_k": 0.5}},
        {"overload": {"history": 0}},
        {"overload": {"default_criticality": "critical"}},
        {"overload": {"target": 5}},
        {"engine": {"max_queue": -1}},
        {"serve": {"read": {"grpc-max-message-size": -1}}},
        {"serve": {"write": {"grpc-max-message-size": "big"}}},
        {"engine": {"closure_builder": "dense"}},
        {"engine": {"closure_block_workers": -1}},
        {"engine": {"closure_block_workers": "all"}},
        {"serve": {"read": {"wire_workers": 0}}},
        {"serve": {"read": {"wire_workers": "four"}}},
        {"serve": {"read": {"wire_workers": 2.5}}},
        {"engine": {"fallback": "yes"}},
        {"engine": {"memory": {"admission": 1}}},
        {"engine": {"memory": {"hbm_budget_frac": 0}}},
        {"engine": {"memory": {"hbm_budget_frac": 1.5}}},
        {"engine": {"memory": {"bytes_per_row": 0}}},
        {"engine": {"memory": {"budget": 0.5}}},
        {"engine": {"failover": {"enabled": "on"}}},
        {"engine": {"failover": {"probe_mode": "thread"}}},
        {"engine": {"failover": {"probe_timeout_s": 0}}},
        {"engine": {"failover": {"probe_interval_s": -1}}},
        {"engine": {"failover": {"max_backoff_s": -1}}},
        {"engine": {"failover": {"allow_cpu": "no"}}},
        {"engine": {"failover": {"retries": 3}}},
        {"scrub": {"enabled": "yes"}},
        {"scrub": {"interval_s": 0}},
        {"scrub": {"sample_rows": 0}},
        {"scrub": {"reservoir": 0}},
        {"scrub": {"replay_per_cycle": -1}},
        {"scrub": {"wal_segments_per_cycle": -1}},
        {"scrub": {"max_repairs_per_cycle": -1}},
        {"scrub": {"digest_chunk_size": 0}},
        {"scrub": {"freeze_burn_rate": -1}},
        {"scrub": {"history": 0}},
        {"scrub": {"rows": 5}},
        {"debug": {"enabled": "yes"}},
        {"debug": {"token": 5}},
        {"debug": {"profile_max_s": 0.05}},
        {"debug": {"pprof": True}},
        {"log": {"level": "loud"}},
        {"log": {"format": "xml"}},
        {"log": 5},
        {"namespaces": 42},
        {"serve": {"read": {"cors": 5}}},
        {"serve": {"read": {"cors": {"enabled": "yes"}}}},
        {"serve": {"write": {"cors": {"allowed_origins": "*"}}}},
        {"serve": {"read": {"cors": {"allowed_headers": [5]}}}},
        {"serve": {"read": {"tls": "on"}}},
        {"serve": {"write": {"tls": {"cert": "x"}}}},
        {"serve": {"read": {"tls": {"key": {"path": 5}}}}},
        {"serve": {"write": {"expose_backend_ports": "yes"}}},
        {"engine": {"sharding": {"escalation_budget": 2}}},
        # the objects the reference closes and the port used to carry and
        # ignore (ROADMAP §C.1), and the value rules it used to skip
        {"zz": 1},
        {"serve": {"reed": {"port": 1}}},
        {"engine": {"pipline_depth": 4}},
        {"engine": {"mesh": {"x": 1}}},
        {"engine": {"sharding": {"enabeld": True}}},
        {"qos": {"enabeld": True}},
        {"autotune": {"bogus": 1}},
        {"autotune": {"interval_s": 0}},
        {"engine": {"sharding": {"data": 0}}},
        {"zz": 1, "yy": 2, "engine": {"max_batch": 0}},
        {"engine": {"max_batch": 0, "pipline": 1}},
        {"engine": 5},
        {"serve": []},
        {"engine": {"mesh": {"data": 0}}},
        {"engine": {"mesh": {"edge": -1}}},
        {"engine": {"sharding": {"edge": 1.5}}},
        {"engine": {"sharding": {"edge_chunk": -1}}},
        {"engine": {"dense_threshold": 1}},
        {"engine": {"batch_window_us": -1}},
        {"engine": {"compile_cache_dir": 3}},
        {"version": 2},
        {"profiling": True},
        {"autotune": {"enabled": "yes"}},
        {"autotune": {"min_requests": 0}},
        {"autotune": {"revert_threshold": -0.1}},
        {"autotune": {"freeze_burn_rate": -1}},
        {"autotune": {"backoff_ticks": -1}},
        {"autotune": {"history": 0}},
        {"autotune": {"knobs": []}},
        {"autotune": {"knobs": {"pipeline_depth": 3}}},
        {"autotune": {"knobs": {"pipeline_depth": {"maxx": 3}}}},
        {"autotune": {"knobs": {"pipeline_depth": {"enabled": 1}}}},
        {"autotune": {"knobs": {"pipeline_depth": {"step": "one", "bogus": 1}}}},
    ],
)
def test_invalid_values_raise_the_reference_message(values):
    with pytest.raises(JMalformed) as want:
        JConfig(values=values, env={})
    with pytest.raises(TMalformed) as got:
        TConfig(values=values)
    assert got.value.message == want.value.message
    assert got.value.status_code == 400


FLEET_REFUSALS = [
    {"replication": {"role": "follower", "bogus": 1}},
    {"replication": {"role": "boss"}},
    {"replication": {"upstream": 5}},
    {"replication": {"dir": ["x"]}},
    {"replication": {"poll_interval_ms": 0}},
    {"replication": {"max_records_per_poll": 1.5}},
    {"replication": {"max_records_per_poll": 0}},
    {"replication": "leader"},
    {"cluster": {"enabled": True, "electon": {}}},
    {"cluster": {"enabled": "yes"}},
    {"cluster": {"instance_id": 7}},
    {"cluster": {"advertise_url": False}},
    {"cluster": {"advertise_write_url": None}},
    {"cluster": {"heartbeat_interval_ms": 5}},
    {"cluster": {"scrape_interval_ms": "fast"}},
    {"cluster": {"member_timeout_s": 0}},
    {"cluster": {"health": 5}},
    {"cluster": {"health": {"burn_redd": 1}}},
    {"cluster": {"health": {"lag_versions_yellow": -1}}},
    {"cluster": {"health": {"lag_versions_red": 1.5}}},
    {"cluster": {"health": {"lag_seconds_red": "30"}}},
    {"cluster": {"health": {"staleness_yellow_s": -0.5}}},
    {"cluster": {"health": {"burn_yellow": True}}},
    {"cluster": {"election": []}},
    {"cluster": {"election": {"lease_ttl": 3}}},
    {"cluster": {"election": {"enabled": "yes"}}},
    {"cluster": {"election": {"lease_ttl_s": 0.05}}},
    {"cluster": {"election": {"heartbeat_interval_ms": 1}}},
    {"cluster": {"election": {"priority": 1.5}}},
    {"cluster": {"election": {"wal_dir": 3}}},
]


@pytest.mark.parametrize("values", FLEET_REFUSALS)
def test_fleet_config_is_refused_as_the_reference_refuses_it(values):
    """The config repair: the replication and cluster objects (and
    cluster.health, cluster.election) are closed and typed as the
    reference's schema has them; the port used to carry and ignore them."""
    with pytest.raises(JMalformed) as want:
        JConfig(values=values, env={})
    with pytest.raises(TMalformed) as got:
        TConfig(values=values)
    assert got.value.message == want.value.message


def test_fleet_config_defaults_and_reload_are_the_references(tmp_path):
    from keto_tpu.driver import config as jconfig
    from keto_tpu_torch.driver import config as tconfig

    fleet = {k: v for k, v in jconfig.DEFAULTS.items()
             if k.startswith(("replication.", "cluster."))}
    assert {k: tconfig.DEFAULTS[k] for k in fleet} == fleet
    # neither subtree is frozen nor a hot knob: a reload swaps it in
    for mod in (jconfig, tconfig):
        assert not {"replication", "cluster"} & set(mod.IMMUTABLE_KEYS)
        assert not [k for k in mod.HOT_KNOB_KEYS if k.startswith(("replication", "cluster"))]
    path = tmp_path / "keto.json"
    doc = {"cluster": {"enabled": True, "scrape_interval_ms": 500},
           "replication": {"role": "leader"}}
    path.write_text(json.dumps(doc))
    j = JConfig(config_file=str(path), env={})
    t = TConfig(config_file=str(path), env={})
    doc["cluster"]["scrape_interval_ms"] = 250
    doc["replication"]["poll_interval_ms"] = 20
    path.write_text(json.dumps(doc))
    assert t.reload() == j.reload()
    for key in ("cluster.scrape_interval_ms", "replication.poll_interval_ms",
                "cluster.election.lease_ttl_s"):
        assert t.get(key) == j.get(key)


def test_config_files(tmp_path, monkeypatch):
    as_json = tmp_path / "keto.json"
    as_json.write_text(json.dumps(VALUES))
    as_toml = tmp_path / "keto.toml"
    as_toml.write_text(
        'dsn = "columnar"\n[serve.read]\nport = 0\nmax-depth = 7\n'
        '[engine]\nfreshness = "bounded"\n'
    )
    for path in (as_json, as_toml):
        t, j = TConfig(config_file=str(path)), JConfig(config_file=str(path), env={})
        for key in DEFAULTS:
            assert t.get(key) == j.get(key), (path.name, key)
    # values override the file, as in the reference
    t = TConfig(values={"engine": {"freshness": "strong"}}, config_file=str(as_json))
    assert t.get("engine.freshness") == "strong" and t.dsn() == "columnar"
    bad = tmp_path / "bad.json"
    bad.write_text("{")
    with pytest.raises(TMalformed, match="cannot parse"):
        TConfig(config_file=str(bad))
    as_yaml = tmp_path / "keto.yaml"
    as_yaml.write_text("dsn: columnar\n")
    monkeypatch.setitem(sys.modules, "yaml", None)  # PyYAML absent
    with pytest.raises(TMalformed, match="PyYAML"):
        TConfig(config_file=str(as_yaml))


@pytest.mark.parametrize(
    "values,outcome",
    [
        ({"engine": {"mode": "sharded"}}, "ShardedCheckEngine"),
        ({"engine": {"sharding": {"enabled": True}}}, "ShardedServingEngine"),
        ({"dsn": "redis://db"}, "unsupported DSN 'redis://db'"),
    ],
)
def test_sharded_configs_are_served_and_a_foreign_dsn_is_refused(values, outcome):
    # the two sharded configurations were refused with their ROADMAP item
    # until the multi-device tiers were ported; on an 8-stripe CPU mesh
    # each now builds its engine
    reg = Registry(TConfig(values=values), device="cpu",
                   mesh_devices=[torch.device("cpu")] * 8)
    if outcome.startswith("Sharded"):
        engine = reg.check_engine()
        assert type(engine).__name__ == outcome
        assert engine.mesh.shape == {"data": 1, "edge": 8}
        return
    with pytest.raises(TMalformed, match=outcome):
        reg.store()
        reg.check_engine()


@pytest.mark.parametrize(
    "values",
    [
        {"engine": {"query_mode": "host"}},
        {"serve": {"read": {"workers": 2}}},
    ],
)
def test_host_query_mode_configs_build_a_host_mode_closure_engine(values):
    # ROADMAP item 6, ported: these two configurations were refused before
    from keto_tpu_torch.engine import ClosureCheckEngine

    cfg = TConfig(values={**values, "engine": {
        **values.get("engine", {}), "closure_builder": "semiring",
        "closure_block_workers": 3,
    }})
    engine = Registry(cfg, device="cpu").check_engine()
    assert type(engine) is ClosureCheckEngine
    assert engine.query_mode == "host" and engine.host_queries()
    assert engine.builder == "semiring" and engine._build_workers() == 3


def test_registry_engines_by_mode():
    from keto_tpu_torch.engine import CheckEngine, ClosureCheckEngine, DeviceCheckEngine
    from keto_tpu_torch.engine.batcher import CheckBatcher, DirectChecker

    kinds = {
        "host": (CheckEngine, DirectChecker),
        "closure": (ClosureCheckEngine, CheckBatcher),
        "auto": (ClosureCheckEngine, CheckBatcher),
        "packed": (DeviceCheckEngine, CheckBatcher),
        "device": (DeviceCheckEngine, CheckBatcher),
    }
    for mode, (engine_cls, checker_cls) in kinds.items():
        reg = Registry(TConfig(values={"engine": {"mode": mode}}), device="cpu")
        assert type(reg.check_engine()) is engine_cls, mode
        assert type(reg.checker()) is checker_cls, mode
        reg.checker().close()
    reg = Registry(TConfig(values=VALUES), device="cpu")
    eng = reg.check_engine()
    assert (eng.freshness, eng.global_max_depth, eng.rebuild_debounce_s) == (
        "bounded", 7, 0.005
    )
    assert reg.checker().max_freshness_wait_s == 2.5
    # the overload keys reach the plane, and the plane the batcher
    ov = reg.overload()
    assert reg.checker().overload is ov and reg.checker().max_queue == 512
    assert (ov.max_queue, ov.limiter.limit, ov.limiter.target_delay_s) == (512, 512, 0.005)
    assert (ov.brownout.min_dwell_s, ov.throttle.window_s) == (0.2, 2.0)
    assert reg.default_criticality() == "sheddable"
    reg.checker().close()  # no dispatcher thread may outlive the test


def test_cli_serve_starts_both_planes_and_stops_on_sigterm(tmp_path, monkeypatch, capsys):
    cfg = tmp_path / "keto.json"
    cfg.write_text(json.dumps(VALUES))
    monkeypatch.setattr(registry_mod, "resolve_device", lambda d: torch.device("cpu"))
    seen = {}
    start_all = Registry.start_all

    def probe_then_stop(ports):
        for port in ports:
            url = f"http://127.0.0.1:{port}/health/ready"
            with urllib.request.urlopen(url, timeout=30) as resp:
                seen[port] = resp.status
        os.kill(os.getpid(), signal.SIGTERM)

    def start_and_probe(self):
        ports = start_all(self)
        threading.Thread(target=probe_then_stop, args=(ports,), daemon=True).start()
        return ports

    monkeypatch.setattr(Registry, "start_all", start_and_probe)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        assert cli_main.main(["serve", "-c", str(cfg)]) == 0
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    assert sorted(seen.values()) == [200, 200]
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("read API serving on :")
    assert out[1].startswith("write API serving on :")
    assert out[2] == "shutting down gracefully..."


def test_cli_module_needs_a_card_or_says_so():
    """Run as a module on a machine without CUDA, serve fails with the
    device error rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: serve would start")
    proc = subprocess.run(
        [sys.executable, "-m", "keto_tpu_torch.cli", "serve"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr


def test_registry_wires_the_batch_tiers():
    """The reference's defaults: both caches on, the cache stamped with the
    answering version, the pipeline only for DeviceCheckEngine, the encoded
    front on, qos off; each key turns its tier off or on."""
    from keto_tpu_torch.api.encoded import EncodedCheckFront
    from keto_tpu_torch.engine.qos import NamespaceQos

    reg = Registry(TConfig(values={}), device="cpu")
    b = reg.checker()
    try:
        assert b.cache.capacity == 65536 and b.version_fn == reg._answering_version
        assert not b.pipelined and b.encoded_cache is None and b.qos is None
        assert isinstance(reg.encoded_front(), EncodedCheckFront)
        assert reg._answering_version() == reg.check_engine().answering_version()
    finally:
        b.close()
    reg = Registry(TConfig(values={"engine": {"mode": "packed"}}), device="cpu")
    b = reg.checker()
    try:
        assert b.pipelined and (b.pipeline_depth, b.encode_workers) == (2, 2)
        assert b.encoded_cache.capacity == 65536 and b.encoded_cache.name == "encoded"
        assert reg._answering_version() == reg.store().version
    finally:
        b.close()
    reg = Registry(TConfig(values={
        "engine": {"mode": "packed", "cache_size": 0, "pipeline_depth": 0,
                   "encoded_cache_size": 0},
        "serve": {"read": {"encoded": False}},
        "qos": {"enabled": True, "rate": 5, "burst": 7,
                "overrides": {"hot": {"rate": 1}}},
    }), device="cpu")
    b = reg.checker()
    try:
        assert b.cache is None and not b.pipelined and b.encoded_cache is None
        assert reg.encoded_front() is None
        assert isinstance(b.qos, NamespaceQos) and b.qos is reg.qos()
        assert (b.qos.rate, b.qos.burst, b.qos.overrides) == (5.0, 7.0, {"hot": (1.0, 7.0)})
    finally:
        b.close()
    reg = Registry(TConfig(values={"engine": {"mode": "host"}}), device="cpu")
    assert reg.encoded_front() is None  # the host oracle has no id path


ENV_CASES = [
    ({}, {"KETO_SERVE_READ_PORT": "9999"}, None),
    ({}, {"KETO_SERVE_READ_PORT": "9999"}, {"serve.read.port": 1111}),
    ({"serve": {"read": {"port": 1234}}}, {"SERVE_READ_PORT": "4321"}, None),
    ({}, {"KETO_SERVE_READ_PORT": "1", "SERVE_READ_PORT": "2"}, None),
    ({}, {"KETO_ENGINE_SHARDING_ENABLED": "true"}, None),
    ({}, {"KETO_DSN": "sqlite:///tmp/x.db", "KETO_SERVE_READ_MAX_DEPTH": "7"}, None),
    ({}, {"KETO_NAMESPACES": '[{"id": 1, "name": "a"}]'}, None),
    ({}, {"KETO_ENGINE_MODE": "warp", "LOG_LEVEL": "debug"}, None),  # not validated
    (VALUES, {"KETO_SERVE_READ_HOST": "0.0.0.0", "ENGINE_MAX_BATCH": "[1"}, None),
    (VALUES, {}, {"engine.mode": "host", "serve.write.port": 7}),
]


@pytest.mark.parametrize("values,env,overrides", ENV_CASES)
def test_env_and_flag_overrides_match_the_reference(values, env, overrides):
    """The lookup order: a flag override, KETO_<KEY>, <KEY>, the values,
    the defaults; env values parse as JSON, else stay strings."""
    j = JConfig(values=values, env=env, flag_overrides=overrides)
    t = TConfig(values=values, env=env, flag_overrides=overrides)
    for key in list(DEFAULTS) + ["no.such.key"]:
        assert t.get(key) == j.get(key), key
    for accessor in ("dsn", "read_api_host", "read_api_port", "write_api_host",
                     "write_api_port", "read_api_max_depth", "engine_mode"):
        assert getattr(t, accessor)() == getattr(j, accessor)(), accessor


def test_the_process_environment_is_the_default_env(monkeypatch):
    """Without ``env``, the process's: a container configured by KETO_*
    variables gets them, and the read plane binds the env's port."""
    from keto_tpu_torch.driver.replicas import resolve_free_ports

    (port,) = resolve_free_ports([("127.0.0.1", 0)])
    monkeypatch.setenv("KETO_SERVE_READ_PORT", str(port))
    monkeypatch.setenv("SERVE_WRITE_HOST", "127.0.0.1")
    assert TConfig().read_api_port() == JConfig().read_api_port() == port
    assert TConfig(env={}).read_api_port() == 4466
    cfg = TConfig(values={"serve": {"read": {"host": "127.0.0.1"},
                                    "write": {"port": 0}}, "log": {"level": "error"}})
    reg = Registry(cfg, device="cpu")
    read_port, _ = reg.start_all()
    try:
        assert read_port == port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health/alive", timeout=30) as r:
            assert r.status == 200
    finally:
        reg.stop_all()


def test_new_registry_puts_flags_in_the_override_layer(tmp_path, monkeypatch):
    from keto_tpu.driver.factory import new_registry as jnew
    from keto_tpu_torch.driver.factory import new_registry

    cfg = tmp_path / "keto.json"
    cfg.write_text(json.dumps({"serve": {"read": {"workers": 2, "port": 5}}}))
    monkeypatch.setenv("KETO_SERVE_READ_WORKERS", "6")
    flags = {"serve.read.workers": 3}
    t = new_registry(str(cfg), flag_overrides=flags, device="cpu").config
    j = jnew(str(cfg), flag_overrides=flags).config
    assert t._overrides == j._overrides == flags
    assert t.get("serve.read.workers") == j.get("serve.read.workers") == 3
    assert t.file_value("serve.read.workers") == j.file_value("serve.read.workers") == 2
    assert t.read_api_port() == j.read_api_port() == 5
