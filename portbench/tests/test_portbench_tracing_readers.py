"""The device-wait readers on synthetic windows: the kernel stage per
request and the sync sites per request where the program counts its
device waits, and None on a window of a program that does not (no
``device_waits`` in its attribution snapshot) or that counted no request."""

import pytest

from portbench.harness import Run, metric_reader


def _att(requests, kernel, waits=None):
    snap = {"requests": requests, "stages": {"kernel": {"seconds": kernel,
                                                        "share_of_wall": 0.0}}}
    if waits is not None:
        snap["device_waits"] = {site: {"count": n, "seconds": s}
                                for site, (n, s) in waits.items()}
    return {"t": 0.0, "attribution": snap, "pipeline": None}


def _run(before, after):
    return Run(window=(before, after), trace=None)


@pytest.fixture
def window():
    before = _att(10, 1.0, {"device.upload": (30, 0.2), "packed.done": (60, 0.5)})
    after = _att(14, 1.6, {"device.upload": (42, 0.3), "packed.done": (84, 0.9),
                           "device.decode": (4, 0.1)})
    return _run(before, after)


def test_device_wait_ms(window):
    assert metric_reader("engine.device_wait_ms")(window) == pytest.approx(1e3 * 0.6 / 4)


def test_syncs_per_request(window):
    assert metric_reader("engine.syncs_per_request")(window) == pytest.approx((12 + 24 + 4) / 4)


@pytest.mark.parametrize("name", ["engine.device_wait_ms", "engine.syncs_per_request"])
def test_a_parent_window_reads_none(name):
    # the parent's snapshot has a kernel stage but counts no device waits
    assert metric_reader(name)(_run(_att(10, 1.0), _att(14, 1.6))) is None
    # nor does a window whose edges the program did not answer
    assert metric_reader(name)(Run(window=({"t": 0.0}, {"t": 1.0}))) is None
    assert metric_reader(name)(Run(window=None)) is None


@pytest.mark.parametrize("name", ["engine.device_wait_ms", "engine.syncs_per_request"])
def test_a_window_with_no_request_reads_none(name):
    snap = _att(10, 1.0, {"device.upload": (30, 0.2)})
    assert metric_reader(name)(_run(snap, snap)) is None
