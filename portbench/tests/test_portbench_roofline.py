"""The roofline arithmetic on known row counts, and the device readers'
behaviour where there is nothing to read."""

import pytest

from portbench import harness, peaks


def test_relay_leg_least_time_on_known_rows():
    got = peaks.relay_leg_least_s(1_000_000)
    h = 1_000_000 * 253 / 33.4e12
    sort = 1_000_000 * 16 / 3.35e12
    x = 1_000_000 * 9 / 3.35e12
    assert got["total_s"] == pytest.approx(h + sort + x, rel=1e-12)
    assert got["parts"]["H"][1] == "operations" and got["parts"]["X"][1] == "bytes"
    # H binds by operations: its 20 bytes a row in and out take less time.
    assert peaks.kernel_least_s(ops=253, nbytes=20) == 253 / 33.4e12


def test_roofline_share_is_least_time_over_busy_time():
    read = harness.metric_reader("device_roofline_pct.sync")
    rows = 2_000_000
    busy = peaks.relay_leg_least_s(rows)["total_s"] * 4
    obs = {"device": {"busy_s": busy, "window_s": 10.0}, "traffic": {"rows_pushed": rows}}
    assert read(obs) == pytest.approx(25.0)


@pytest.mark.parametrize("name", ["device_roofline_pct.sync", "device_idle_pct.sync"])
def test_device_readers_return_nothing_without_a_trace(name):
    read = harness.metric_reader(name)
    assert read({"traffic": {"rows_pushed": 10}}) is None
    assert read({"device": None, "traffic": {"rows_pushed": 10}}) is None


def test_idle_share():
    read = harness.metric_reader("device_idle_pct.sync")
    assert read({"device": {"busy_s": 0.25, "window_s": 10.0}}) == pytest.approx(97.5)
