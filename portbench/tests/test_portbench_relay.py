"""Each relay cell driven end to end on the CPU at a tiny size, with the
program's plain versions of the kernels: the run is correct, and it comes
out not correct under each fault the cell can have."""

import time

import pytest

from _tiny import PULL, checkout_with_pull, tiny
from portbench import harness
from portbench.cells import relay

CELLS = ["relay-c3.push_burst", PULL]
SEED = 2**31 + 977


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return checkout_with_pull(tmp_path_factory.mktemp("checkout"))


def _run(workload, root, trace=False, fault=None, seed=SEED):
    return harness.run_workload(workload, seed, 1.5, trace, t_start=time.perf_counter(), device="cpu",
                                overrides=tiny(workload), fault=fault, root=root)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_and_reports_its_end_to_end_metrics(workload, root):
    r = _run(workload, root)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"sync_msgs_s", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", relay.FAULTS)
def test_a_broken_pass_comes_out_not_correct(workload, fault, root):
    r = _run(workload, root, fault=fault, seed=SEED + 1)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_the_host_layers(workload, root):
    r = _run(workload, root, trace=True, seed=SEED + 2)
    assert r["correct"], r["checks"]
    want = {"front_self_ms.sync", "queue_wait_ms.sync", "requests_per_pass.sync", "pass_ms.sync",
            "host_apply_ms.sync", "sync_p95_ms.relay-c3.push_burst"}
    # The device's metrics come from a CUDA trace only: a CPU run has none.
    assert set(r["metrics"]) == want
    assert r["metrics"]["requests_per_pass.sync"]["value"] >= 1


def test_same_seed_same_requests():
    from portbench.gen.relay_sync import OwnerStream, RelayData

    config = harness.load_config(harness.load_benchmark(), "relay-c3")
    mix = harness.load_traffic("push_burst")
    data = RelayData({**config, **tiny("push_burst")["config"]})
    a, b = OwnerStream(data, mix, SEED, 3), OwnerStream(data, mix, SEED, 3)
    assert [a.next().body for _ in range(3)] == [b.next().body for _ in range(3)]
    assert OwnerStream(data, mix, SEED + 1, 3).next().body != OwnerStream(data, mix, SEED, 3).next().body


@pytest.mark.cuda
def test_control_on_the_card_is_not_correct():
    """The control (a pass acknowledged and not stored) on the card, tiny."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = harness.run_workload("relay-c3.push_burst", SEED, 1.5, False, t_start=time.perf_counter(),
                             overrides=tiny("relay-c3.push_burst"), fault="unchanged")
    assert not r["correct"]
