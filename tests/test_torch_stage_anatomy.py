"""The port's stage-anatomy plane (`evolu_tpu_torch.obs.anatomy`), the
twin of tests/test_stage_anatomy.py: the registry's shape and digest, the
port's one priced platform (`cuda`) priced exactly, the CPU and unknown
platforms unpriced, the evolu_stage_* family (histograms, counters and
gauges, over-floor flags past warm-up, the decayed slope/fixed fit
recovering a synthetic law, the runtime shares), kernel spans folded
through utils.log.span, the /stats payload, and parity with the JAX
package once both hold the same cost laws."""

import json

import pytest
from _torch_jax_state import jax_process_state  # noqa: F401  (the JAX package's native libraries and ledger)

from evolu_tpu_torch.obs import anatomy, metrics
from evolu_tpu_torch.utils.log import logger, span

@pytest.fixture(autouse=True)
def _clean_slate():
    logger.clear()  # resets metrics registry + anatomy accumulators
    prev = anatomy.get_platform()
    yield
    anatomy.set_platform(prev)
    logger.configure(False)
    logger.clear()


# --- registry shape + digests ---


def test_registry_shape():
    names = [s.name for s in anatomy.STAGES]
    assert names == [
        "key_sort", "plan_compare", "hash_render", "minute_fold",
        "delta_encode", "pull_wave", "device_dispatch", "host_apply",
    ]
    device = [s for s in anatomy.STAGES if s.kind == "device"]
    assert len(device) == 5
    # Device stages chain: each stage's inputs come from prior outputs
    # or the kernel's own input columns.
    produced = {"cell_id", "k1", "k2", "ex_k1", "ex_k2", "owner_ix"}
    for s in device:
        assert set(s.inputs) <= produced, (s.name, s.inputs)
        produced |= set(s.outputs)
    # Every price term names a real law key of the port's one priced
    # platform, and the port prices nothing but the card.
    assert set(anatomy.COST_LAWS) == {"cuda"}
    for s in anatomy.STAGES:
        for law_key, unit in s.price:
            if unit == "device_pipeline":
                continue
            for plat, laws in anatomy.COST_LAWS.items():
                assert law_key in laws, (s.name, law_key, plat)


def test_registry_digest_is_stable_and_law_sensitive():
    d1 = anatomy.registry_digest()
    assert d1 == anatomy.registry_digest()
    assert len(d1) == 8 and int(d1, 16) >= 0
    old = anatomy.COST_LAWS["cuda"]["sort_key_ms_per_1m"]
    try:
        anatomy.COST_LAWS["cuda"]["sort_key_ms_per_1m"] = old * 2 + 1
        assert anatomy.registry_digest() != d1  # re-pricing moves the digest
    finally:
        anatomy.COST_LAWS["cuda"]["sort_key_ms_per_1m"] = old


# --- floor pricing ---


def test_floor_prices_the_cuda_row_exactly():
    # The H100 row's recorded numbers, priced by hand.
    assert anatomy.floor_ms("key_sort", rows=1_000_000, platform="cuda") == pytest.approx(0.2095 + 2 * 0.5375)
    assert anatomy.floor_ms("pull_wave", nbytes=3_019_000_000, platform="cuda") == pytest.approx(1000.0)
    assert anatomy.floor_ms("host_apply", rows=58_013, platform="cuda") == pytest.approx(1000.0)
    assert anatomy.floor_ms("device_dispatch", rows=1_000_000, platform="cuda") == pytest.approx(
        121.19 + 0.2095 + 2 * 0.5375 + 0.6911 + 0.0719 + 0.6995 + 0.2681)
    laws = anatomy.COST_LAWS["cuda"]
    # key_sort at 1M rows = the key's law + 2 × the payload's.
    assert anatomy.floor_ms("key_sort", rows=1_000_000, platform="cuda") == pytest.approx(
        laws["sort_key_ms_per_1m"] + 2 * laws["sort_payload_ms_per_1m"])
    for stage, law in (("plan_compare", "plan_scan_pair_ms_per_1m"), ("hash_render", "hash_render_ms_per_1m"),
                       ("minute_fold", "minute_fold_ms_per_1m"), ("delta_encode", "delta_encode_ms_per_1m")):
        assert anatomy.floor_ms(stage, rows=2_000_000, platform="cuda") == pytest.approx(2 * laws[law])
    # pull_wave is bandwidth-priced: one second's bytes take 1000 ms.
    assert anatomy.floor_ms("pull_wave", nbytes=int(laws["pull_mb_per_s"] * 1e6),
                            platform="cuda") == pytest.approx(1000.0)
    # host_apply is throughput-priced: one second's rows take 1000 ms.
    assert anatomy.floor_ms("host_apply", rows=int(laws["host_apply_rows_per_s"]),
                            platform="cuda") == pytest.approx(1000.0, rel=1e-6)
    # device_dispatch = the fixed cost + the whole device pipeline at size.
    dev_sum = sum(anatomy.floor_ms(s.name, rows=1_000_000, platform="cuda")
                  for s in anatomy.STAGES if s.kind == "device")
    assert anatomy.floor_ms("device_dispatch", rows=1_000_000, platform="cuda") == pytest.approx(
        laws["fixed_rtt_ms"] + dev_sum)
    # Span targets price as the sum of their mapped stages.
    merkle = sum(anatomy.floor_ms(s, rows=1_000_000, platform="cuda")
                 for s in ("hash_render", "minute_fold", "delta_encode"))
    assert anatomy.floor_ms("kernel:merkle", rows=1_000_000, platform="cuda") == pytest.approx(merkle)


def test_the_cpu_is_unpriced():
    """The plain versions on the CPU carry no cost law: floors are 0.0 and
    nothing is ever flagged, as the reference treats an unknown platform."""
    anatomy.set_platform("cpu")
    assert anatomy.floor_ms("key_sort", rows=1 << 20) == 0.0
    for _ in range(5):
        anatomy.record_stage("host_apply", 5.0, rows=10)
    assert metrics.get_counter("evolu_stage_over_floor_total", stage="host_apply") == 0
    assert anatomy.stages_payload()["stages"]["host_apply"]["floor_ms"] == 0.0


def test_unknown_platform_and_stage_are_unpriced():
    assert anatomy.floor_ms("key_sort", rows=1 << 20, platform="riscv") == 0.0
    assert anatomy.floor_ms("no_such_stage", rows=1 << 20, platform="cuda") == 0.0
    anatomy.set_platform("riscv")
    assert anatomy.floor_ms("key_sort", rows=1 << 20) == 0.0


# --- the evolu_stage_* family ---


def _rows_for_10ms():
    return int(anatomy.COST_LAWS["cuda"]["host_apply_rows_per_s"] / 100)


def test_record_stage_emits_family():
    anatomy.set_platform("cuda")
    rows = _rows_for_10ms()
    floor = anatomy.floor_ms("host_apply", rows=rows)
    assert floor == pytest.approx(10.0, rel=1e-3)
    anatomy.record_stage("host_apply", floor / 1e3, rows=rows)
    assert metrics.get_counter("evolu_stage_seconds_total",
                               stage="host_apply") == pytest.approx(floor / 1e3)
    assert metrics.get_counter("evolu_stage_rows_total",
                               stage="host_apply") == rows
    _, _, _, count = metrics.registry.get_histogram("evolu_stage_ms",
                                                    stage="host_apply")
    assert count == 1
    assert metrics.registry.get_gauge(
        "evolu_stage_floor_ms", stage="host_apply") == pytest.approx(floor)
    assert metrics.registry.get_gauge(
        "evolu_stage_over_floor_ratio", stage="host_apply"
    ) == pytest.approx(1.0)


def test_over_floor_flags_only_past_warmup():
    anatomy.set_platform("cuda")
    rows = _rows_for_10ms()
    # floor ≈ 10 ms; 100 ms is 10× over FLOOR_FACTOR=4.
    for _ in range(2):  # warm-up records never flag (first launches build)
        anatomy.record_stage("host_apply", 0.100, rows=rows)
    assert metrics.get_counter("evolu_stage_over_floor_total",
                               stage="host_apply") == 0
    anatomy.record_stage("host_apply", 0.100, rows=rows)
    assert metrics.get_counter("evolu_stage_over_floor_total",
                               stage="host_apply") == 1
    anatomy.record_stage("host_apply", 0.011, rows=rows)  # healthy: no flag
    assert metrics.get_counter("evolu_stage_over_floor_total",
                               stage="host_apply") == 1


def test_slope_fit_recovers_synthetic_law():
    # Synthetic stage law: 5 ms fixed + 2 µs/row. The decayed online
    # fit must separate intercept from slope (the wall/count trap).
    anatomy.set_platform("unknown-bench")
    for rows in (1000, 4000, 16000, 2000, 8000, 32000):
        anatomy.record_stage("device_dispatch", (5.0 + 0.002 * rows) / 1e3,
                             rows=rows)
    slope = metrics.registry.get_gauge("evolu_stage_slope_ns_per_row",
                                       stage="device_dispatch")
    fixed = metrics.registry.get_gauge("evolu_stage_fixed_ms",
                                       stage="device_dispatch")
    assert slope == pytest.approx(2000.0, rel=0.05)  # 2 µs = 2000 ns/row
    assert fixed == pytest.approx(5.0, rel=0.05)


def test_runtime_share_gauges():
    anatomy.set_platform("unknown-bench")
    anatomy.record_stage("device_dispatch", 0.030, rows=100)
    anatomy.record_stage("pull_wave", 0.010, nbytes=1000)
    anatomy.record_stage("host_apply", 0.060, rows=100)
    total = 0.030 + 0.010 + 0.060
    assert metrics.registry.get_gauge(
        "evolu_stage_share", stage="host_apply"
    ) == pytest.approx(0.060 / total)
    assert metrics.registry.get_gauge(
        "evolu_stage_share", stage="pull_wave"
    ) == pytest.approx(0.010 / total)
    payload = anatomy.stages_payload()
    assert payload["stages"]["device_dispatch"]["share"] == pytest.approx(
        0.030 / total)


def test_disabled_registry_records_nothing():
    metrics.set_enabled(False)
    try:
        anatomy.record_stage("host_apply", 0.5, rows=10_000)
    finally:
        metrics.set_enabled(True)
    assert anatomy.stages_payload()["stages"] == {}


def test_kernel_span_folds_into_family():
    anatomy.set_platform("cuda")
    with span("kernel:merkle", "t", n=1000):
        pass
    with span("host:apply", "t"):  # non-kernel spans stay out
        pass
    payload = anatomy.stages_payload()
    assert payload["stages"]["kernel:merkle"]["count"] == 1
    assert "host:apply" not in payload["stages"]
    assert metrics.get_counter("evolu_stage_rows_total",
                               stage="kernel:merkle") == 1000
    # The span target priced via its mapped stages.
    assert payload["stages"]["kernel:merkle"]["floor_ms"] == pytest.approx(
        anatomy.floor_ms("kernel:merkle", rows=1000, platform="cuda"))


def test_stages_payload_shape_and_reset():
    anatomy.set_platform("cuda")
    anatomy.record_stage("host_apply", 0.010, rows=7200)
    p = anatomy.stages_payload()
    assert p["platform"] == "cuda"
    assert p["registry_digest"] == anatomy.registry_digest()
    assert p["floor_factor"] == anatomy.FLOOR_FACTOR
    st = p["stages"]["host_apply"]
    assert st["count"] == 1
    assert st["ewma_ms"] == pytest.approx(10.0)
    json.dumps(p)  # must be JSON-clean for GET /stats
    logger.clear()
    assert anatomy.stages_payload()["stages"] == {}
    assert anatomy.get_platform() == "cuda"  # platform survives clear


def test_the_mesh_pushes_the_platform():
    """A mesh on the CPU sets the platform to "cpu" (unpriced); on the card
    `parallel.mesh` sets "cuda"."""
    from evolu_tpu_torch.parallel.mesh import create_mesh, single_mesh

    anatomy.set_platform("unknown")
    create_mesh(devices=["cpu"] * 2)
    assert anatomy.get_platform() == "cpu"
    anatomy.set_platform("unknown")
    single_mesh("cpu")
    assert anatomy.get_platform() == "cpu"


# --- parity with the JAX package ---


def test_anatomy_parity_with_jax_under_the_same_laws(monkeypatch):
    """With the same COST_LAWS injected into both packages, the registry
    (names, kinds, inputs, outputs, price terms) and its digest agree, and
    so do floor_ms at every stage and size, and stages_payload() after the
    same records."""
    from evolu_tpu.obs import anatomy as janatomy
    from evolu_tpu.utils.log import logger as jlogger

    laws = {"cuda": dict(anatomy.COST_LAWS["cuda"]), "cpu": dict(janatomy.COST_LAWS["cpu"])}
    monkeypatch.setattr(anatomy, "COST_LAWS", laws)
    monkeypatch.setattr(janatomy, "COST_LAWS", laws)
    assert [(s.name, s.kind, s.inputs, s.outputs, s.price) for s in anatomy.STAGES] == \
        [(s.name, s.kind, s.inputs, s.outputs, s.price) for s in janatomy.STAGES]
    assert anatomy.registry_digest() == janatomy.registry_digest()
    names = [s.name for s in anatomy.STAGES] + ["kernel:merkle", "kernel:reconcile", "nope"]
    for platform in ("cuda", "cpu", "riscv"):
        for name in names:
            for rows, nbytes in ((0, 0), (1000, 4096), (1 << 20, 1 << 24)):
                assert anatomy.floor_ms(name, rows=rows, nbytes=nbytes, platform=platform) == \
                    janatomy.floor_ms(name, rows=rows, nbytes=nbytes, platform=platform), (platform, name, rows)
    prev = janatomy.get_platform()
    jlogger.clear()
    try:
        for mod in (anatomy, janatomy):
            mod.set_platform("cuda")
            for i in range(12):
                mod.record_stage("device_dispatch", 0.001 * (i + 1), rows=1000 * (i + 1))
                mod.record_stage("pull_wave", 0.0005, nbytes=1 << 16)
                mod.record_stage("host_apply", 0.002 * (i % 3 + 1), rows=500 * (i + 1))
            mod.record_span("kernel:merkle", 3.5, rows=4096)
        assert anatomy.stages_payload() == janatomy.stages_payload()
    finally:
        janatomy.set_platform(prev)
        jlogger.clear()
