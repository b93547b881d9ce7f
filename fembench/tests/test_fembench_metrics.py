"""Every metric reader computes its value from a synthetic traced episode
and synthetic host readings, and finds nothing where there is nothing to
read."""

import os

import pytest

from conftest import ROOT

from fembench import harness, kernels, peaks, trace

K1 = ("void (anonymous namespace)::element_apply_kernel<float, 4, 3, 6>"
      "(int const*, float const*, float const*, float const*, float const*, "
      "float*, int)")
K4 = "void (anonymous namespace)::banded_sum_kernel_lane<float>(int const*)"
OTHER = "void at::native::vectorized_elementwise_kernel<4, (anonymous)>(int)"


def _x(name, cat, ts, dur, **kw):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": 1}
    if kw:
        e["args"] = kw
    return e


def synthetic_events():
    """One episode of 1000 us: spans update [100, 400) and pcg [400, 900);
    the launches and their device operations (us):
    update: OTHER at 150 (20 us on the device at 200), K4 m=9 at 300 (10
    us at 320); pcg: K1 at 450 (40 us at 500), K4 m=3 at 600 (8 us at
    600), K1 at 700 (40 us at 720); an idle host op aten::item over
    [800, 900)."""
    ev = [_x(trace.EPISODE, "user_annotation", 0, 1000),
          _x("newton.update", "user_annotation", 100, 300),
          _x("newton.pcg", "user_annotation", 400, 500),
          _x("aten::item", "cpu_op", 800, 100)]
    launches = [(OTHER, 150, 200, 20), (K4, 300, 320, 10), (K1, 450, 500, 40),
                (K4, 600, 600, 8), (K1, 700, 720, 40)]
    for corr, (name, t_launch, t_dev, dur) in enumerate(launches):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", t_launch, 5,
                     correlation=corr))
        ev.append(dict(_x(name, "kernel", t_dev, dur, correlation=corr),
                       pid=0, tid=7))
    return ev


SHAPES = dict(E=1000, nv=300, k=4, d=3, N=6, value_bytes=4)


@pytest.fixture
def ctx():
    tr = trace.summarize(synthetic_events(),
                         {"banded_sum_m3": 1, "banded_sum_m9": 1,
                          "element_apply": 2}, steps=1, newton=2)
    return dict(host=dict(load_s=12.5, setup_s=30.0, window_s=20.0,
                          peak_bytes=3 * 2**30),
                counters=dict(steps=8, newton=40, cg=2000, retries=0,
                              broadphase_ms=0.0),
                trace=tr, shapes=SHAPES)


def test_summarize(ctx):
    tr = ctx["trace"]
    assert tr["window_s"] == pytest.approx(1000e-6)
    assert tr["busy_s"] == pytest.approx(118e-6)
    assert tr["span_s"]["newton.update"] == pytest.approx(30e-6)
    assert tr["span_s"]["newton.pcg"] == pytest.approx(88e-6)
    assert tr["kernels"]["element_apply_kernel<float, 4, 3, 6>"] == {
        "n": 2, "s": pytest.approx(80e-6)}
    ops = dict(tr["breakdown"]["device_ops"])
    assert ops["element_apply_kernel<float, 4, 3, 6>"] == pytest.approx(80e-6)
    idle = dict(tr["breakdown"]["idle_gaps"])
    # device idle [0, 200), [220, 320), [330, 500), [540, 600), [608, 720),
    # [760, 1000); the host outside spans [0, 100) and [900, 1000), in
    # update [100, 400), in pcg [400, 900), in aten::item [800, 900)
    assert idle["outside spans/-"] == pytest.approx(200e-6)
    assert idle["newton.update/-"] == pytest.approx(270e-6)
    assert idle["newton.pcg/-"] == pytest.approx(312e-6)
    assert idle["newton.pcg/aten::item"] == pytest.approx(100e-6)
    assert len(tr["breakdown"]["idle_gaps"]) <= 10


def test_short_name_and_enclosing():
    assert trace.short_name(K1) == "element_apply_kernel<float, 4, 3, 6>"
    assert trace.short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"
    ivs = [(0, 10, "a"), (2, 5, "b"), (6, 9, "c"), (12, 20, "d")]
    assert trace.enclosing(ivs, [1, 3, 5.5, 7, 11, 15]) == [
        ("a",), ("a", "b"), ("a",), ("a", "c"), (), ("d",)]


def _read(name, ctx):
    return harness.reader(ROOT, name)(ctx)


def test_end_to_end_readers(ctx):
    assert _read("ms_per_step", ctx) == pytest.approx(2500.0)
    assert _read("setup_s", ctx) == 30.0
    assert _read("peak_mem_gib", ctx) == pytest.approx(3.0)
    assert _read("load_s", ctx) == 12.5


def test_counter_readers(ctx):
    assert _read("newton_per_step", ctx) == 5.0
    assert _read("cg_per_newton", ctx) == 50.0


def test_span_readers(ctx):
    assert _read("update_gpu_ms_per_newton", ctx) == pytest.approx(0.015)
    assert _read("pcg_gpu_ms_per_newton", ctx) == pytest.approx(0.044)
    assert _read("linesearch_gpu_ms_per_newton", ctx) is None
    assert _read("coarse_gpu_ms_per_step", ctx) is None
    assert _read("device_idle_pct", ctx) == pytest.approx(88.2)


def test_roofline_readers(ctx):
    k1 = kernels.k1_bytes(1000, 300, 4, 3, 6, 4)
    assert k1 == 1000 * (16 + 288 + 64 + 48) + 300 * 16
    assert _read("K1_roofline", ctx) == pytest.approx(
        100 * 2 * k1 / peaks.HBM_BYTES_PER_S / 80e-6)
    k4 = kernels.k4_bytes(1000, 300, 4, 3, 4) + kernels.k4_bytes(
        1000, 300, 4, 9, 4)
    assert _read("K4_roofline", ctx) == pytest.approx(
        100 * k4 / peaks.HBM_BYTES_PER_S / 18e-6)
    # launch counters that disagree with the trace: nothing is read
    ctx["trace"]["launches"]["banded_sum_m3"] = 5
    assert _read("K4_roofline", ctx) is None


def test_readers_without_a_trace(ctx):
    ctx["trace"] = None
    ctx["host"]["peak_bytes"] = 0
    for name in ("update_gpu_ms_per_newton", "pcg_gpu_ms_per_newton",
                 "K1_roofline", "K4_roofline", "device_idle_pct",
                 "peak_mem_gib"):
        assert _read(name, ctx) is None


def test_every_metric_has_a_reader():
    bench = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(ROOT, m["name"]))
