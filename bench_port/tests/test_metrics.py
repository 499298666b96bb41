"""The metric arithmetic: the rate over the window, the p95 over every
frame, the roofline counts at bar17's and bar135's shapes, and the
reduction of a profile (spans by markers, busy time, idle gaps, guards)."""

from __future__ import annotations

import importlib
import types

import pytest

from bench_port import peaks, tracing


def metric(name):
    return importlib.import_module(f"bench_port.metrics.{name}")


def test_frame_ms_is_the_window_over_its_frames():
    ctx = types.SimpleNamespace(wall=2.5, frames=100)
    assert metric("frame_ms").read(ctx) == pytest.approx(25.0)


def test_frame_ms_p95_is_over_every_frame():
    ctx = types.SimpleNamespace(frame_times=[i / 1000 for i in range(1, 101)])
    # exclusive quantile: 0.95 * 101 = 95.95 -> between the 95th and 96th
    assert metric("frame_ms_p95").read(ctx) == pytest.approx(95.95)


def test_counters_per_frame():
    stats = [{"iters": 7, "syncs": 18}, {"iters": 9, "syncs": 22}]
    ctx = types.SimpleNamespace(frame_stats=stats, frames=2)
    assert metric("iters_per_frame").read(ctx) == 8
    assert metric("syncs_per_frame").read(ctx) == 20


BAR17 = {"P": 6, "nb": 13, "bs": 768, "field": "f32", "factor": "bf16",
         "coarse_n": 0}


def test_factor_count_at_bar17():
    f = metric("h0_factor_roofline")
    flops, nbytes = f.btd_factor_work(6, 13, 768, 4, 2)
    # 6 systems x (13 bs^3 / 3 + 2 x 12 bs^3)
    assert flops == pytest.approx(6 * 768 ** 3 * (13 / 3 + 24))
    # the band read in f32 (25 blocks), the factor written in bf16
    tri = 768 * 769 // 2
    assert nbytes == 6 * 25 * 768 ** 2 * 4 + 6 * (13 * tri + 12 * 768 ** 2) * 2
    t, bound = f.rebuild_least(BAR17)
    assert bound == "bytes"
    assert t == pytest.approx(nbytes / 3.35e12)


BAR135 = dict(BAR17, P=133, nb=8, coarse_n=798)


def test_factor_count_at_bar135_with_the_coarse_space():
    f = metric("h0_factor_roofline")
    shapes = BAR135
    fine = f.btd_factor_work(133, 8, 768, 4, 2)
    t, _ = f.rebuild_least(shapes)
    coarse = max(798 ** 3 / 3 / peaks.H100_SXM["f32"],
                 (798 ** 2 + 798 * 799 / 2) * 4 / 3.35e12)
    fine_t = max(fine[0] / peaks.H100_SXM["bf16"], fine[1] / 3.35e12)
    assert t == pytest.approx(fine_t + coarse)


def test_solve_counts():
    s = metric("h0_solve_roofline")
    flops, nbytes = s.btd_solve_work(6, 13, 768, 2, 1, 4)
    entries = 6 * (13 * 768 * 769 / 2 + 12 * 768 ** 2)
    assert flops == 4 * entries
    assert nbytes == entries * 2 + 2 * 6 * 13 * 768 * 4
    assert s.apply_least(BAR17) == (pytest.approx(nbytes / 3.35e12),
                                    {"bytes"})
    # LBFGS-PD: one P = 1 f32 factor, three columns, its permutations
    pd = dict(BAR17, pd={"nb": 33, "bs": 512, "n_vert": 16473})
    e = 33 * 512 * 513 / 2 + 32 * 512 ** 2
    want = e * 4 + 2 * 33 * 512 * 3 * 4 + 16473 * (4 + 16)
    assert s.pd_least(pd) == (pytest.approx(want / 3.35e12), {"bytes"})


def test_roofline_reads_over_the_spans():
    tr = types.SimpleNamespace(span_calls={"rebuild_h0": 2, "h0_apply": 10},
                               span_s={"h0_factor": 0.01, "h0_solve": 0.005})
    ctx = types.SimpleNamespace(trace=tr, shapes=BAR135, power_limit="700 W",
                                log=lambda *a: None)
    f, s = metric("h0_factor_roofline"), metric("h0_solve_roofline")
    assert f.read(ctx) == pytest.approx(
        100 * 2 * f.rebuild_least(BAR135)[0] / 0.01)
    assert s.read(ctx) == pytest.approx(
        100 * 10 * s.apply_least(BAR135)[0] / 0.005)
    # a cell whose path has no such span reads nothing, never 0
    tr.span_calls = {"pd_solve": 5}
    assert f.read(ctx) is None and s.read(ctx) is None


M = "at::cuda::(anonymous namespace)::spin_kernel(long)"


def _dev(events):
    return [(n, s, e, "memcpy" if n.startswith("Memcpy") else "kernel")
            for n, s, e in events]


def test_reduce_attributes_kernels_between_markers():
    dev = _dev([(M, 0, 1), ("void a<int>(int)", 10, 50), (M, 100, 101),
                ("ns::b", 110, 200), (M, 210, 211), ("c", 220, 300),
                (M, 310, 311), ("d", 320, 400), (M, 400, 401),
                ("Memcpy DtoH (Device -> Pageable)", 800, 900),
                (M, 1000, 1001), ("after", 1100, 1200)])
    log = [("window", 1), ("rebuild_h0", 1), ("h0_factor", 1),
           ("h0_factor", -1), ("rebuild_h0", -1), ("window", -1)]
    tr = tracing.reduce_trace(dev, log, min_kernels=4)
    assert tr.kernels == 4                      # the copy is no kernel
    ns = 1e-9
    assert tr.span_s["rebuild_h0"] == pytest.approx((90 + 80 + 80) * ns)
    assert tr.span_s["h0_factor"] == pytest.approx(80 * ns)
    assert tr.span_calls == {"rebuild_h0": 1, "h0_factor": 1}
    # busy: the work between the window's markers, the markers left out
    assert tr.busy_s == pytest.approx((40 + 90 + 80 + 80 + 100) * ns)
    assert tr.window_s == pytest.approx(1000 * ns)
    assert tr.device_ops[0] == ["Memcpy DtoH (Device -> Pageable)",
                                pytest.approx(100 * ns)]
    # each gap by the span it falls in and the operations around it
    assert dict(tr.idle_gaps) == pytest.approx({
        "loop: window start -> a": 10 * ns, "rebuild_h0: a -> b": 60 * ns,
        "h0_factor: b -> c": 20 * ns, "rebuild_h0: c -> d": 20 * ns,
        "loop: d -> Memcpy DtoH": 400 * ns,
        "loop: Memcpy DtoH -> window end": 100 * ns})


def test_reduce_nested_calls_of_one_span_count_once():
    dev = _dev([(M, 0, 1), (M, 5, 6), (M, 7, 8), ("k", 10, 20), (M, 21, 22),
                (M, 23, 24), (M, 30, 31)])
    log = [("window", 1), ("f", 1), ("f", 1), ("f", -1), ("f", -1),
           ("window", -1)]
    tr = tracing.reduce_trace(dev, log, 1)
    assert tr.span_calls == {"f": 1}
    assert tr.span_s["f"] == pytest.approx(10e-9)


def test_reduce_guards():
    win = [("window", 1), ("window", -1)]
    with pytest.raises(tracing.TraceLost, match="no device events"):
        tracing.reduce_trace(_dev([(M, 0, 1), (M, 50, 51)]), win, 0)
    dev = _dev([(M, 0, 1), ("a", 10, 20), ("b", 30, 40), (M, 50, 51)])
    with pytest.raises(tracing.TraceLost, match="2 device kernels"):
        tracing.reduce_trace(dev, win, 3)
    with pytest.raises(tracing.TraceLost, match="marker"):
        tracing.reduce_trace(dev, win + [("x", 1), ("x", -1)], 1)
    with pytest.raises(tracing.TraceLost, match="window"):
        tracing.reduce_trace(dev, [("x", 1), ("x", -1)], 1)


def test_short_names():
    assert tracing.short("void dotk7::solve_kernel<__nv_bfloat16, float, 1>"
                         "(long long const*)") == "solve_kernel"
    assert tracing.short("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"
    assert tracing.short("direction_kernel") == "direction_kernel"
    assert tracing.short("void at::native::(anonymous namespace)::"
                         "CatArrayBatchedCopy<int>(int*)") == \
        "CatArrayBatchedCopy"


def test_idle_pct_reads_the_busy_union():
    tr = types.SimpleNamespace(busy_s=0.6, window_s=1.0)
    assert metric("idle_pct").read(types.SimpleNamespace(trace=tr)) == \
        pytest.approx(40.0)


def test_span_methods_are_on_the_program():
    """Every method a metric's span wraps is on the program's System (a
    renamed one fails the traced run: SpanMissing)."""
    from dot_tpu_torch.steppers.core import System
    mods = [metric(n) for n in ("rebuild_h0_ms", "h0_apply_ms", "pd_solve_ms",
                                "h0_factor_roofline", "h0_solve_roofline")]
    for m in mods:
        for span, methods in m.SPANS.items():
            for owner, method in methods:
                assert owner == "system" and hasattr(System, method), method
    sim = types.SimpleNamespace(system=System.__new__(System), stepper=None)
    t = tracing.Tracer(sim, {"h0_factor": [("system", "_renamed_factor")]})
    with pytest.raises(tracing.SpanMissing, match="_renamed_factor"):
        t.install()


@pytest.mark.parametrize("stepper,shapes", [("DOT", BAR17), ("DOT", BAR135),
                                            ("LBFGSPD", BAR17)])
def test_needs_name_the_metrics_spans(stepper, shapes):
    shapes = dict(shapes, stepper=stepper)
    for n in ("rebuild_h0_ms", "h0_apply_ms", "pd_solve_ms",
              "h0_factor_roofline", "h0_solve_roofline"):
        m = metric(n)
        for span, per, at_least in m.needs(shapes):
            assert span in m.SPANS and at_least >= 1
            assert per in ("frame", "iter") or per in m.SPANS


def test_spans_count_outermost_calls_and_needs_hold_the_path(monkeypatch):
    class Sys:
        def rebuild_h0(self):
            self.factorize()
            self.factorize()

        def factorize(self):
            self._btd_scan_equilibrated()

        def _btd_scan_equilibrated(self):
            pass

    sim = types.SimpleNamespace(system=Sys(), stepper=None)
    t = tracing.Tracer(sim, {
        "rebuild_h0": [("system", "rebuild_h0")],
        "h0_factor": [("system", "factorize"),
                      ("system", "_btd_scan_equilibrated")]})
    monkeypatch.setattr(t, "mark", lambda span, d: t.log.append((span, d)))
    t.install()
    for _ in range(3):
        sim.system.rebuild_h0()
    t.uninstall()
    assert "rebuild_h0" not in vars(sim.system)
    assert t.calls == {"rebuild_h0": 3, "h0_factor": 6}
    assert len(t.log) == 2 * (3 + 12)
    needs = [("rebuild_h0", "frame", 1), ("h0_factor", "rebuild_h0", 2)]
    tracing.check_needs(needs, t.calls, {"frame": 3, "iter": 20})
    with pytest.raises(tracing.SpanMissing, match="rebuild_h0: 3 calls"):
        tracing.check_needs(needs, t.calls, {"frame": 4, "iter": 20})
    with pytest.raises(tracing.SpanMissing, match="h0_factor"):
        tracing.check_needs([("h0_factor", "rebuild_h0", 3)], t.calls,
                            {"frame": 3, "iter": 20})
