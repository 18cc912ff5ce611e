"""The port's program spans (``varnet_tpu_torch/utils/spans.py``) on the CPU:

* off, ``span`` returns one shared no-op context and nothing is recorded;
* on, spans nest with their parents, ``record()`` scopes nest, and the counts
  are the closed spans by name;
* spans are on the clock of ``torch.profiler``'s events: a span holds the
  profiler's events of the work done inside it;
* on a tiny problem the counts are exact: ``train.epoch`` = epochs,
  ``train.report`` = reports, ``lm.cg_iter`` = steps x cg_iters,
  ``lm.linearize`` = steps x ceil(cg_iters / cg_segment) (steps at segment 0);
* ``train`` / ``refine_lm`` give bit-equal results with the recorder on and off;
  ``TrainResult.prepare_seconds`` / ``report_seconds`` are the lengths of the
  ``*.prepare`` / ``*.report`` spans; ``train(profile_dir=)`` puts the spans on
  the Chrome trace's ``varnet`` track;
* ``scripts/span_report.py``'s join of kernels to spans (correlation ids, the
  innermost span at the launch call, idle gaps by span) on synthetic events;
* with exact BC, ``prepare.hard_tables`` (the f64 table build) opens once per
  test space, inside the first ``train.prepare`` or ``lm.prepare``, and
  ``prepare.coeff_fold`` (K4's fold) once a ``train`` call; with the recorder
  off nothing is recorded; ``span_report.py`` sums their seconds and counts.
"""

import importlib.util
import json
import math
import os
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from varnet_tpu_torch import VarNet
from varnet_tpu_torch.problems.analytic import transient_ad_2d, transient_ad_3d
from varnet_tpu_torch.utils import spans
from _torch_threads import _one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
MESH = dict(layer_width=(8, 8), disc_num=4, b_disc_num=4, t_disc_num=3, device="cpu")
W = (1.0, 10.0, 10.0)
EVAL = dict(verbose=False, error_disc=4, error_times=2)


def _vn():
    return VarNet(transient_ad_2d()["pde"], **MESH)


def _span_report():
    spec = importlib.util.spec_from_file_location(
        "span_report", ROOT / "scripts" / "span_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_off_is_one_shared_no_op():
    assert not spans._ON
    a, b = spans.span("a"), spans.span("b")
    assert a is b is spans._OFF
    with a:
        with b:
            pass
    with spans.record() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}
    assert not spans._ON


def test_nesting_parents_and_counts():
    with spans.record() as rec:
        assert spans._ON
        with spans.span("a"):
            with spans.span("b"):
                with spans.span("c"):
                    pass
            with spans.span("b"):
                with spans.record() as inner:
                    with spans.span("d"):
                        pass
        with spans.span("e"):
            pass
    assert not spans._ON
    got = [(s.name, s.parent) for s in rec.spans]
    assert got == [("a", None), ("b", 0), ("c", 1), ("b", 0), ("d", 3), ("e", None)]
    assert rec.counts == {"a": 1, "b": 2, "c": 1, "d": 1, "e": 1}
    # a nested scope sees its own spans, parents outside it cut off
    assert [(s.name, s.parent) for s in inner.spans] == [("d", None)]
    for s in rec.spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns


def test_a_span_left_open_by_its_recording():
    with spans.record() as first:
        outer = spans.span("outer")
        outer.__enter__()
    assert first.spans[0].t1_ns is None and first.counts == {}
    with spans.record() as second:
        with spans.span("fresh"):
            pass
    outer.__exit__(None, None, None)
    # the open span of the old recording is no parent in the new one
    assert [(s.name, s.parent) for s in second.spans] == [("fresh", None)]


def test_threads_keep_their_own_parents():
    n_threads, n_iter = 3 * (os.cpu_count() or 2), 200
    errors = []

    def work(k):
        try:
            for _ in range(n_iter):
                with spans.span(f"t{k}"):
                    with spans.span(f"t{k}.in"):
                        pass
        except Exception as err:  # noqa: BLE001  (reported by the assertion below)
            errors.append(err)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.record() as rec:
            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    recorded = rec.spans
    assert rec.counts == {f"t{k}{x}": n_iter for k in range(n_threads) for x in ("", ".in")}
    for s in recorded:
        if s.name.endswith(".in"):
            assert recorded[s.parent].name == s.name[:-3]
        else:
            assert s.parent is None


def test_timed_measures_with_the_recorder_off_and_on():
    with spans.timed("x") as t:
        time.sleep(0.01)
    assert t.seconds >= 0.01
    with spans.record() as rec:
        with spans.timed("x") as t:
            time.sleep(0.01)
    (s,) = rec.spans
    assert abs((s.t1_ns - s.t0_ns) * 1e-9 - t.seconds) < 0.005


def test_spans_share_the_profilers_clock():
    a = torch.randn(200, 200)
    with spans.record() as rec, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("work"):
            time.sleep(0.005)
            torch.mm(a, a)
            time.sleep(0.005)
    (s,) = rec.spans
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert s.t0_ns < e.start_ns() and e.start_ns() + e.duration_ns() < s.t1_ns


def test_train_counts_and_result_times():
    vn = _vn()
    with spans.record() as rec:
        res = vn.train(epoch_num=5, weight=W, save_freq=2, **EVAL)
    c = rec.counts
    assert c["train.call"] == c["train.prepare"] == 1
    assert c["train.epoch"] == 5
    assert c["train.report"] == len(res.epochs) == 3          # epochs 2, 4, 5
    assert c["train.drain"] == 1 + 3 + 1                      # warm-up, reports, end
    recorded, by = rec.spans, {}
    for s in recorded:
        by.setdefault(s.name, []).append(s)
    call = recorded.index(by["train.call"][0])
    assert all(s.parent == call for n in ("train.prepare", "train.epoch", "train.drain",
                                          "train.report") for s in by[n])
    prep = by["train.prepare"][0]
    assert abs((prep.t1_ns - prep.t0_ns) * 1e-9 - res.prepare_seconds) < 0.05
    reports = sum(s.t1_ns - s.t0_ns for s in by["train.report"]) * 1e-9
    assert abs(reports - res.report_seconds) < 0.05
    d = res.as_dict()
    assert d["prepare_seconds"] == res.prepare_seconds > 0
    assert d["report_seconds"] == res.report_seconds > 0


def test_build_spans():
    with spans.record() as rec:
        _vn()
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("varnet.build", None), ("build.assembly", 0), ("build.to_device", 0)]


@pytest.mark.parametrize("cg_iters,cg_segment", [(5, 0), (5, 2), (4, 2), (3, 5)])
def test_lm_counts(cg_iters, cg_segment):
    vn = _vn()
    steps = 2
    with spans.record() as rec:
        res = vn.refine_lm(steps=steps, weight=W, cg_iters=cg_iters, cg_segment=cg_segment,
                           k_chunks=2, save_freq=1, **EVAL)
    c = rec.counts
    assert c["lm.call"] == c["lm.prepare"] == 1
    assert c["lm.iteration"] == c["lm.accept"] == steps
    assert c["lm.cg_iter"] == steps * cg_iters
    segments = math.ceil(cg_iters / cg_segment) if cg_segment else 1
    assert c["lm.linearize"] == steps * segments
    assert c["lm.report"] == len(res.epochs) == steps
    assert c["lm.drain"] == 1 + steps
    recorded = rec.spans
    iterations = [i for i, s in enumerate(recorded) if s.name == "lm.iteration"]
    for s in recorded:
        if s.name in ("lm.cg_iter", "lm.linearize", "lm.accept"):
            assert s.parent in iterations
    assert res.prepare_seconds > 0 and res.report_seconds > 0


HARD = dict(layer_width=(8, 8), disc_num=3, b_disc_num=3, t_disc_num=2, device="cpu", hard_bc=True)
HARD_EVAL = dict(verbose=False, error_disc=3, error_times=2)


def _hard_vn(**kw):
    return VarNet(transient_ad_3d()["pde"], **HARD, **kw)


def _children(recorded, name, parent_name):
    """The spans ``name`` and whether each sits directly in a ``parent_name``."""
    found = [s for s in recorded if s.name == name]
    return found, [s.parent is not None and recorded[s.parent].name == parent_name for s in found]


def test_hard_train_spans_the_table_build_once_and_the_fold_per_call():
    vn = _hard_vn()
    with spans.record() as rec:
        for _ in range(2):
            vn.train(epoch_num=2, save_freq=2, **HARD_EVAL)
    assert rec.counts["train.call"] == rec.counts["train.prepare"] == 2
    assert rec.counts["prepare.hard_tables"] == 1             # cached for the second call
    assert rec.counts["prepare.coeff_fold"] == 2              # K4's fold, once a call
    for name in ("prepare.hard_tables", "prepare.coeff_fold"):
        found, inside = _children(rec.spans, name, "train.prepare")
        assert found and all(inside), name
    (build,) = [s for s in rec.spans if s.name == "prepare.hard_tables"]
    assert abs((build.t1_ns - build.t0_ns) * 1e-9 - vn.hard_table_seconds) < 0.05


def test_hard_lm_spans_the_table_build_in_its_prepare():
    vn = _hard_vn()
    with spans.record() as rec:
        vn.refine_lm(steps=1, cg_iters=2, k_chunks=2, save_freq=1, **HARD_EVAL)
    assert rec.counts["prepare.hard_tables"] == 1
    found, inside = _children(rec.spans, "prepare.hard_tables", "lm.prepare")
    assert all(inside)
    # LM applies the ansatz chunk by chunk (hard_transform): it folds no coefficients
    assert "prepare.coeff_fold" not in rec.counts


def test_hard_spans_record_nothing_with_the_recorder_off():
    vn = _hard_vn()
    before = len(spans._BUF)
    vn.train(epoch_num=2, save_freq=2, **HARD_EVAL)
    vn.refine_lm(steps=1, cg_iters=2, k_chunks=2, save_freq=1, **HARD_EVAL)
    assert not spans._ON and len(spans._BUF) == before
    assert vn.hard_table_seconds > 0                          # still timed, as before


def test_span_report_exact_bc_metrics_on_synthetic_spans():
    sr = _span_report()
    S = spans.Span
    recorded = [S("train.call", None, 0, 10_000), S("train.prepare", 0, 100, 4_000),
                S("prepare.hard_tables", 1, 200, 2_200), S("prepare.coeff_fold", 1, 2_300, 3_300),
                S("train.call", None, 20_000, 30_000), S("train.prepare", 4, 20_100, 21_000),
                S("prepare.coeff_fold", 5, 20_200, 20_700)]
    assert sr.exact_bc_metrics(recorded, 0) == pytest.approx(
        {"hard_tables_s": 2e-6, "hard_tables_count": 1, "coeff_fold_s": 1e-6, "coeff_fold_count": 1})
    assert sr.exact_bc_metrics(recorded, 4) == pytest.approx(
        {"coeff_fold_s": 0.5e-6, "coeff_fold_count": 1})
    assert sr.seconds_by_name(recorded)["prepare.coeff_fold"] == pytest.approx(1.5e-6)
    plain = [S("train.call", None, 0, 10), S("train.prepare", 0, 1, 5)]
    assert sr.exact_bc_metrics(plain, 0) == {}


def test_results_bit_equal_with_the_recorder_on_and_off():
    def run(on):
        vn = _vn()
        with spans.record() if on else spans._OFF:
            tr = vn.train(epoch_num=4, weight=W, save_freq=2, **EVAL)
            lm = vn.refine_lm(steps=2, weight=W, cg_iters=3, cg_segment=2, k_chunks=2,
                              save_freq=1, **EVAL)
        return tr, lm, [t.clone() for layer in vn.theta for t in (layer["w"], layer["b"])]

    (tr0, lm0, th0), (tr1, lm1, th1) = run(False), run(True)
    assert tr0.losses == tr1.losses and lm0.losses == lm1.losses
    assert all(torch.equal(a, b) for a, b in zip(th0, th1))


def test_profile_dir_trace_holds_the_spans(tmp_path):
    folder = str(tmp_path / "prof")
    _vn().train(epoch_num=6, weight=W, save_freq=3, profile_dir=folder, profile_steps=3, **EVAL)
    (name,) = os.listdir(folder)
    with open(os.path.join(folder, name)) as f:
        trace = json.load(f)
    ours = [e for e in trace["traceEvents"] if e.get("cat") == "varnet"]
    names = [e["name"] for e in ours]
    # epochs 2-4 are traced: their steps, and the report at epoch 3
    assert names.count("train.epoch") == 3
    assert names.count("train.report") == names.count("train.drain") == 1
    assert all(e["ph"] == "X" and e["pid"] == "varnet" and e["dur"] >= 0 for e in ours)
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"]
    epochs = [e for e in ours if e["name"] == "train.epoch"]
    lo, hi = epochs[0]["ts"], epochs[-1]["ts"] + epochs[-1]["dur"]
    # the host's ops of those steps fall inside the spans' extent
    assert sum(lo <= e["ts"] <= hi for e in ops) > len(ops) // 2
    assert not spans._ON


# scripts/span_report.py's join on synthetic events ------------------------

class _Ev:
    """portbench.trace.Event's fields, in seconds."""

    def __init__(self, name, on_device, start, end):
        self.name, self.on_device, self.start, self.end = name, on_device, start, end
        self.kernel = on_device and not name.startswith(("Memcpy", "Memset"))


def _synthetic():
    """Spans (us after 1,000 s): call [0, 100] us > prepare [0, 10], epoch [10, 40],
    report [60, 70], then nothing; kernels launched in prepare, in epoch (twice),
    in report, and one launch call with no kernel; the card busy [12, 30],
    [35, 50], [62, 65]; window [0, 120] us."""
    base = 10 ** 12
    us = lambda t: base + int(t * 1000)  # noqa: E731
    S = spans.Span
    recorded = [S("train.call", None, us(0), us(100)), S("train.prepare", 0, us(0), us(10)),
                S("train.epoch", 0, us(10), us(40)), S("train.report", 0, us(60), us(70))]
    sec = lambda t: (base + t * 1000) * 1e-9  # noqa: E731
    events = [
        _Ev("cudaLaunchKernel", False, sec(5), sec(6)),      # corr 1, in prepare
        _Ev("cudaLaunchKernel", False, sec(11), sec(12)),    # corr 2, in epoch
        _Ev("cudaLaunchKernel", False, sec(20), sec(21)),    # corr 3, in epoch
        _Ev("cudaLaunchKernel", False, sec(61), sec(62)),    # corr 4, in report
        _Ev("kern_a", True, sec(12), sec(30)),               # corr 1
        _Ev("kern_b", True, sec(35), sec(45)),               # corr 2
        _Ev("Memcpy HtoD", True, sec(45), sec(50)),          # corr 3
        _Ev("kern_c", True, sec(62), sec(65)),               # corr 4
        _Ev("kern_d", True, sec(0), sec(0)),                 # corr 9: no launch call
        _Ev("cudaDeviceSynchronize", False, sec(119), sec(120)),
    ]
    corr = [1, 2, 3, 4, 1, 2, 3, 4, 9, 0]
    start_ns = [round(e.start * 1e9) if not e.on_device else 0 for e in events]
    start_ns[:4] = [us(5), us(11), us(20), us(61)]
    return recorded, events, corr, start_ns


def test_span_report_join_on_synthetic_events():
    sr = _span_report()
    recorded, events, corr, start_ns = _synthetic()
    at = sr.innermost_index(recorded, recorded[0].t1_ns)
    assert [at(recorded[0].t0_ns + t * 1000) for t in (1, 15, 50, 65, 110)] == [1, 2, 0, 3, None]
    dev = sr.launched(events, corr, start_ns, recorded, recorded[0].t1_ns)
    got = {d.name: (d.span, d.matched) for d in dev}
    assert got == {"kern_a": (1, True), "kern_b": (2, True), "Memcpy HtoD": (2, True),
                   "kern_c": (3, True), "kern_d": (None, False)}
    m = sr.span_metrics("adam", events, corr, start_ns, recorded)
    window = 120e-6
    assert m["window_s"] == pytest.approx(window, rel=1e-6)
    # gaps: [0, 12] prepare, [30, 35] epoch, [50, 62] call, [65, 120] report
    idle = m["idle_by_span"]
    assert idle == pytest.approx({"train.prepare": 12e-6, "train.epoch": 5e-6,
                                  "train.call": 12e-6, "train.report": 55e-6}, abs=1e-9)
    assert m["idle_by_span_sum"] == pytest.approx(m["device_idle"], rel=1e-6)
    assert m["device_idle"] == pytest.approx(100 * 84 / 120, rel=1e-5)
    assert m["adam_epoch_idle"] == pytest.approx(100 * 5 / 120, rel=1e-5)
    assert m["adam_prepare_s"] == pytest.approx(10e-6)
    assert m["adam_report_s"] == pytest.approx(10e-6)
    assert m["kernels"] == 4 and m["kernels_unmatched"] == 1
    assert m["kernels_in_spans"] == pytest.approx(3 / 4)


def test_span_report_reads_every_adam_driver_as_adam():
    sr = _span_report()
    recorded, events, corr, start_ns = _synthetic()
    plain = sr.span_metrics("adam", events, corr, start_ns, recorded)
    timed = sr.span_metrics("adam_timed", events, corr, start_ns, recorded)
    assert timed == plain and "adam_prepare_s" in timed and "lm_cg_ms" not in timed


def test_span_report_lm_metrics_on_synthetic_events():
    sr = _span_report()
    base = 10 ** 12
    us = lambda t: base + int(t * 1000)  # noqa: E731
    sec = lambda t: (base + t * 1000) * 1e-9  # noqa: E731
    S = spans.Span
    # an earlier call's CG iteration must not count; the window's call holds
    # one iteration: linearize [1, 3], two CG iterations [3, 6] and [6, 9], accept [9, 10]
    recorded = [S("lm.call", None, us(-50), us(-40)), S("lm.cg_iter", 0, us(-45), us(-44)),
                S("lm.call", None, us(0), us(20)), S("lm.iteration", 2, us(1), us(10)),
                S("lm.linearize", 3, us(1), us(3)), S("lm.cg_iter", 3, us(3), us(6)),
                S("lm.cg_iter", 3, us(6), us(9)), S("lm.accept", 3, us(9), us(10))]
    launches = [(2, "ff_fwd_kernel", 4), (4, "ff_jvp_kernel", 3), (5, "ff_bwd_kernel", 6),
                (7, "ff_jvp_kernel", 3), (8, "gemvx", 1), (9.5, "ff_fwd_kernel", 2)]
    events, corr, start_ns = [], [], []
    for i, (t, name, dur) in enumerate(launches):
        events.append(_Ev("cudaLaunchKernel", False, sec(t), sec(t + 0.1)))
        corr.append(i + 1)
        start_ns.append(us(t))
    at = 30.0
    for i, (t, name, dur) in enumerate(launches):
        events.append(_Ev(name, True, sec(at), sec(at + dur)))
        corr.append(i + 1)
        start_ns.append(0)
        at += dur
    m = sr.span_metrics("lm", events, corr, start_ns, recorded)
    assert m["lm_cg_iters_in_window"] == 2
    assert m["lm_cg_ms"] == pytest.approx(1e3 * (3 + 6 + 3 + 1) * 1e-6 / 2)
    assert m["lm_kernels_per_cg_iter"] == 2.0
    assert m["lm_outside_cg_share"] == pytest.approx(100 * 6 / 19)
    assert m["ff_jvp_launches"] == m["ff_jvp_in_cg_iter"] == 2
    assert m["kernels_in_spans"] == 1.0
    assert m["by_span"]["ff_fwd_kernel | lm.linearize"] == [1, pytest.approx(4e-6)]
