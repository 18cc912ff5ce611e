"""``roofline.py`` against ``chip_smoke.py``'s arithmetic: at the shapes of the
kernel table's K1/K2, K2-FF, K7 and K8 rows the FLOPs and bytes are the same;
only the peak differs.  And no share can pass 100% for a kernel time at or
above its bound."""

from __future__ import annotations

import importlib.util

import pytest

from _tiny import ROOT
from portbench import readers, roofline, trace


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_roofline", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # capture (FLOPs, bytes) where chip_smoke turns them into milliseconds
    mod._bound = lambda flops, nbytes: (flops, nbytes)
    return mod


P_BENCH, K_BENCH = 4_382_656, 68_479          # d48/t32
P_FF, K_FF = 9_906_624, 154_791               # contaminant d64/t40
P_CHUNK = 619_200                             # its LM chunk at k_chunks 16
FF_NET = dict(widths=(96, 96, 96), k0=256, n_in=3)

ROWS = [
    # K1/K2 at the bench shape and at the flagship recipe's w48x2
    dict(kind="fwd", widths=(20, 20), k0=3, panels=2, points=P_BENCH, n_in=3, n_k=K_BENCH),
    dict(kind="bwd", widths=(20, 20), k0=3, panels=2, points=P_BENCH, n_in=3, n_k=K_BENCH),
    dict(kind="fwd", widths=(48, 48), k0=3, panels=2, points=P_BENCH, n_in=3, n_k=K_BENCH),
    dict(kind="bwd", widths=(48, 48), k0=3, panels=2, points=P_BENCH, n_in=3, n_k=K_BENCH),
    # K2-FF
    dict(kind="fwd", panels=2, points=P_FF, n_k=K_FF, **FF_NET),
    dict(kind="bwd", panels=2, points=P_FF, n_k=K_FF, **FF_NET),
    # K7 fwd / bwd and K8 at the LM chunk
    dict(kind="fwd", panels=4, points=P_CHUNK, **FF_NET),
    dict(kind="bwd", panels=4, points=P_CHUNK, **FF_NET),
    dict(kind="jvp", panels=4, points=P_CHUNK, **FF_NET),
]


@pytest.mark.parametrize("row", ROWS, ids=lambda r: f"{r['kind']}-{r['widths']}-{r['points']}")
def test_flops_and_bytes_equal_chip_smoke(smoke, row):
    assert roofline.bounds(**row) == smoke._bounds(**row)
    args = {k: row[k] for k in ("kind", "widths", "k0", "panels", "points")}
    assert roofline.flops(**args) == smoke._flops(**args)
    assert roofline.n_params(row["widths"], row["k0"]) == smoke._n_params(row["widths"], row["k0"])


def test_only_the_peak_differs(smoke):
    assert roofline.PEAK_FLOPS == 495e12 and roofline.PEAK_BYTES == smoke.HBM == 3.35e12
    assert smoke.PEAK_F32 == 67e12   # the CUDA cores' rate, which a 3xTF32 kernel passes


def test_shapes_of_the_configs():
    from _tiny import harness

    flag = roofline.shapes(harness.load_cell("flagship-adam").config)
    cont = roofline.shapes(harness.load_cell("contaminant-lm").config)
    assert (flag["tests"], flag["points"], flag["bc_points"], flag["ic_points"]) == (
        K_BENCH, P_BENCH, 4 * 48 * 33, 47 * 47)
    assert (cont["tests"], cont["points"], cont["bc_points"], cont["ic_points"], cont["k0"]) == (
        K_FF, P_FF, 3 * 64 * 41, 63 * 63, 256)


class _Ctx:
    def __init__(self, events, shapes, units, hi, params=None):
        self.events, self.shapes, self.units, self.lo, self.hi = events, shapes, units, 0.0, hi
        self.cell = type("C", (), {"workload": {"params": params or {}}})()


def _kernel(name, seconds, start=0.0):
    return trace.Event(name, True, True, start, start + seconds)


FLAG = {"form": "transient_rect2d", "disc_num": 48, "t_disc_num": 32, "b_disc_num": 48, "bc_segments": [True] * 4,
        "layer_width": [48, 48]}
CONT = {"form": "transient_rect2d", "disc_num": 64, "t_disc_num": 40, "b_disc_num": 64, "fourier_features": 128,
        "bc_segments": [True, False, True, True], "layer_width": [96, 96, 96]}
# per metric: its config, and (kernel name, bound arguments after the net) per launch kind
READERS = {
    "k1k2_roofline": (FLAG, [("void vr_fwd_kernel<48, false>(VrProblem)", ("fwd", 2, "P", 3, "K")),
                             ("void vr_bwd_kernel<48, 2, false>(VrProblem)", ("bwd", 2, "P", 3, "K"))]),
    "k2ff_roofline": (CONT, [("void ff_fwd_kernel<3, false>(FfProblem)", ("fwd", 2, "P", 3, "K")),
                             ("void ff_bwd_kernel<3, false>(FfProblem)", ("bwd", 2, "P", 3, "K"))]),
    "k7_roofline": (CONT, [("void ff_fwd_kernel<3, false>(FfProblem)", ("fwd", 4, "C", 3)),
                           ("void ff_bwd_kernel<3, false>(FfProblem)", ("bwd", 4, "C", 3))]),
    "k8_roofline": (CONT, [("void ff_jvp_kernel<3, false>(FfProblem)", ("jvp", 4, "C", 3))]),
}


@pytest.mark.parametrize("stretch", [1.0, 1.0001, 1.7, 40.0])
@pytest.mark.parametrize("metric", sorted(READERS))
def test_shares_stay_at_or_under_100_for_any_time_at_or_above_the_bound(metric, stretch):
    from _tiny import harness

    config, launches = READERS[metric]
    s = roofline.shapes(config)
    sub = {"P": s["points"], "K": s["tests"], "C": s["points"] / 16}
    evs, at = [], 0.0
    for name, args in launches:
        kind, *rest = args
        rest = [sub.get(a, a) if isinstance(a, str) else a for a in rest]
        bound = roofline.bound_seconds(*roofline.bounds(kind, s["widths"], s["k0"], *rest))
        for _ in range(3):
            evs.append(_kernel(name, bound * stretch, at))
            at += bound * stretch
    reader = harness.load_module(ROOT / "portbench" / "metrics" / f"{metric}.py", f"m_{metric}")
    share = reader.read(_Ctx(evs, s, 3, at, {"k_chunks": 16, "cg_iters": 10}))
    assert share == pytest.approx(100.0 / stretch) and share <= 100.0 + 1e-9


@pytest.mark.parametrize("stretch", [1.0, 3.0])
def test_mfu_stays_at_or_under_100(stretch):
    s = roofline.shapes(CONT)
    for flops in (roofline.adam_step_flops(s), roofline.lm_iteration_flops(s, 10)):
        window = 10 * flops / roofline.PEAK_FLOPS * stretch
        assert readers.mfu(_Ctx([], s, 10, window), flops) == pytest.approx(100.0 / stretch)


def test_a_reader_with_nothing_to_read_returns_none():
    s = roofline.shapes({"form": "transient_rect2d", "disc_num": 8, "t_disc_num": 4, "b_disc_num": 8,
                         "bc_segments": [True] * 4, "layer_width": [8, 8]})
    assert readers.kernel_roofline(_Ctx([], s, 1, 1.0), r"\bvr_fwd_kernel\b", []) is None
