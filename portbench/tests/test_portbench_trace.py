"""The trace reduction and the per-layer readers on a made-up trace."""

import pytest

from portbench import peaks, run, trace

OPS = [("void flash_fwd_wgmma_kernel<40, 4>(CUtensorMap, float*)", 100, 300),
       ("void flash_fwd_wgmma_kernel<40, 4>(CUtensorMap, float*)", 250, 400),   # overlaps
       ("void sweep_kernel<40>(CUtensorMap)", 500, 600),
       ("void corr_wgmma_kernel<40>(CUtensorMap)", 600, 650),
       ("void bwd_rows_kernel<40>(CUtensorMap)", 650, 700),
       ("Memcpy DtoH (Device -> Pageable)", 900, 950)]
SPANS = [("unit", 0, 1000), ("run_batch", 0, 1000), ("_cfg_step", 50, 480),
         ("pipeline.unet", 60, 470), ("_decode_post", 700, 1000)]


def test_union_counts_overlap_once():
    assert trace.union(OPS, 0, 1000) == [(100, 400), (500, 700), (900, 950)]
    assert trace.busy_seconds(OPS, 0, 1000) == pytest.approx(550e-9)
    # clipped to the window
    assert trace.busy_seconds(OPS, 200, 550) == pytest.approx(250e-9)


def test_idle_gaps_by_innermost_span():
    assert trace.idle_gaps(OPS, 0, 1000) == [(0, 100), (400, 500), (700, 900), (950, 1000)]
    by = dict(trace.gaps_by_span(OPS, SPANS, 0, 1000))
    # (0, 100) has its middle at 50: _cfg_step; (400, 500) at 450: pipeline.unet;
    # (700, 900) and (950, 1000): _decode_post
    assert by == pytest.approx({"_cfg_step": 100e-9, "pipeline.unet": 100e-9,
                                "_decode_post": 250e-9})


def test_kernel_time_by_name():
    from portbench.metrics import layers

    assert trace.own_seconds(OPS, layers.FLASH_FWD, 0, 1000) == pytest.approx(350e-9)
    assert trace.own_seconds(OPS, layers.CORR_FWD, 0, 1000) == pytest.approx(150e-9)
    top = trace.top_ops(OPS, 0, 1000)
    assert top[0] == ["void flash_fwd_wgmma_kernel<40, 4>", pytest.approx(350e-9)]


def _record(**kw):
    base = dict(units=[{"work": 8, "seconds": 10.0, "timings": {"preprocess": 0.4, "inversion": 1.6,
                                                                "edit_loop": 7.6, "decode_post": 0.4}},
                       {"work": 8, "seconds": 10.0, "timings": {"preprocess": 0.4, "inversion": 1.6,
                                                                "edit_loop": 7.6, "decode_post": 0.4}}],
                work={"model_flops": 2 * 989e12, "flash_flops": 989e12 * 350e-9 / 2,
                      "flash_bytes": 0.0, "corr_flops": 989e12 * 150e-9 / 8, "corr_bytes": 3.35e12 * 150e-9 / 4},
                window_s=20.0, ops=OPS, lo=0, hi=1000, busy_s=550e-9)
    base.update(kw)
    return run.Record(**base)


@pytest.mark.parametrize("name, want", [
    ("prepost_s.sweep", 0.1), ("inversion_s.sweep", 0.2), ("edit_loop_s.sweep", 0.95),
    ("mfu.sweep", 10.0), ("flash_fwd_roofline.sweep", 50.0), ("corr_fwd_roofline.sweep", 25.0),
    ("device_idle.sweep", 45.0), ("mfu.dift", 10.0), ("device_idle.dift", 45.0),
    ("flash_fwd_roofline.dift", 50.0)])
def test_readers_on_a_made_up_record(name, want):
    # busy 550 ns of a 1000 ns window: 45 % idle; 2 PFLOP over 20 s at 989
    # TFLOP/s: 10 %; flash's least time half its 350 ns, correlation's a quarter
    # of its 150 ns (bound by bytes)
    assert run.reader(name)(_record()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["flash_fwd_roofline.sweep", "corr_fwd_roofline.sweep",
                                  "device_idle.sweep", "mfu.sweep"])
def test_readers_find_nothing_without_a_trace(name):
    assert run.reader(name)(_record(ops=None, work={})) is None


def test_readers_find_nothing_where_no_kernel_ran():
    rec = _record(ops=[op for op in OPS if "flash" not in op[0]])
    assert run.reader("flash_fwd_roofline.sweep")(rec) is None
    assert run.reader("prepost_s.sweep")(_record(units=[{"work": 1, "seconds": 0.3}])) is None


def test_least_time_takes_the_larger_bound():
    assert peaks.least_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
