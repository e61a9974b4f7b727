"""The program's spans (`portbench/spans.py`): its readers on a made-up
trace, the breakdown with a program span innermost, the device copies of
spans left out of the device's work, and a tiny traced run on the CPU."""

import pytest

from portbench import run, spans, trace

import tiny

OPS = [("kernel_a", 100, 300), ("kernel_b", 500, 700), ("Memcpy DtoH", 900, 950)]
LABELLED = [("unit", 0, 1000), ("run_batch", 5, 1000), ("pipeline.unet", 60, 480)]
PROGRAM = [("gd.edit_loop", 40, 1000), ("gd.edit.step", 40, 600), ("gd.cfg", 50, 600),
           ("gd.unet", 60, 480), ("gd.unet.up_blocks.1", 70, 470), ("gd.edit.step", 600, 1000),
           ("gd.edit.drain", 600, 880)]
SYNCS = [("cudaStreamSynchronize", 610, 870), ("cudaStreamSynchronize", 20, 30),
         ("cudaMemcpy", 700, 710)]


def test_readers_on_a_made_up_trace():
    # gd.unet covers 420 ns of host time: 105 ns an edit over 4 edits
    assert spans.unet_host_s(PROGRAM, 0, 1000, 4) == pytest.approx(105e-9)
    # idle gaps inside the loop (40, 1000): (40, 100) and (300, 500) have
    # their middles in gd.unet, (700, 900) and (950, 1000) outside it
    assert spans.loop_idle_s(OPS, PROGRAM, 0, 1000, 2) == pytest.approx(125e-9)
    # two blocking calls start inside the two steps, one before them
    assert spans.syncs_per_step(PROGRAM, SYNCS, 0, 1000) == pytest.approx(1.0)
    # clipped to a window holding the first step only
    assert spans.syncs_per_step(PROGRAM, SYNCS, 0, 590) == 0.0
    assert spans.syncs_by_span(PROGRAM, SYNCS, 0, 1000) == {"gd.edit.drain": 2, "no span": 1}


@pytest.mark.parametrize("program, syncs", [([], SYNCS), (PROGRAM, None)])
def test_readers_find_nothing_without_program_spans_or_runtime_calls(program, syncs):
    assert spans.syncs_per_step(program, syncs, 0, 1000) is None
    if not program:
        assert spans.unet_host_s(program, 0, 1000, 4) is None
        assert spans.loop_idle_s(OPS, program, 0, 1000, 4) is None


def test_idle_gaps_go_to_the_innermost_program_span():
    by = dict(trace.gaps_by_span(OPS, LABELLED + PROGRAM, 0, 1000))
    # (0, 100): middle 50, gd.cfg opens at 50; (300, 500): 400, in the up
    # block; (700, 900): 800, in gd.edit.drain; (950, 1000): gd.edit.step
    assert by == pytest.approx({"gd.cfg": 100e-9, "gd.unet.up_blocks.1": 200e-9,
                                "gd.edit.drain": 200e-9, "gd.edit.step": 50e-9})
    # the traffic driver's spans alone give it all to run_batch and pipeline.unet
    assert dict(trace.gaps_by_span(OPS, LABELLED, 0, 1000)) == pytest.approx(
        {"pipeline.unet": 200e-9, "run_batch": 350e-9})


class _Event:
    def __init__(self, name, start, end, cuda, annotation):
        import torch

        self._n, self._s, self._d, self._a = name, start, end - start, annotation
        self._t = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t

    def is_user_annotation(self):
        return self._a


class _Profiler:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: events)})()})()


def test_device_copies_of_spans_are_no_device_work():
    prof = _Profiler([_Event("gd.unet", 60, 480, False, True),
                      _Event("gd.unet", 100, 700, True, True),        # the device copy
                      _Event("kernel_a", 100, 300, True, False),
                      _Event("cudaLaunchKernel", 90, 95, False, False),
                      _Event("cudaStreamSynchronize", 610, 870, False, False),
                      _Event("aten::add", 92, 99, False, False)])
    ops, labelled = trace.from_profiler(prof, ("unit",))
    assert ops == [("kernel_a", 100, 300)] and labelled == []
    assert trace.busy_seconds(ops, 0, 1000) == pytest.approx(200e-9)
    program, syncs = spans.program_events(prof)
    assert program == [("gd.unet", 60, 480)]
    assert syncs == [("cudaStreamSynchronize", 610, 870)]
    # no runtime call listed at all: nothing to count
    assert spans.program_events(_Profiler([_Event("gd.unet", 60, 480, False, True)]))[1] is None


def test_a_tiny_traced_run_reads_the_program_spans():
    w, c, t = tiny.cell("sd14-editor-e8")
    res = spans.traced_run(w, c, t, 2 ** 31 + 7, 0.0, "cpu", run.benchmark())
    prog = res["program"]
    steps = c["edit"]["num_ddim_steps"]
    assert prog["spans"]["gd.edit.step"] == steps * prog["spans"]["gd.edit_loop"]
    assert prog["spans"]["gd.unet"] == prog["spans"]["gd.unet.mid_block"] > 0
    # no device operations on the CPU: no idle time to speak of, but a number
    assert prog["unet_host_s"] > 0 and prog["loop_idle_s"] is not None
    assert prog["syncs_per_step"] is None and prog["span_ops"] == 0
    assert prog["pipeline_unet_host_s"] >= prog["unet_host_s"]
    assert any(name.startswith("gd.") for name, _ in prog["idle_gaps"])
