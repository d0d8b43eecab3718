"""The spanned slice's reduction from synthetic kineto events: device time
and idle gaps attributed to the program's spans through the runtime
call's correlation id, self and inclusive time, unspanned activity, and
the readings `portbench/spans.py` prints."""

from __future__ import annotations

import pytest

from portbench.lib import spans as sp
from portbench.lib import trace

FILL = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<double>>()"


class Ev:
    def __init__(self, kind, name, start, dur, corr=0, thread=7):
        self.kind, self.n, self.s, self.d = kind, name, start, dur
        self.corr, self.thread = corr, thread

    def activity_type(self):
        return self.kind

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def metadata_json(self):
        return ""

    def correlation_id(self):
        return self.corr

    def device_resource_id(self):
        return self.thread

    def is_user_annotation(self):
        return self.kind in ("user_annotation", "gpu_user_annotation")

    def device_type(self):
        on_card = self.kind in trace.DEVICE_KINDS + ("gpu_user_annotation",)
        return "DeviceType.CUDA" if on_card else "DeviceType.CPU"


def _spanned_events():
    """A spanned slice of one language-ID call (ns): the harness's upload,
    `lang_step` holding `cross_kv` (with a linear's epilogue in it) and
    `decode_step`, then `lang_results`'s download; the card runs each
    kernel after its span has closed on the host. Another thread holds a
    `mel` span over the first launch, and kineto's device-side copy of
    `lang_step` lies over the kernels."""
    return [
        Ev("kernel", "marker", 0, 5),
        Ev("kernel", FILL, 100, 10),  # the slice opens at 110
        Ev("cuda_runtime", "cudaMemcpyAsync", 115, 3, corr=1),
        Ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 120, 20, corr=1),
        Ev("user_annotation", "lang_step", 150, 250),
        Ev("user_annotation", "cross_kv", 160, 40),
        Ev("user_annotation", "mel", 160, 20, thread=8),
        Ev("cuda_runtime", "cudaLaunchKernel", 170, 5, corr=2),
        Ev("user_annotation", "linear.epilogue", 180, 15),
        Ev("cuda_runtime", "cudaLaunchKernel", 185, 3, corr=3),
        Ev("user_annotation", "decode_step", 210, 50),
        Ev("cuda_runtime", "cudaLaunchKernel", 220, 2, corr=4),
        Ev("cuda_runtime", "cudaLaunchKernel", 270, 2, corr=5),
        Ev("gpu_user_annotation", "lang_step", 300, 110),
        Ev("kernel", "void gemm(x)", 300, 50, corr=2),
        Ev("kernel", "void mul(x)", 350, 20, corr=3),
        Ev("kernel", "void sqa(x)", 380, 20, corr=4),
        Ev("kernel", "void softmax(x)", 400, 10, corr=5),
        Ev("user_annotation", "lang_results", 410, 290),
        Ev("cuda_runtime", "cudaMemcpyAsync", 415, 3, corr=6),
        Ev("cuda_runtime", "cudaStreamSynchronize", 420, 180, corr=7),
        Ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 600, 10, corr=6),
        Ev("kernel", FILL, 800, 10),  # the slice closes at 800
    ]


def test_kernel_goes_to_the_span_open_at_its_launch():
    """Through its runtime call's correlation id: the GEMM ran on the card
    at 300-350, after `cross_kv` closed on the host at 200 and inside
    `lang_step`'s host range, yet `cross_kv` launched it. The other
    thread's `mel` span, open at the launch, does not take it."""
    ss = sp.reduce_spans(_spanned_events(), host_s=0.0)
    chains = {name: chain for (_, _, name), chain in zip(ss.slice.device, ss.chains)}
    assert chains == {
        "Memcpy HtoD (Pageable -> Device)": (),
        "void gemm(x)": ("lang_step", "cross_kv"),
        "void mul(x)": ("lang_step", "cross_kv", "linear.epilogue"),
        "void sqa(x)": ("lang_step", "decode_step"),
        "void softmax(x)": ("lang_step",),
        "Memcpy DtoH (Device -> Pageable)": ("lang_results",),
    }
    # kineto's device-side copy of a span is no device work
    assert ss.slice.busy_s == pytest.approx(130e-9)
    assert ss.slice.window_ns == (110, 800)


def test_slice_is_the_plain_reduction_of_the_same_events():
    """Without the spans, the spanned slice's record is what a traced slice
    reads from the same events."""
    events = _spanned_events()
    ss = sp.reduce_spans(events, host_s=1.5)
    plain = trace.reduce([e for e in events if not e.is_user_annotation()], host_s=1.5)
    assert ss.slice == plain
    assert trace.device_ops(ss.slice) == trace.device_ops(plain)


def test_self_and_inclusive_device_time():
    ss = sp.reduce_spans(_spanned_events(), host_s=0.0)
    self_s, incl = sp.span_seconds(ss)
    ns = {k: round(v * 1e9) for k, v in self_s.items()}
    assert ns == {"unspanned": 20, "cross_kv": 50, "linear.epilogue": 20,
                  "decode_step": 20, "lang_step": 10, "lang_results": 10}
    ns = {k: round(v * 1e9) for k, v in incl.items()}
    assert ns == {"unspanned": 20, "lang_step": 100, "cross_kv": 70,
                  "linear.epilogue": 20, "decode_step": 20, "lang_results": 10}
    tops = sp.top_level_seconds(ss)
    assert {k: round(v * 1e9) for k, v in tops.items()} == {
        "lang_step": 100, "lang_results": 10, "unspanned": 20}
    assert sum(tops.values()) == pytest.approx(ss.slice.busy_s)
    assert [k for k, _ in sp.device_spans(ss)][:1] == ["cross_kv"]
    ops = sp.span_ops(ss)
    assert ops["cross_kv"] == [["void gemm", pytest.approx(50e-9)]]
    assert set(ops) == set(self_s)


def test_unspanned_activity():
    """The harness's upload ran under no span; its share is of the busy
    time."""
    ss = sp.reduce_spans(_spanned_events(), host_s=0.0)
    assert dict(map(tuple, sp.device_spans(ss)))["unspanned"] == pytest.approx(20e-9)
    assert sp.unspanned_pct(ss) == pytest.approx(100 * 20 / 130)
    # a launch whose runtime call the trace lost is unspanned too
    events = [e for e in _spanned_events() if e.corr != 5 or e.kind != "cuda_runtime"]
    self_s, _ = sp.span_seconds(sp.reduce_spans(events, host_s=0.0))
    assert self_s["unspanned"] == pytest.approx(30e-9) and "lang_step" not in self_s


def test_gap_labels_name_the_span_then_the_call_then_the_op():
    ss = sp.reduce_spans(_spanned_events(), host_s=0.0)
    gaps = {k: round(v * 1e9) for k, v in sp.idle_gaps_by_span(ss)}
    assert gaps == {
        "harness: python before Memcpy HtoD": 10,
        # lang_step is open on the host for 150 of the 160 ns; decode_step,
        # inside it, for 50
        "lang_step: python before void gemm": 160,
        "lang_step: python before void sqa": 10,
        "lang_results: cudaStreamSynchronize before Memcpy DtoH": 190,
        "harness: python before slice end": 190,
    }
    # the same gaps, as the plain breakdown names them
    plain = {k: round(v * 1e9) for k, v in trace.idle_gaps(ss.slice)}
    assert sum(gaps.values()) == sum(plain.values())
    assert {k.split(": ", 1)[1] for k in gaps} == set(plain)


def test_readings_need_a_spanned_slice():
    """Without a spanned slice (a program without spans) nothing is read;
    a span that never opened reads nothing; the others read their time a
    window."""
    assert sp.readings(None, 4) == {}
    ss = sp.reduce_spans(_spanned_events(), host_s=0.0)
    got = sp.readings(ss, 2)
    assert got == {
        "langid.cross_kv_ms_per_window": pytest.approx(1e3 * 70e-9 / 2),
        "langid.linear_epilogue_ms_per_window": pytest.approx(1e3 * 20e-9 / 2),
        "langid.mel_ms_per_window": 0.0,  # opened, launched nothing on this thread
        "langid.unspanned_share": pytest.approx(100 * 20 / 130),
    }
    ss.spans += [(150, 160, n, 7) for n in ("encoder", "linear.weight_cast", "layer_norm")]
    assert set(sp.readings(ss, 2)) == set(sp.SPAN_METRICS) | {"langid.unspanned_share"}
    assert sp.readings(ss, 0) == {"langid.unspanned_share": pytest.approx(100 * 20 / 130)}
