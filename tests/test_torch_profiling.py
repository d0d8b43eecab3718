"""The port's profiling utilities (`utils/profiling.py`) against the JAX
package's: StageTimer's report for the same stages under one patched
clock, device_trace as a no-op without a directory, and on the CPU a
torch.profiler trace file that names the ops and annotated regions run
inside it."""

import glob
import itertools
import json
import os
import time

import pytest
import torch

from openai_whisper_coreml_tpu.utils import profiling as jprof
from openai_whisper_coreml_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


def _run_stages(timer):
    with timer.stage("mel", work_units=30.0):
        pass
    with timer.stage("encode", work_units=60.0):
        pass
    with timer.stage("mel", work_units=30.0):
        pass
    with timer.stage("decode"):
        pass
    with pytest.raises(RuntimeError):
        with timer.stage("decode"):
            raise RuntimeError("a stage that fails is still timed")
    return timer.report(), timer.dump()


@pytest.mark.parametrize("step", [0.0125, 0.3, 1.7])
def test_stage_timer_report_equals_jax(monkeypatch, step):
    """Each stage's seconds, calls, mean ms and units per second, and the
    JSON dump, equal JAX's for the same stage sequence on one clock that
    advances `step` s a reading."""
    def clock():
        ticks = itertools.count()
        return lambda: next(ticks) * step

    monkeypatch.setattr(time, "perf_counter", clock())
    ours = _run_stages(tprof.StageTimer())
    monkeypatch.setattr(time, "perf_counter", clock())
    ref = _run_stages(jprof.StageTimer())
    assert ours == ref
    report = ours[0]
    assert report["mel"]["calls"] == 2 and report["decode"]["calls"] == 2
    assert "units_per_sec" not in report["decode"]
    assert json.loads(ours[1]) == report


def test_device_trace_without_dir_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for logdir in ("", None):
        with tprof.device_trace(logdir):
            torch.ones(4).sum()
    assert os.listdir(tmp_path) == []
    assert not torch.autograd.profiler._is_profiler_enabled


def test_device_trace_writes_a_trace_on_cpu(tmp_path):
    """A Chrome-trace JSON file lands in the directory, holding the ops run
    inside the context and the annotated region."""
    logdir = str(tmp_path / "trace")
    with tprof.device_trace(logdir):
        with tprof.annotate("my_region"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "my_region" in names and "aten::mm" in names
