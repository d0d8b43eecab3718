"""A model family is added by new files alone: a copy of portbench/ and
BENCHMARK.json gains a toy family (two tanh layers in plain PyTorch, its
own float64 reference and judge), a configuration, a traffic kind and a
cell, and nothing that was there changes. `run.run_cell` on the CPU, in a
process that imports the copy, reads the toy cell `correct`; with the
toy program's second layer planted to return its input unchanged, not
correct."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.lib.spec import HERE, ROOT

FAMILY = '''"""A toy family: two tanh layers of width `width`."""

import math

import torch


def dims(config):
    return {"width": config["width"], "layers": 2}


def make_params(d, seed, device, dtype):
    w = d["width"]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(d["layers"] * w * w, generator=gen, dtype=dtype, device=device)
    return {"w": flat.view(d["layers"], w, w) / math.sqrt(w)}


class Toy:
    def __init__(self, config, w):
        self.cfg = config
        self.w = w

    def layer(self, x, i):
        return torch.tanh(x @ self.w[i])

    def forward(self, x):
        for i in range(self.w.shape[0]):
            x = self.layer(x, i)
        return x


def program(config, d, params):
    return Toy(config, params["w"])


def judge(ctx, out, dtype, control=False):
    import numpy as np

    from portbench.reference import toy as ref

    w = make_params(ctx.dims, ctx.seed, ctx.device, dtype)["w"].double().numpy()
    gap = max(float(np.abs(ref.forward(w, a["x"]) - a["y"]).max()) for a in out.answers)
    numbers = {"missing": out.failed, "row_gap": gap}
    checks = {k: {"value": numbers[k], "limit": v}
              for k, v in ctx.cell["check"]["limits"].items()}
    if control:
        low = w.astype(np.float16).astype(np.float64)
        checks["control_gap"] = {"value": max(
            float(np.abs(ref.forward(low, a["x"]) - ref.forward(w, a["x"])).max())
            for a in out.answers), "limit": None}
    return checks
'''

REFERENCE = '''"""The toy family's plain reference, in float64."""

import numpy as np


def forward(w, x):
    x = np.asarray(x, np.float64)
    for layer in w:
        x = np.tanh(x @ layer)
    return x
'''

TRAFFIC = '''"""Rows through the toy program in a closed loop."""

import time

import torch

from portbench.lib.cell import Outcome, rng


def setup(ctx):
    x = rng(ctx.seed, 1).standard_normal((ctx.params["rows"], ctx.dims["width"]))
    x = torch.from_numpy(x.astype("float32"))
    ctx.model.forward(x)
    return {"x": x}


def window(ctx, state):
    answers, t_open = [], time.perf_counter()
    while True:
        y = ctx.model.forward(state["x"])
        answers += [{"x": a.numpy(), "y": b.numpy()} for a, b in zip(state["x"], y)]
        t1 = time.perf_counter()
        if t1 - t_open >= ctx.seconds:
            break
    return Outcome(attempted=len(answers), failed=0,
                   e2e={"toy_rows_per_s": len(answers) / (t1 - t_open)},
                   answers=answers, kind="rows")
'''

CONFIG = {"name": "toy", "source": "https://example.org/toy", "family": "toy", "width": 32,
          "reduced": []}
CELL = {"name": "toy-rows", "config": "toy", "traffic": "toy_rows", "params": {"rows": 8},
        "options": {}, "check": {"limits": {"missing": 0, "row_gap": 1e-4}}}
ENTRIES = {
    "configs": {"name": "toy", "source": "https://example.org/toy",
                "file": "portbench/configs/toy.json", "reduced": [], "why": "a test family"},
    "workloads": {"name": "toy-rows", "config": "toy", "traffic": "toy_rows", "chips": 1,
                  "why": "rows through two tanh layers"},
    "end_to_end": {"name": "toy_rows_per_s", "unit": "rows/s", "better": "higher",
                   "bound": 0.05, "source": "host_clock", "workloads": ["toy-rows"]},
}
ADDED = {
    "families/toy.py": FAMILY,
    "reference/toy.py": REFERENCE,
    "traffic/toy_rows.py": TRAFFIC,
    "configs/toy.json": json.dumps(CONFIG),
    "workloads/toy-rows.json": json.dumps(CELL),
}

RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import portbench
from portbench import run
from portbench.lib import spec
assert portbench.__file__.startswith(sys.argv[1]), portbench.__file__
if sys.argv[2] == "fault":
    from portbench.families import toy
    toy.Toy.layer = lambda self, x, i: x if i == 1 else torch.tanh(x @ self.w[i])
r = run.run_cell("toy-rows", 2**32 + 3, 0.2, False, torch.device("cpu"), spec.benchmark(),
                 t_start=0.0)
print(json.dumps({k: r[k] for k in ("correct", "checks", "metrics")}))
"""


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for section, entry in ENTRIES.items():
        bench[section].append(entry)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    for rel, text in ADDED.items():
        (root / "portbench" / rel).write_text(text)
    return root


def _run(root, mode):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", RUN, str(root), mode], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_copy_differs_by_added_files_only(copy):
    before, after = _files(HERE), _files(copy / "portbench")
    assert {k: after.get(k) for k in before} == before
    assert set(after) - set(before) == set(ADDED)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    got = json.loads((copy / "BENCHMARK.json").read_text())
    for key, value in bench.items():
        if isinstance(value, list) and key in ENTRIES:
            assert got[key] == value + [ENTRIES[key]]
        else:
            assert got[key] == value


def test_the_toy_family_runs_correct(copy):
    result = _run(copy, "sound")
    assert result["correct"], result["checks"]
    assert result["checks"]["row_gap"]["value"] < 1e-5
    assert set(result["metrics"]) == {"toy_rows_per_s", "setup_s"}


def test_a_planted_fault_in_the_toy_program_is_not_correct(copy):
    result = _run(copy, "fault")
    assert not result["correct"]
    assert result["checks"]["row_gap"]["value"] > 1e-2
