"""A whole run of each cell on the CPU at a tiny size (the chip check
skipped): the port serves, the reference agrees, and `correct` comes out
true; then the same run with the timed path broken underneath, which
must come out false."""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.lib import spec
from portbench.tests.conftest import tiny_cell

CELLS = ("v3-batch-long", "turbo-batch-long", "turbo-online-short", "v3-langid",
         "v3-decode-b128")


def _run(name, config, seed=5, seconds=0.5):
    return run.run_cell(name, seed, seconds, False, torch.device("cpu"), spec.benchmark(),
                        cell=tiny_cell(name), config=config, t_start=0.0)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_cpu(name, tiny_config):
    result = _run(name, tiny_config)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    names = {m["name"] for m in spec.metrics_for(spec.benchmark(), "end_to_end", name)}
    assert set(result["metrics"]) == names
    assert all(v["value"] > 0 for v in result["metrics"].values())
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
