"""What a run is asked to do: `BENCHMARK.json` at the root of the checkout,
the cell's file `workloads/<cell>.json` and its configuration's file
`configs/<config>.json`, found by the names that `BENCHMARK.json` gives.

A configuration file holds the published sizes under the names of the
model card's `config.json` and names its `family`; the family's `dims`
(`families/<family>.py`) turns them into the plain dictionary of sizes
that the harness, the reference and the operation counts share."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent  # the checkout


def load_json(path: Path) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def config_file(name: str) -> Dict[str, Any]:
    return load_json(HERE / "configs" / f"{name}.json")


def cell_file(name: str) -> Dict[str, Any]:
    return load_json(HERE / "workloads" / f"{name}.json")


def metrics_for(bench: Dict[str, Any], section: str, cell: str) -> List[Dict[str, Any]]:
    """The metrics of `section` ("end_to_end" or "per_layer") that `cell`
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


def workload_entry(bench: Dict[str, Any], cell: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
