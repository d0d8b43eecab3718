"""Model families: what the harness needs of a configuration's model, found
by the configuration's `family` key (`configs/<config>.json`) as the
module `families/<family>.py`.

A family module has four functions:

    dims(config) -> dict
        the configuration file's sizes as the plain dictionary that the
        family's weights, reference, operation counts and per-layer
        readers share (`Ctx.dims`)
    make_params(d, seed, device, dtype) -> tree
        the seeded weights of sizes `d`, made on `device` in `dtype`; the
        same seed on the same device gives the same tensors, so the judge
        can make them again after the program has been freed
    program(config, d, params) -> model
        the system under test built from those weights as it is served;
        the model exposes its configuration object as `.cfg` (`Ctx.cfg`)
    judge(ctx, outcome, dtype, control) -> checks
        the numbers compared, {name: {"value", "limit"}}, one for each
        limit in the cell's `check.limits`, worked out by the family's
        plain reference from the weights made again in `dtype`; with
        `control`, also "control_gap" (limit None): the same gap read
        with the reference in the precision below the configuration's

A new family is new files: this module, its reference under
`reference/`, its traffic kinds under `traffic/`, its per-layer readers
under `metrics/` (its operation counts in a file of their own beside
`metrics/counts.py`), its configuration and its cells."""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Any, Dict

INTERFACE = ("dims", "make_params", "program", "judge")


def load(name: str) -> ModuleType:
    """`families/<name>.py`, checked for the four functions."""
    mod = importlib.import_module(f"portbench.families.{name}")
    missing = [f for f in INTERFACE if not callable(getattr(mod, f, None))]
    if missing:
        raise TypeError(f"family {name!r} lacks {missing}")
    return mod


def of(config: Dict[str, Any]) -> ModuleType:
    """The family that a configuration file names."""
    return load(config["family"])
