"""No module under portbench/ imports JAX, jaxlib or the JAX package, and
the reference imports nothing of the program either. Names are compared
by their top-level part (before the first dot) whole: the port's name
begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench.lib.spec import HERE, ROOT

JAX = {"jax", "jaxlib", "flax", "openai_whisper_coreml_tpu"}
PROGRAM = "openai_whisper_coreml_tpu_torch"
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax(path):
    found = top_level_imports(path) & JAX
    assert not found, f"{path} imports {found}"
    if "reference" in path.relative_to(HERE).parts:
        # plain PyTorch and NumPy, nothing of the program or of the harness
        assert top_level_imports(path) <= {"__future__", "math", "typing", "numpy", "torch"}


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.model, "
            "portbench.reference.tokens; bad = sorted({m.split('.')[0] for m in sys.modules} "
            "& set(%r)); print(bad)" % (str(ROOT), sorted(JAX | {PROGRAM})))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_process_loads_no_jax():
    """The harness's modules and the port's entry points, loaded in a fresh
    process, leave no JAX name in sys.modules (run.py checks the same
    before it prints its result)."""
    code = ("import sys; sys.path.insert(0, %r); from portbench import run, calibrate, sweep; "
            "import portbench.traffic.batch_queue, portbench.traffic.langid_batches, "
            "portbench.traffic.http_open_loop, portbench.traffic.decode_batches, "
            "portbench.families.whisper, portbench.lib.judge; "
            "import openai_whisper_coreml_tpu_torch.serve_http, "
            "openai_whisper_coreml_tpu_torch.models.whisper; print(run.forbidden_modules())"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"
