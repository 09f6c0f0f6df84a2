"""Nothing that ``portbench/run.py`` loads is JAX or the JAX package, the
top-level module names compared whole (``blt_vqg_tpu_torch`` begins with
``blt_vqg_tpu``), and the reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from portbench.harness import runner
from conftest import ROOT

BLOCKED = ("jax", "jaxlib", "flax", "blt_vqg_tpu")


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "blt_vqg_tpu_torch.fake", object())
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "blt_vqg_tpu", raising=False)
    assert "blt_vqg_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "blt_vqg_tpu.core", object())
    assert runner.forbidden_modules() == ["blt_vqg_tpu"]


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(ROOT, "portbench", "**", "*.py"),
                          recursive=True):
        assert not _imports(path) & set(BLOCKED), path


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "portbench", "reference",
                                       "*.py")):
        assert not _imports(path) & {*BLOCKED, "blt_vqg_tpu_torch"}, path


def test_a_run_loads_no_jax():
    """In a fresh process: everything a run of each entry loads (the
    harness, the entries, the readers and the program modules they call),
    with JAX importable; then the run's own check of ``sys.modules``."""
    code = """
import sys
sys.path.insert(0, sys.argv[1])
from portbench.harness import cells, runner, trace, faults
from portbench.reference import iq, train
for name in ("iq_big.serve_stream_b256", "iq_big.train_b512"):
    cell = cells.find_cell(name)
    cells.entry(cell.traffic)
    for m in cell.per_layer:
        cells.reader(m["name"])
import blt_vqg_tpu_torch.train.step, blt_vqg_tpu_torch.train.state
import blt_vqg_tpu_torch.models.iq, blt_vqg_tpu_torch.ops.layers
import blt_vqg_tpu_torch.ops.kernels._build
print(runner.forbidden_modules())
tops = {m.split('.')[0] for m in sys.modules}
print(sorted(tops & {"jax", "jaxlib", "flax", "blt_vqg_tpu"}))
"""
    out = subprocess.run([sys.executable, "-c", code, ROOT],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "[]"]
