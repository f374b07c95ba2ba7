"""No run loads JAX or the JAX package, and the references import nothing
of the port."""
from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys
import types

from portbench import common

PORT = "fissure_segmentation_tpu_torch"


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_references_import_nothing_of_the_port():
    files = glob.glob(os.path.join(common.HERE, "reference", "*.py"))
    files += glob.glob(os.path.join(common.HERE, "gen", "*.py"))
    files += [os.path.join(common.HERE, "peaks.py")]
    for path in files:
        found = _imports(path) & {PORT, *common.FORBIDDEN}
        assert not found, f"{path} imports {found}"


def test_no_source_of_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(common.HERE, "**", "*.py"),
                          recursive=True):
        assert not _imports(path) & set(common.FORBIDDEN), path


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + ".probe",
                        types.ModuleType(PORT + ".probe"))
    assert common.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "fissure_segmentation_tpu.probe",
                        types.ModuleType("fissure_segmentation_tpu.probe"))
    assert common.forbidden_loaded() == ["fissure_segmentation_tpu"]


def test_a_run_loads_no_jax():
    """A small run of each kind of loop, in a fresh interpreter, leaves no
    module named jax, jaxlib, flax or fissure_segmentation_tpu loaded."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench.tests.conftest import small_cell\n"
        "from portbench.run import execute\n"
        "from portbench import common\n"
        "for name in ('dgcnn_k40.train', 'mobilenet_aspp.serve_stream'):\n"
        "    execute(small_cell(name), 3, 0.5, False, 'cpu')\n"
        "print(common.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    """Without CUDA the command exits non-zero and prints no result."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from portbench.run import main\n"
            "sys.exit(main(['--workload', 'dgcnn_k40.train', '--seed', '1',"
            " '--seconds', '1']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
