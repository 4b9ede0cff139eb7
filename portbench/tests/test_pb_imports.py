"""What a run and the reference may import, and what a run leaves out of
its result."""

import ast
import json
import os
import subprocess
import sys

from portbench.catalog import REPO_ROOT
from portbench.harness import forbidden_modules

HERE = os.path.dirname(os.path.abspath(__file__))


def test_forbidden_names_are_whole_top_level_names():
    assert forbidden_modules(["jax", "numpy"]) == ["jax"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client",
                              "flax.linen", "bfir_tpu.core.spec"]) == [
        "bfir_tpu", "flax", "jax", "jaxlib"]
    assert forbidden_modules(["bfir_tpu_torch", "bfir_tpu_torch.core",
                              "jaxtyping", "portbench.check"]) == []


def test_reference_imports_numpy_alone():
    path = os.path.join(REPO_ROOT, "portbench", "reference.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"numpy", "__future__"}
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; import portbench.reference, portbench.check; "
         "print(sorted({m.split('.')[0] for m in sys.modules} & "
         "{'bfir_tpu_torch', 'bfir_tpu', 'jax', 'torch'}))"],
        cwd=REPO_ROOT, capture_output=True, text=True, check=True)
    # check imports inputs, which makes the seeded data with torch
    assert out.stdout.strip() == "['torch']"


def test_a_run_loads_no_jax():
    script = f"""
import sys, time, json, pathlib
sys.path[:0] = [{REPO_ROOT!r}, {HERE!r}]
import conftest
from portbench import harness
from portbench.catalog import Catalog
root = conftest.tiny_root.__wrapped__(pathlib.Path(sys.argv[1]))
args = harness.parse(["--workload", "tiny.tiny_stream", "--seed", "11",
                      "--seconds", "0.2"])
r = harness.run_cell(args, Catalog([str(root)]), time.perf_counter(),
                     device="cpu")
print(json.dumps([r["correct"], harness.forbidden_modules(sys.modules),
                  "bfir_tpu_torch" in sys.modules]))
"""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([sys.executable, "-c", script, tmp],
                             capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, [],
                                                               True]


def test_no_result_without_the_program_or_a_card(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO_ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO_ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    args = ["--workload", "plugin8_f64.stream", "--seed", "1", "--seconds",
            "1", "--trace", "0"]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    # no card: refused before any work
    no_card = subprocess.run([sys.executable, "portbench/run.py", *args],
                             cwd=tmp_path, capture_output=True, text=True,
                             env=env)
    assert no_card.returncode != 0 and not no_card.stdout.strip()
    # the harness alone, past the card check: the program is missing
    script = ("import sys, time; sys.path[0] = '.'; "
              "from portbench import harness; from portbench.catalog "
              "import Catalog; harness.run_cell(harness.parse(sys.argv[1:]), "
              "Catalog(), time.perf_counter(), device='cpu')")
    alone = subprocess.run([sys.executable, "-c", script, *args],
                           cwd=tmp_path, capture_output=True, text=True,
                           env=env)
    assert alone.returncode != 0 and not alone.stdout.strip()
    assert "bfir_tpu_torch" in alone.stderr
