"""What a cell runs loads neither JAX nor the JAX package, and the
reference imports nothing of the program (top-level names compared
whole: the port's name begins with the JAX package's)."""

import ast
import glob
import os
import shutil
import subprocess
import sys

from perfbench_tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "yolov7_tracker_tpu"}

RUN_A_CELL = f"""
import sys, time
sys.path.insert(0, {ROOT!r})
sys.path.insert(0, {os.path.join(ROOT, 'perfbench', 'tests')!r})
import perfbench.run
from perfbench_tiny import run
for w in ("w6-bytetrack.video", "w6-deepsort.video"):
    run(w, seconds=0.5, traced=True)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_cell_loads_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", RUN_A_CELL], env=env,
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "yolov7_tracker_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "perfbench", "reference",
                                       "**", "*.py"), recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            tops = {n.split(".")[0] for n in names}
            assert not tops & (FORBIDDEN | {"yolov7_tracker_tpu_torch"}), \
                (path, names)
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "from perfbench.named import by_name; "
            "from perfbench.reference import detector, reid; "
            "[by_name('reference/trackers', n) "
            "for n in ('bytetrack', 'deepsort')]; "
            "detector.architecture('yolov7-w6'); "
            "reid.network('deepsort_cnn'); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"yolov7_tracker_tpu_torch"})


def test_no_card_or_no_program_means_no_result(tmp_path):
    """Here there is no CUDA card; a checkout holding only BENCHMARK.json
    and perfbench/ has no program either. Both exit non-zero and print
    no result line."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(tmp_path, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for root in (ROOT, str(tmp_path)):
        out = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload",
             "w6-bytetrack.video", "--seed", "3000000001", "--seconds", "1",
             "--trace", "0"], capture_output=True, text=True, timeout=300,
            cwd=root)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout
