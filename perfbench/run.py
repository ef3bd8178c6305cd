"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control]

With ``--trace 0`` the last line of standard output holds the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from
spans and torch.profiler over the same window. Either way the run's
outputs are checked against the plain reference (perfbench/reference/)
after the window, and each compared number is printed beside its limit
as the last lines of standard error. ``--control`` also reads the
control (the reference one precision lower in the program's place);
the benchmark's own runs do not use it.

Exits 2 without a result when there is no CUDA card or fewer cards than
the cell asks for, and 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "yolov7_tracker_tpu"}


def process_start() -> float:
    """When this process started, on the wall clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path in the checkout."""
    base = os.path.join(root, ".perfbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    t_process = process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    sys.path.insert(0, ROOT)
    from perfbench.harness import manifest

    cell = manifest.load(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from perfbench.harness import cell_run

    result = cell_run.run(ROOT, cell, args.seed, args.seconds,
                          bool(args.trace), "cuda", t_process,
                          control=args.control)
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
