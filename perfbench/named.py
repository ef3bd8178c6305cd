"""Find a file of the benchmark by the name a configuration, a mix or
``BENCHMARK.json`` gives it: ``<perfbench>/<kind>/<name>.py``, loaded
once. What belongs to one configuration, mix, tracker, architecture or
metric sits in a file of its own, so adding one adds a file and edits
none."""

from __future__ import annotations

import importlib.util
import os
import re
import sys
from types import ModuleType

PERFBENCH = os.path.dirname(os.path.abspath(__file__))


def by_name(kind: str, name: str, root: str = PERFBENCH) -> ModuleType:
    """The module ``<root>/<kind>/<name>.py`` (``kind`` may hold a
    ``/``); KeyError where there is none."""
    path = os.path.join(root, kind, name + ".py")
    key = "perfbench_named." + re.sub(r"[^0-9A-Za-z_]", "_",
                                      f"{root}/{kind}/{name}")
    if key in sys.modules:
        return sys.modules[key]
    if not os.path.isfile(path):
        have = sorted(f[:-3] for f in os.listdir(os.path.join(root, kind))
                      if f.endswith(".py") and not f.startswith("_"))
        raise KeyError(f"no {kind} {name!r} in {root}; have {have}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
