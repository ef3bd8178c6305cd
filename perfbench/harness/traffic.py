"""The one generator of every traffic mix. A mix is a data file
(``traffic/<mix>.json``): its ``kind`` names the source that makes its
inputs (``sources/<kind>.py``), its ``entry`` the runner that drives the
program with them (``runners/<entry>.py``), and its other keys are the
source's parameters. The same seed gives the same inputs, and every
seed gives the same sizes."""

from __future__ import annotations

from perfbench.named import by_name


def make(seed: int, mix: dict):
    """The source of a mix."""
    return by_name("sources", mix["kind"]).make(seed, mix)
