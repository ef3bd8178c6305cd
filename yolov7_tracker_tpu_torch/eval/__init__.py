"""MOT evaluation subsystem: HOTA / CLEAR / Identity metrics, MOT-challenge
and VisDrone dataset readers, sequence-parallel evaluator.

Functionally equivalent to the reference's vendored TrackEval
(tracker/trackeval/) for the benchmarks this framework targets, plus the
py-motmetrics-style fallback (tracker/evaluate.py).

This is the PyTorch port's own copy of yolov7_tracker_tpu/eval, kept
line for line (the JAX package's known defects included) so that both
packages score a run alike; the port imports nothing of the JAX package.
It is numpy and scipy on the host, as TrackEval is.
"""

from .metrics import hota, clear, identity, combine_sequences  # noqa: F401
from .evaluator import evaluate_benchmark  # noqa: F401
