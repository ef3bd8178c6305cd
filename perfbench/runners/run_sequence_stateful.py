"""``TrackingPipeline.run_sequence_stateful``: one unit is one detector
batch of the video, the tracker state carried from call to call (the
offline ``track.py`` use).

A runner runs its entry of the program one unit at a time (``unit()``
returns the frames it completed, with their rows on the host), and
afterwards tells the check which frames, detections and rows belong to
each unit and tracker step."""

from __future__ import annotations

from typing import Dict

import numpy as np


class Runner:
    def __init__(self, pipe, source, config):
        self.pipe, self.src = pipe, source
        self.batch = config["pipeline"]["detector_batch"]
        self.k, self.slab, self.results = 0, None, []

    def frames(self, unit: int) -> np.ndarray:
        """The frames of ``unit``, (B, H, W, 3)."""
        b = self.batch
        return np.stack([self.src.frame(i)
                         for i in range(unit * b, unit * b + b)])

    def warm(self):
        self.pipe.run_sequence_stateful(self.src.frame(i)
                                        for i in range(self.batch))

    def unit(self) -> int:
        frames = (self.src.frame(i) for i in range(self.k,
                                                   self.k + self.batch))
        res, self.slab = self.pipe.run_sequence_stateful(
            frames, initial_slab=self.slab)
        self.results.extend(res)
        self.k += self.batch
        return self.batch

    def fresh(self, step: int) -> bool:
        """Whether ``step`` starts from a fresh tracker."""
        return step == 0

    def rows(self, step: int) -> Dict[int, np.ndarray]:
        _, ids, tlwhs, _ = self.results[step]
        return {int(i): np.asarray(t, np.float64) for i, t in zip(ids, tlwhs)}

    def detections(self, step: int, recorded):
        """The detector's output that the tracker got at ``step``."""
        boxes, score, cls, count = recorded[step // self.batch]
        i = step % self.batch
        n = int(count[i])
        return {"tlbr": boxes[i, :n].double().cpu().numpy(),
                "score": score[i, :n].double().cpu().numpy(),
                "cls": cls[i, :n].double().cpu().numpy()}
