"""``TrackingPipeline.run_sequence_detections``: one unit is one whole
sequence of public detections, which the call tracks from a fresh
tracker (MOTChallenge's public-detection protocol, ``track.py
--detections``); the detector never runs. Sequences are played back to
back: unit k is the source's sequence k."""

from __future__ import annotations

from typing import Dict

import numpy as np

WARM_FRAMES = 150          # past the track buffer: tracks lost and removed


class Runner:
    def __init__(self, pipe, source, config):
        self.pipe, self.src = pipe, source
        self.n = source.frames
        self.cap = config["tracker"]["det_capacity"]
        self.k, self.results = 0, []

    def warm(self):
        seq = self.src.sequence(0)
        n = min(WARM_FRAMES, self.n)
        self.pipe.run_sequence_detections(
            {f: seq[f] for f in range(1, n + 1)}, n)

    def unit(self) -> int:
        self.results.append(self.pipe.run_sequence_detections(
            self.src.sequence(self.k), self.n))
        self.k += 1
        return self.n

    def fresh(self, step: int) -> bool:
        """Each sequence starts from a fresh tracker."""
        return step % self.n == 0

    def rows(self, step: int) -> Dict[int, np.ndarray]:
        _, ids, tlwhs, _ = self.results[step // self.n][step % self.n]
        return {int(i): np.asarray(t, np.float64) for i, t in zip(ids, tlwhs)}

    def detections(self, step: int, recorded):
        """The rows the tracker got at ``step``, cut to det_capacity as
        the program cuts them."""
        rows = self.src.sequence(step // self.n)[step % self.n + 1]
        if len(rows) > self.cap:
            rows = rows[np.argsort(-rows[:, 4])[:self.cap]]
        rows = rows.astype(np.float64)
        return {"tlbr": rows[:, :4], "score": rows[:, 4], "cls": rows[:, 5]}
