"""What decides ``correct``: the outputs of the timed window against the
plain reference (perfbench/reference/), after the window has closed.

Four stages, each on a sample drawn from the seed:

- the detector (letterbox and the network): at unit 0 of the window and
  each unit with probability ``det_rate``, the raw head levels that the
  program computed against the reference's on the same frames with the
  same seeded weights (``raw_rel_err``: the worst level's
  ||program - reference|| / ||reference||);
- ReID (where the configuration has it): at those units, the
  embeddings the program computed for every detection slot against the
  reference's crops and network on the same boxes (``emb_rel_err``:
  ||program - reference|| / ||reference||);
- NMS: the detections the program handed its tracker at those units
  against the reference's decode and NMS of the program's own raw
  levels (``det_unmatched``: the share of detections a tracker can use,
  score above its low threshold, on either side that have no detection
  of the same class with every corner within ``det_tol_px`` on the
  other);
- the tracker: at every sampled step (step 0 and each step with
  probability ``step_rate``), the reference step from the program's own
  state before the step, fed the detections the tracker was due (as the
  runner gives them, with the embeddings the program gave the step),
  against the rows the window emitted for that frame (``rows_differ``:
  ids on one side only, or with boxes more than ``box_tol_px`` apart, as
  a share of all ids) and the program's state after the step (``state_differ``: tracks whose id, state, activation
  or box differ so, as a share of all tracks; tracks of the state
  entering the step that differ at all from the state the step before
  returned count there too).

The reference follows the program's state step by step, and at each
association stage it takes the program's pairing (read from the state
the step returned) where that costs at most ``tie_slack`` more than its
own exact optimum (track_common.Judge): the program's solver is an
auction, which may break a near tie otherwise than the exact solver, and
from then on every new id would differ, so neither a whole-sequence
comparison nor a step that insists on the exact pairing could tell a
sound run from a broken one. A pairing that costs more is refused and
counts against the rows and the state. The log gives the ties taken and
refused and how far over the optimum each came. The start (step 0, from
the empty table), every sampled transition and the carry of the state
from one step to the next are checked by themselves.

The control (``control=True``) puts the reference computed one precision
lower in the program's place: the network in float8 (the configuration
states bf16), the decode before NMS and the tracker in bfloat16 (they
are float32).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.harness.seeds import sub_seed
from perfbench.harness.weights import detector_weights
from perfbench.named import by_name
from perfbench.reference.detector import Detector
from perfbench.reference.reid import Embedder
from perfbench.reference.track_common import Judge, judged_pairs, xyah_to_tlwh


def tracker_reference(config: dict):
    """The plain reference of the configuration's tracker
    (``reference/trackers/<tracker.tracker>.py``)."""
    return by_name("reference/trackers", config["tracker"]["tracker"])


class Recorder:
    """Keeps what the timed path produced, by reference, with no copy and
    no sync: every detector output (a few KB a frame), the raw head
    levels and embeddings of the sampled units and the tracker's state
    and detections around the sampled steps."""

    def __init__(self, pipe, seed: int, det_rate: float, step_rate: float):
        self.dets: List[tuple] = []
        self.raw: Dict[int, list] = {}
        self.emb: Dict[int, list] = {}
        self.steps: Dict[int, tuple] = {}
        self.n_steps = 0
        self._last = None
        rng = np.random.default_rng(sub_seed(seed, 6))
        u_det, u_step = rng.random(1 << 12), rng.random(1 << 20)
        model, detect, step = pipe.model, pipe.detect_batch, pipe.step
        embed = pipe.embed_dets

        def recording_model(x):
            out = model(x)
            i = len(self.dets)
            if i == 0 or u_det[i % len(u_det)] < det_rate:
                self.raw[i] = out
            return out

        def recording_detect(frames):
            out = detect(frames)
            self.dets.append(out)
            return out

        def recording_embed(frames, tlbr):
            out = embed(frames, tlbr)
            if len(self.dets) - 1 in self.raw:
                self.emb.setdefault(len(self.dets) - 1, []).append(out)
            return out

        def recording_step(slab, det, **kw):
            i = self.n_steps
            self.n_steps += 1
            new, out = step(slab, det, **kw)
            if i == 0 or u_step[i % len(u_step)] < step_rate:
                self.steps[i] = (self._last, slab, det, new)
            self._last = new
            return new, out

        pipe.model = recording_model
        pipe.embed_dets = recording_embed
        pipe.detect_batch = recording_detect
        pipe.step = recording_step

    def detections(self, cap: int) -> int:
        """Valid detections handed to the tracker over every recorded
        unit (at most ``cap`` a frame): the crops a ReID network had to
        embed."""
        if not self.dets:
            return 0
        counts = torch.cat([d[3].reshape(-1) for d in self.dets])
        return int(counts.clamp(max=cap).sum())


def _state(slab) -> dict:
    """The program's track table as the reference's arrays."""
    out = {}
    for f in ("mean", "cov", "det_tlwh", "score", "cls", "state",
              "occupied", "is_activated", "track_id", "frame_id",
              "start_frame", "tracklet_len", "time_since_update",
              "feat_hist", "feat_count", "ins_seq", "lost_seq", "next_id",
              "frame"):
        x = getattr(slab, f).detach().cpu()
        x = x.double() if x.is_floating_point() else x
        out[f] = x.numpy().copy()
    for f in ("next_id", "frame"):
        out[f] = int(out[f])
    return out


def _cut(dets: dict, d: int) -> dict:
    if len(dets["score"]) <= d:
        return dets
    keep = np.argsort(-np.asarray(dets["score"]), kind="stable")[:d]
    return {k: np.asarray(v)[keep] for k, v in dets.items()}


def _rows_cmp(a: dict, b: dict, tol: float) -> Tuple[int, int]:
    """(ids on one side only or with boxes apart, ids in all)."""
    common = a.keys() & b.keys()
    apart = sum(float(np.abs(a[i] - b[i]).max()) > tol for i in common)
    return len(a.keys() ^ b.keys()) + apart, len(a.keys() | b.keys())


def _tracks(st: dict) -> dict:
    occ = np.flatnonzero(st["occupied"])
    tlwh = xyah_to_tlwh(st["mean"][occ, :4])
    return {int(st["track_id"][i]): (int(st["state"][i]),
                                     bool(st["is_activated"][i]), tlwh[j])
            for j, i in enumerate(occ)}


def _state_cmp(a: dict, b: dict, tol: float) -> Tuple[int, int]:
    ta, tb = _tracks(a), _tracks(b)
    common = ta.keys() & tb.keys()
    differ = len(ta.keys() ^ tb.keys()) + sum(
        ta[i][:2] != tb[i][:2] or float(np.abs(ta[i][2] - tb[i][2]).max())
        > tol for i in common)
    return differ, len(ta.keys() | tb.keys())


def _unmatched(a: np.ndarray, b: np.ndarray, min_score: float,
               tol: float):
    """(rows of ``a`` above ``min_score`` with no row of ``b`` of the same
    class whose every corner lies within ``tol`` pixels, rows of ``a``
    above ``min_score``)."""
    a = a[a[:, 4] > min_score]
    if len(a) == 0:
        return 0, 0
    if len(b) == 0:
        return len(a), len(a)
    near = (np.abs(a[:, None, :4] - b[None, :, :4]) <= tol).all(-1)
    same = a[:, None, 5] == b[None, :, 5]
    return int((~(near & same).any(1)).sum()), len(a)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _port_dets(recorded, unit: int) -> List[np.ndarray]:
    boxes, score, cls, count = recorded[unit]
    out = []
    for i in range(boxes.shape[0]):
        n = int(count[i])
        out.append(torch.cat([boxes[i, :n].float(), score[i, :n, None].float(),
                              cls[i, :n, None].float()], 1).cpu().numpy())
    return out


def run(cell, seed: int, runner, recorder: Recorder, device,
        control: bool = False, reid_sd=None
        ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """The readings of the program (and of the control, when asked)."""
    cfg = cell.config
    chk, tcfg = cfg["check"], cfg["tracker"]
    low = max(0.15, tcfg["conf_thresh"] - 0.3)
    got: Dict[str, float] = {}
    ctl: Dict[str, float] = {}

    if recorder.raw:
        sd = detector_weights(cfg, seed, device)
        ref = Detector(sd, cfg, device)
        cref = Detector(sd, cfg, device, fp8=True) if control else None
        del sd
        err = {"got": {}, "ctl": {}}
        n = {"got": [0, 0], "ctl": [0, 0]}

        def levels(key, a, b):
            for i, (x, y) in enumerate(zip(a, b)):
                e = err[key].setdefault(i, [0.0, 0.0])
                e[0] += float(((x.float() - y) ** 2).sum())
                e[1] += float((y ** 2).sum())

        def dets(key, a, b):
            for x, y in zip(a, b):
                for u, v in ((x, y), (y, x)):
                    m, t = _unmatched(u, v, low, chk["det_tol_px"])
                    n[key][0] += m
                    n[key][1] += t

        for u in sorted(recorder.raw):
            frames = torch.from_numpy(np.ascontiguousarray(
                runner.frames(u))).to(device)
            hw = tuple(frames.shape[1:3])
            want = ref.raw(frames)
            levels("got", recorder.raw[u], want)
            dets("got", _port_dets(recorder.dets, u),
                 ref.nms(recorder.raw[u], hw))
            if cref is not None:
                craw = cref.raw(frames)
                levels("ctl", craw, want)
                dets("ctl", cref.nms(craw, hw, q=_bf16), ref.nms(craw, hw))
        for key, out in (("got", got), ("ctl", ctl)):
            if err[key]:
                out["raw_rel_err"] = max(
                    (a / max(b, 1e-30)) ** 0.5 for a, b in err[key].values())
                out["det_unmatched"] = n[key][0] / max(1, n[key][1])
        del ref, cref

    if recorder.emb:
        name = cfg["pipeline"]["reid"]
        ref = Embedder(reid_sd, device, name)
        cref = Embedder(reid_sd, device, name,
                        torch.bfloat16) if control else None
        e = {"got": [0.0, 0.0], "ctl": [0.0, 0.0]}
        for u, outs in sorted(recorder.emb.items()):
            frames = torch.from_numpy(np.ascontiguousarray(
                runner.frames(u))).to(device)
            boxes = recorder.dets[u][0]
            for b, got_b in enumerate(outs):
                tlbr = boxes[b, :got_b.shape[0]].float()
                want = ref(frames[b], tlbr)
                pairs = [("got", got_b.float())]
                if cref is not None:
                    pairs.append(("ctl", cref(frames[b], tlbr)))
                for key, x in pairs:
                    e[key][0] += float(((x - want) ** 2).sum())
                    e[key][1] += float((want ** 2).sum())
        got["emb_rel_err"] = (e["got"][0] / max(e["got"][1], 1e-30)) ** 0.5
        if control:
            ctl["emb_rel_err"] = (e["ctl"][0]
                                  / max(e["ctl"][1], 1e-30)) ** 0.5
        del ref, cref

    tracker = tracker_reference(cfg)
    tol = chk["box_tol_px"]

    def q16(x):
        return _bf16(torch.from_numpy(np.asarray(x, np.float64))).numpy()

    tot = {"rows_differ": [0, 0], "state_differ": [0, 0]}
    ctot = {"rows_differ": [0, 0], "state_differ": [0, 0]}
    exact = [0, 0]        # rows_differ of the exact reference, for the log
    judges, cjudges = [], []

    def add(t, rows_a, rows_b, state_a, state_b):
        for key, (d, u) in (("rows_differ", _rows_cmp(rows_a, rows_b, tol)),
                            ("state_differ",
                             _state_cmp(state_a, state_b, tol))):
            t[key][0] += d
            t[key][1] += u

    def judged(st, dets, after, into):
        """The reference step that takes the pairing ``after`` shows where
        it ties with the exact one."""
        tlbr = np.asarray(dets["tlbr"], np.float64)
        judge = Judge(judged_pairs(st, after, {
            "tlwh": np.concatenate([tlbr[:, :2], tlbr[:, 2:] - tlbr[:, :2]],
                                   1),
            "score": np.asarray(dets["score"], np.float64)}),
            chk["tie_slack"])
        into.append(judge)
        return tracker.step(st, dets, tcfg, judge=judge)

    for step in sorted(recorder.steps):
        last, before, det, after = recorder.steps[step]
        st = _state(before)
        if last is not None and not runner.fresh(step):
            d, u = _state_cmp(_state(last), st, 0.0)
            tot["state_differ"][0] += d
            tot["state_differ"][1] += u
        dets = _cut(runner.detections(step, recorder.dets),
                    tcfg["det_capacity"])
        if cfg["pipeline"].get("reid", "none") != "none":
            # the slab's rows are the detector's first det_capacity
            dets["feature"] = det.feature[:len(dets["score"])].double(
                ).cpu().numpy()
        prog = _state(after)
        new, rows = judged(st, dets, prog, judges)
        add(tot, runner.rows(step), rows, prog, new)
        d, u = _rows_cmp(runner.rows(step), tracker.step(st, dets, tcfg)[1],
                         tol)
        exact[0] += d
        exact[1] += u
        if control:
            cnew, crows = tracker.step(st, dets, tcfg, q=q16)
            new, rows = judged(st, dets, cnew, cjudges)
            add(ctot, crows, rows, cnew, new)
    got.update({k: d / max(1, u) for k, (d, u) in tot.items()})
    if control:
        ctl.update({k: d / max(1, u) for k, (d, u) in ctot.items()})
    got["steps_checked"] = len(recorder.steps)
    got["ties"] = {
        "taken": sum(j.ties for j in judges),
        "most_over_optimum": max([j.tie_excess for j in judges] or [0.0]),
        "refused": sum(j.refused for j in judges),
        "refused_most_over": max([j.refused_excess for j in judges]
                                 or [0.0]),
        "exact_rows_differ": exact[0] / max(1, exact[1])}
    return got, ctl
