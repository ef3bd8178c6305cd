"""The check on the CPU at a tiny size: the program equals the plain
reference, the control (the reference one precision lower in the
program's place) fails, and so does a run with the timed path broken
underneath, once for each fault a cell can have."""

import pytest

from perfbench_tiny import run

VIDEO, DEEPSORT = "w6-bytetrack.video", "w6-deepsort.video"


def _readings(res):
    return {k: v["value"] for k, v in res["checks"].items()}


@pytest.mark.parametrize("workload", [VIDEO, DEEPSORT])
def test_reference_equals_the_program(workload):
    res = run(workload, control=True)
    got = _readings(res)
    assert res["correct"], res["checks"]
    # float32 on the CPU: the same network, the same NMS; the reference
    # takes the auction's pairings where they tie with the exact ones
    assert got["raw_rel_err"] < 1e-5 and got["det_unmatched"] == 0.0
    assert got["rows_differ"] == 0.0 and got["state_differ"] == 0.0
    if workload == DEEPSORT:
        assert got["emb_rel_err"] < 1e-5
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    assert any(res["control"][k] > limits[k] for k in limits), \
        res["control"]


def _same_state(pipe):
    step = pipe.step

    def frozen(slab, det, **kw):
        _, out = step(slab, det, **kw)
        return slab, out

    pipe.step = frozen


def _altered_answer(pipe):
    step = pipe.step

    def altered(slab, det, **kw):
        new, out = step(slab, det, **kw)
        return new, out._replace(track_id=out.track_id + 1)

    pipe.step = altered


def _state_reset(pipe):
    """The state a step returned is dropped: every frame starts afresh."""
    step, fresh = pipe.step, pipe.init_tracker()

    def reset(slab, det, **kw):
        return step(fresh, det, **kw)

    pipe.step = reset


def _altered_embedding(pipe):
    """Embeddings computed in bfloat16, as a careless kernel would."""
    embed = pipe.embed_dets

    def rounded(frames, tlbr):
        return embed(frames, tlbr).bfloat16().float()

    pipe.embed_dets = rounded


def _half_batch(pipe):
    detect = pipe.detect_batch

    def half(frames):
        boxes, score, cls, counts = detect(frames)
        counts = counts.clone()
        counts[counts.shape[0] // 2:] = 0
        return boxes, score, cls, counts

    pipe.detect_batch = half


@pytest.mark.parametrize("workload,fault", [
    (VIDEO, _same_state), (VIDEO, _altered_answer), (VIDEO, _half_batch),
    (VIDEO, _state_reset),
    (DEEPSORT, _same_state), (DEEPSORT, _altered_answer),
    (DEEPSORT, _half_batch), (DEEPSORT, _altered_embedding),
])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    assert not run(workload, mutate=fault)["correct"]
