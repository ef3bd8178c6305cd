"""Many-stream tracking on the CPU: the port's stacked slab helpers against
a loop over streams, ``process_multistream`` against per-stream
``step_frame``, and ``process_multistream`` / ``track_scan_multi`` against
the JAX package on the same numpy frames and detections (yolov7-tiny nc 4
at 160 px, float32, capacity 16, det_capacity 16, every head level
sharpened, so the scenes hold ties between identical boxes: both packages
solve stage 1 with the square auction and break them alike)."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_bytetrack import _stream
from tests.test_torch_zoo import sharpen_v8_heads
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, random_variables, sharpen_heads,
)
from yolov7_tracker_tpu.models import zoo as jzoo
from yolov7_tracker_tpu.pipeline import PipelineConfig as JPipelineConfig
from yolov7_tracker_tpu.pipeline import TrackingPipeline as JPipeline
from yolov7_tracker_tpu.trackers import slab as JS
from yolov7_tracker_tpu_torch.data.sequence import SynthFrames
from yolov7_tracker_tpu_torch.models import zoo as tzoo
from yolov7_tracker_tpu_torch.models.from_jax import (
    jax_variables_to_torch, slab_from_numpy, slab_to_numpy,
)
from yolov7_tracker_tpu_torch.ops.assignment import masked_assignment
from yolov7_tracker_tpu_torch.pipeline import PipelineConfig, TrackingPipeline
from yolov7_tracker_tpu_torch.trackers import slab as TS
from yolov7_tracker_tpu_torch.trackers import registry
from yolov7_tracker_tpu_torch.trackers.registry import build_tracker

N_STREAMS = 3
N_TICKS = 12
PIPE = dict(model="yolov7-tiny", nc=4, img_size=160, detector_batch=2,
            dtype="float32")
# track_buffer 3: a lost track is removed after 3 frames, inside the run
TRACK = dict(tracker="bytetrack", conf_thresh=0.5, capacity=16,
             det_capacity=16, track_buffer=3)


@pytest.fixture(scope="module")
def weights():
    spec = jzoo.get_spec("yolov7-tiny", nc=4)
    return sharpen_heads(random_variables(spec, seed=2), spec)


@pytest.fixture(scope="module")
def port(weights):
    spec = tzoo.get_spec("yolov7-tiny", nc=4)
    return TrackingPipeline(
        PipelineConfig(**PIPE), TS.TrackerConfig(**TRACK),
        state_dict=jax_variables_to_torch(weights, spec), spec=spec,
        device="cpu")


@pytest.fixture(scope="module")
def jpipe(weights):
    return JPipeline(JPipelineConfig(wpack=False, **PIPE),
                     JS.TrackerConfig(**TRACK),
                     variables=jax.tree.map(jnp.asarray, weights),
                     spec=jzoo.get_spec("yolov7-tiny", nc=4))


def _frames():
    """(N_TICKS, N_STREAMS, 120, 200, 3): three synthetic cameras whose
    blocks move 9 px per frame."""
    cams = [list(SynthFrames(f"synth://{N_TICKS}x120x200?seed={s}&shift=9"))
            for s in range(N_STREAMS)]
    return np.stack([np.stack(f) for f in zip(*cams)])


def _lane(slabs, i):
    return TS.TrackSlab(*(x[i] for x in slabs))


def _assert_slab_matches(t_slab, j_slab, where):
    """Port slab (torch) against a JAX slab or a port slab: integer and
    bool state exact, Kalman means and boxes to 1e-3 px. Scores are held
    on the slots whose box is unique in their stream: two tracks born on
    bit-identical boxes (both clipped to the whole frame, say) meet two
    identical detections in a four-way tie of equal costs, every pairing
    is optimal, and which one the auction lands on turns on the last bit
    of the Kalman arithmetic, which the two frameworks round differently.
    Only the score tells those detections apart."""
    t_np = slab_to_numpy(t_slab)
    j_np = TS.TrackSlab(*(np.asarray(x) for x in j_slab))
    for name, a, b in zip(TS.TrackSlab._fields, t_np, j_np):
        if a.dtype.kind in "ib":
            np.testing.assert_array_equal(a, b, err_msg=f"{where}: {name}")
        elif name in ("mean", "det_tlwh"):
            np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-5,
                                       err_msg=f"{where}: {name}")
    box = j_np.det_tlwh
    same = (box[..., :, None, :] == box[..., None, :, :]).all(-1)
    occ = j_np.occupied
    unique = occ & ((same & occ[..., None, :]).sum(-1) == 1)
    assert unique.sum() >= 0.5 * occ.sum(), where
    np.testing.assert_allclose(t_np.score[unique], j_np.score[unique],
                               atol=1e-3, err_msg=f"{where}: score")


def _assert_outputs_match(t_out, j_out, where):
    tv = t_out.valid.numpy()
    np.testing.assert_array_equal(tv, np.asarray(j_out.valid), err_msg=where)
    np.testing.assert_array_equal(t_out.track_id.numpy()[tv],
                                  np.asarray(j_out.track_id)[tv],
                                  err_msg=where)
    np.testing.assert_allclose(t_out.tlwh.numpy()[tv],
                               np.asarray(j_out.tlwh)[tv], atol=1e-3, rtol=0,
                               err_msg=where)


# ---------------------------------------------------------------------------
# the stacked slab helpers against a loop over streams
# ---------------------------------------------------------------------------

def _populated(n_frames=9):
    """Three streams' slabs after n_frames of ByteTrack on different
    detection streams (tracked, lost and freed slots), each with the next
    frame's detections."""
    step, cfg = build_tracker(TS.TrackerConfig(
        tracker="bytetrack", conf_thresh=0.5, capacity=16, det_capacity=24,
        track_buffer=3), "cpu")
    slabs, dets = [], []
    for seed in range(N_STREAMS):
        slab = TS.init_slab(cfg, "cpu")
        stream = _stream(seed, n_frames=n_frames + 1, n_obj=8 + seed)
        for tlbr, score, valid in stream[:-1]:
            slab, _ = step(slab, TS.make_det_slab(
                cfg, tlbr, score, np.zeros_like(score), valid, "cpu"))
        tlbr, score, valid = stream[-1]
        slabs.append(slab._replace(frame=slab.frame + 1))
        dets.append(TS.make_det_slab(cfg, tlbr, score, np.zeros_like(score),
                                     valid, "cpu"))
    return cfg, slabs, dets


def _assert_lane_equals(stacked, i, alone, where):
    """Lane i of a stacked NamedTuple against the same thing computed
    alone: integer and bool fields exact; float fields to 1e-5 relative /
    1e-4 absolute, since a stacked matrix product may sum in another
    order than a single one."""
    for field, a, b in zip(alone._fields, stacked, alone):
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-4, err_msg=f"{where} {field}")
        else:
            assert torch.equal(a[i], b), (where, field)


def _stack(items):
    return type(items[0])(*(torch.stack(xs) for xs in zip(*items)))


def _r2c(slab, dets, seed):
    """An arbitrary injective partial matching of occupied slots."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(dets.valid.shape[0])[:slab.capacity]
    r2c = np.where((rng.random(slab.capacity) < 0.6)
                   & slab.occupied.numpy(), perm, -1)
    return torch.from_numpy(r2c.astype(np.int32))


HELPERS = {
    "predict_pool": lambda cfg, s, d, k: TS.predict_pool(s, "default"),
    "apply_matches": lambda cfg, s, d, k: TS.apply_matches(
        s, d, k["r2c"], "default", cfg),
    "init_new_tracks": lambda cfg, s, d, k: TS.init_new_tracks(
        s, d, k["new"], "default", cfg),
    "prune_lost": lambda cfg, s, d, k: TS.prune_lost(s, 1),
    "remove_duplicates": lambda cfg, s, d, k: TS.remove_duplicates(
        s, "default"),
    "frame_output": lambda cfg, s, d, k: TS.frame_output(s, "default", cfg),
    "mark_lost_removed": lambda cfg, s, d, k: TS.mark_removed(
        TS.mark_lost(s, k["r2c"] >= 0), k["new"][..., :16]),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_stacked_slab_helper_equals_loop_over_streams(name):
    """Each lifecycle helper on three stacked streams of differing
    occupancy == the helper on each stream alone."""
    cfg, slabs, dets = _populated()
    extras = [dict(r2c=_r2c(s, d, i),
                   new=d.valid & (torch.arange(24) % 2 == 0))
              for i, (s, d) in enumerate(zip(slabs, dets))]
    alone = [HELPERS[name](cfg, s, d, k)
             for s, d, k in zip(slabs, dets, extras)]
    stacked = HELPERS[name](
        cfg, _stack(slabs), _stack(dets),
        {k: torch.stack([e[k] for e in extras]) for k in extras[0]})
    assert any(bool(s.occupied.any()) and not bool(s.occupied.all())
               for s in slabs)
    for i, want in enumerate(alone):
        _assert_lane_equals(stacked, i, want, f"{name}[{i}]")


def test_stacked_step_equals_loop_over_streams():
    """The whole ByteTrack step, both stage-1 solvers, 6 frames."""
    step, cfg = build_tracker(TS.TrackerConfig(
        tracker="bytetrack", conf_thresh=0.5, capacity=16, det_capacity=24,
        track_buffer=3), "cpu")
    streams = [_stream(seed, n_frames=6, n_obj=7 + seed)
               for seed in range(N_STREAMS)]
    for kw in ({}, {"solve_stage1": masked_assignment}):
        alone = [TS.init_slab(cfg, "cpu") for _ in streams]
        stacked = _stack(alone)
        for t in range(6):
            dets = [TS.make_det_slab(cfg, f[0], f[1], np.zeros_like(f[1]),
                                     f[2], "cpu")
                    for f in (s[t] for s in streams)]
            outs = []
            for i, d in enumerate(dets):
                alone[i], out = step(alone[i], d, **kw)
                outs.append(out)
            stacked, s_out = step(stacked, _stack(dets), **kw)
            for i in range(N_STREAMS):
                _assert_lane_equals(stacked, i, alone[i], f"t{t} s{i}")
                _assert_lane_equals(s_out, i, outs[i], f"t{t} s{i} out")
        assert int(stacked.next_id.min()) >= 5


# ---------------------------------------------------------------------------
# the streaming entry points
# ---------------------------------------------------------------------------

def test_process_multistream_equals_per_stream_step_frame(port):
    """States and ids exact, means and boxes 1e-5 relative / 1e-4 absolute
    (the detector runs at batch 3 against batch 1)."""
    frames = _frames()[:6]
    slabs = port.init_multistream(N_STREAMS)
    singles = [port.init_tracker() for _ in range(N_STREAMS)]
    for t in range(frames.shape[0]):
        slabs, outs = port.process_multistream(slabs, frames[t])
        for i in range(N_STREAMS):
            singles[i], out = port.step_frame(singles[i], frames[t, i])
            got = _lane(slabs, i)
            for name in ("state", "track_id", "occupied", "is_activated",
                         "frame_id", "next_id", "frame"):
                assert torch.equal(getattr(got, name),
                                   getattr(singles[i], name)), (t, i, name)
            for name in ("mean", "det_tlwh"):
                np.testing.assert_allclose(
                    getattr(got, name).numpy(),
                    getattr(singles[i], name).numpy(), rtol=1e-5, atol=1e-4)
            assert torch.equal(outs.valid[i], out.valid)
    assert int(slabs.next_id.min()) >= 2       # every stream tracked


def test_process_multistream_matches_jax(jpipe, port):
    """A dozen ticks of three cameras through detector + tracker in both
    packages: ids and states exact, boxes within 1e-3 px; the scenes give
    births and removals, and ties that are not avoided."""
    frames = _frames()
    j_slabs = jpipe.init_multistream(N_STREAMS)
    t_slabs = port.init_multistream(N_STREAMS)
    _assert_slab_matches(t_slabs, j_slabs, "init")
    removed = 0
    for t in range(N_TICKS):
        before = t_slabs.occupied
        j_slabs, j_out = jpipe.process_multistream(j_slabs, frames[t])
        t_slabs, t_out = port.process_multistream(t_slabs, frames[t])
        _assert_outputs_match(t_out, j_out, f"tick {t}")
        _assert_slab_matches(t_slabs, j_slabs, f"tick {t}")
        removed += int((before & ~t_slabs.occupied).sum())
    assert int(t_slabs.next_id.min()) >= 3 and removed >= 1
    # each package goes on from the other's state (models/from_jax.py)
    from_j = slab_from_numpy(jax.tree.map(np.asarray, j_slabs), "cpu")
    from_t = JS.TrackSlab(*(jnp.asarray(x) for x in slab_to_numpy(t_slabs)))
    j_next, j_out = jpipe.process_multistream(from_t, frames[0])
    t_next, t_out = port.process_multistream(from_j, frames[0])
    _assert_outputs_match(t_out, j_out, "swapped states")
    _assert_slab_matches(t_next, j_next, "swapped states")


def test_track_scan_multi_matches_jax(jpipe, port):
    """The same detections (births, low-score matches, occlusions, false
    positives) through both packages' track_scan_multi."""
    streams = [_stream(seed, n_frames=N_TICKS, n_obj=6 + seed, d=16)
               for seed in range(N_STREAMS)]
    tlbr, score, valid = (np.stack([np.stack([s[t][k] for s in streams])
                                    for t in range(N_TICKS)])
                          for k in range(3))
    shape = (N_TICKS, N_STREAMS, 16)
    t_dets = TS.DetSlab(
        tlbr=torch.from_numpy(tlbr), score=torch.from_numpy(score),
        cls=torch.zeros(shape), valid=torch.from_numpy(valid),
        feature=torch.zeros(shape + (0,)))
    t_slabs, t_outs = port.track_scan_multi(
        port.init_multistream(N_STREAMS), t_dets)

    j_dets = JS.DetSlab(
        tlbr=jnp.asarray(tlbr), score=jnp.asarray(score),
        cls=jnp.zeros(shape), valid=jnp.asarray(valid),
        feature=jnp.zeros(shape + (0,)),
        warp=jnp.tile(JS.IDENTITY_WARP, shape[:2] + (1, 1)))
    j_slabs, j_outs = jpipe.track_scan_multi(
        jpipe.init_multistream(N_STREAMS), j_dets)

    _assert_outputs_match(t_outs, j_outs, "scan")
    _assert_slab_matches(t_slabs, j_slabs, "scan")
    assert int(t_outs.valid.sum()) > 100 and int(t_slabs.next_id.min()) >= 6


def test_process_multistream_with_a_v8_detector_matches_jax():
    """yolov8n (DetectV8, the decoded-path NMS) under process_multistream:
    the same outputs and states as the JAX package, tick by tick."""
    spec = jzoo.get_spec("yolov8n", nc=1)
    # the stride-8 level only: the coarser ones give boxes clipped to the
    # whole frame, several of them identical (see _assert_slab_matches)
    weights = sharpen_v8_heads(random_variables(spec, seed=4), spec,
                               sharpen=16.0, obj_boost=6.0, levels=(0,))
    pipe = dict(PIPE, model="yolov8n", nc=1)
    t_spec = tzoo.get_spec("yolov8n", nc=1)
    port = TrackingPipeline(
        PipelineConfig(**pipe), TS.TrackerConfig(**TRACK),
        state_dict=jax_variables_to_torch(weights, t_spec), spec=t_spec,
        device="cpu")
    jpipe = JPipeline(JPipelineConfig(wpack=False, **pipe),
                      JS.TrackerConfig(**TRACK),
                      variables=jax.tree.map(jnp.asarray, weights),
                      spec=spec)
    frames = _frames()[:6]
    j_slabs = jpipe.init_multistream(N_STREAMS)
    t_slabs = port.init_multistream(N_STREAMS)
    for t in range(frames.shape[0]):
        j_slabs, j_out = jpipe.process_multistream(j_slabs, frames[t])
        t_slabs, t_out = port.process_multistream(t_slabs, frames[t])
        _assert_outputs_match(t_out, j_out, f"tick {t}")
        _assert_slab_matches(t_slabs, j_slabs, f"tick {t}")
    assert int(t_slabs.next_id.min()) >= 2       # every stream tracked


# ---------------------------------------------------------------------------
# one frame path: every entry hands the step the same DetSlab
# ---------------------------------------------------------------------------

def _assert_same_det(got, want, where):
    for name, a, b in zip(TS.DetSlab._fields, got, want):
        assert (a.shape, a.dtype, a.device) == (b.shape, b.dtype,
                                                b.device), (where, name)
        assert torch.equal(a, b), (where, name)


@pytest.mark.parametrize("reid", ["none", "deepsort_cnn"])
def test_entries_hand_the_step_the_same_det_slab(weights, reid):
    """process_batch on a batch of one, step_frame, and process_multistream
    at S = 1 (its stream axis dropped; its warp serves every stream) give
    the step equal DetSlabs, field by field, with and without ReID; the
    streaming entries solve stage 1 by registry.stream_step's solver."""
    spec = tzoo.get_spec("yolov7-tiny", nc=4)
    track = dict(TRACK, det_capacity=24)
    if reid != "none":
        track.update(tracker="deepsort")
    pipe = TrackingPipeline(
        PipelineConfig(**dict(PIPE, reid=reid)), TS.TrackerConfig(**track),
        state_dict=jax_variables_to_torch(weights, spec), spec=spec,
        device="cpu")
    seen, step = [], pipe.step

    def recording(slab, det, **kw):
        seen.append((det, kw))
        return step(slab, det, **kw)

    pipe.step = recording
    frame = _frames()[0, 0]
    pipe.process_batch(pipe.init_tracker(), frame[None])
    pipe.step_frame(pipe.init_tracker(), frame)
    pipe.process_multistream(pipe.init_multistream(1), frame[None])
    (batch, kw_b), (single, kw_s), (multi, kw_m) = seen
    assert kw_b == {}
    assert kw_s == kw_m == {"solve_stage1": registry.masked_assignment}
    assert bool(batch.valid.any())
    assert batch.feature.shape[-1] == pipe.tcfg.feature_dim
    if reid != "none":
        assert bool(batch.feature.any())
    _assert_same_det(single, batch, "step_frame")
    _assert_same_det(TS.DetSlab(*(x[0] for x in multi[:-1]), multi.warp),
                     batch, "process_multistream")


@pytest.mark.parametrize("n, max_det", [(0, 32), (9, 32), (16, 32),
                                        (23, 32), (5, 8)])
def test_det_slab_from_host_rows_equals_detector_outputs(n, max_det):
    """make_det_slab on n host rows == dets_to_slab on NMS's layout of the
    same rows (max_det rows, zeros past the count) for det_capacity 16:
    no detection, fewer, exactly 16, more, and outputs narrower than the
    capacity; values, shapes, dtypes and devices."""
    cfg = TS.TrackerConfig(det_capacity=16, feature_dim=5)
    rng = np.random.default_rng(n)
    xy = rng.uniform(0, 500, (n, 2))
    rows = np.c_[xy, xy + rng.uniform(10, 90, (n, 2)),
                 np.sort(rng.uniform(0.1, 1.0, n))[::-1],
                 rng.integers(0, 4, n)].astype(np.float32)
    out = np.zeros((max_det, 6), np.float32)
    out[:n] = rows
    out = torch.from_numpy(out)
    pipe = types.SimpleNamespace(tcfg=cfg)
    got = TrackingPipeline.dets_to_slab(pipe, out[:, :4], out[:, 4],
                                        out[:, 5], torch.tensor(n))
    want = TS.make_det_slab(cfg, rows[:, :4], rows[:, 4], rows[:, 5],
                            np.ones(n, bool), "cpu")
    _assert_same_det(got, want, f"{n} rows")
    assert want.tlbr.shape == (16, 4) and want.feature.shape == (16, 5)
    assert int(want.valid.sum()) == min(n, 16)
