"""The port's slab trackers against the JAX package on the CPU: every step
(sort, c_bioutracker, uavmot, botsort with and without features and with
a moving camera warp, deepsort, strongsort, bytetrack with appearance
fusion; deepmot in tests/test_torch_dhn.py) over 64-frame synthetic
streams with per-detection features, the list-order helpers and
appearance costs one by one, the resolved configs, and track_scan_multi
with two streams. Ids and integer state
must be identical, boxes and features within 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from yolov7_tracker_tpu.trackers import appearance as JA
from yolov7_tracker_tpu.trackers import slab as JS
from yolov7_tracker_tpu.trackers.registry import build_tracker as j_build
from yolov7_tracker_tpu_torch.models.from_jax import slab_from_numpy
from yolov7_tracker_tpu_torch.trackers import appearance as TA
from yolov7_tracker_tpu_torch.trackers import slab as TS
from yolov7_tracker_tpu_torch.trackers.registry import build_tracker as t_build

FEAT = 24


def feature_stream(seed, n_frames=64, n_obj=8, d=24, feat=FEAT, warps=False):
    """Per frame: (tlbr (d,4), score (d,), valid (d,), feature (d,F),
    warp (2,3)) numpy arrays. Objects move, vanish for a while (lost and
    refound tracks), score low at times (second-stage matches); false
    positives appear at random. Each object has its own basis vector as
    appearance, which a det carries with small noise; a false positive
    takes one of the basis vectors no object has. So appearance costs are
    association-shaped (a few pairs under the thresholds), the regime in
    which the port's private-dummy auction and the JAX package's square
    auction on the CPU find the same matching (on dense costs they may
    not: tests/test_torch_auction.py). ``warps``: a slowly turning,
    zooming, panning camera warp per frame, else identity."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(50, 500, (n_obj, 2))
    vel = rng.uniform(-5, 5, (n_obj, 2))
    wh = rng.uniform(25, 70, (n_obj, 2))
    app = np.eye(feat)
    gone = [(int(rng.integers(5, max(6, n_frames - 15))),
             int(rng.integers(3, 12))) for _ in range(n_obj)]
    frames = []
    for t in range(n_frames):
        rows, scores, feats = [], [], []
        for i in range(n_obj):
            start, length = gone[i]
            if start <= t < start + length and i % 2 == 0:
                continue
            xy = pos[i] + vel[i] * t + rng.normal(0, 1.0, 2)
            rows.append(np.r_[xy, xy + wh[i]])
            scores.append(rng.uniform(0.7, 0.95) if rng.random() > 0.2
                          else rng.uniform(0.25, 0.45))
            feats.append(app[i] + rng.normal(0, 0.003, feat))
        for _ in range(int(rng.integers(0, 3))):
            xy = rng.uniform(0, 600, 2)
            rows.append(np.r_[xy, xy + rng.uniform(20, 60, 2)])
            scores.append(rng.uniform(0.2, 0.8))
            feats.append(app[rng.integers(n_obj, feat)]
                         + rng.normal(0, 0.003, feat))
        order = rng.permutation(len(rows))
        n = len(rows)
        tlbr = np.zeros((d, 4), np.float32)
        score = np.zeros(d, np.float32)
        valid = np.zeros(d, bool)
        feature = np.zeros((d, feat), np.float32)
        tlbr[:n] = np.asarray(rows, np.float32)[order]
        score[:n] = np.asarray(scores, np.float32)[order]
        valid[:n] = True
        feature[:n] = np.asarray(feats, np.float32)[order]
        warp = np.float32([[1, 0, 0], [0, 1, 0]])
        if warps:
            a, b = rng.normal(0, 2e-3, 2)
            warp = np.float32([[1 + a, -b, rng.normal(0, 2.0)],
                               [b, 1 + a, rng.normal(0, 2.0)]])
        frames.append((tlbr, score, valid, feature, warp))
    return frames


def run_both(cfg_kw, frames, check_features=True, solve_stage1=None):
    """Step both packages through the frames; compare every frame's
    output and slab. ``solve_stage1``: the port's stage-1 solver (default:
    the step's own). Returns (rows emitted, the port's last slab)."""
    cfg = JS.TrackerConfig(**cfg_kw)
    j_step, j_cfg = j_build(cfg)
    t_step, t_cfg = t_build(TS.TrackerConfig(**cfg_kw))
    assert vars(t_cfg) == vars(j_cfg)
    j_slab, t_slab = JS.init_slab(j_cfg), TS.init_slab(t_cfg, "cpu")
    n_rows = 0
    for k, (tlbr, score, valid, feature, warp) in enumerate(frames):
        cls = np.zeros_like(score)
        feat = feature if t_cfg.feature_dim > 0 else None
        j_slab, j_out = j_step(j_slab, JS.make_det_slab(
            j_cfg, tlbr, score, cls, valid, feature=feat, warp=warp))
        t_slab, t_out = t_step(t_slab, TS.make_det_slab(
            t_cfg, tlbr, score, cls, valid, "cpu", feature=feat, warp=warp),
            solve_stage1=solve_stage1)
        where = f"frame {k}"
        jv, tv = np.asarray(j_out.valid), t_out.valid.numpy()
        np.testing.assert_array_equal(tv, jv, err_msg=where)
        np.testing.assert_array_equal(t_out.track_id.numpy()[tv],
                                      np.asarray(j_out.track_id)[jv],
                                      err_msg=where)
        np.testing.assert_allclose(t_out.tlwh.numpy()[tv],
                                   np.asarray(j_out.tlwh)[jv], atol=1e-4,
                                   rtol=0, err_msg=where)
        for name in ("state", "track_id", "occupied", "is_activated",
                     "time_since_update", "feat_count", "ins_seq",
                     "lost_seq", "next_id"):
            np.testing.assert_array_equal(
                getattr(t_slab, name).numpy(),
                np.asarray(getattr(j_slab, name)), err_msg=f"{where} {name}")
        occ = np.asarray(j_slab.occupied)
        fields = ("extra",) + (("feature", "feat_hist") if check_features
                               else ())
        for name in fields:
            np.testing.assert_allclose(
                getattr(t_slab, name).numpy()[occ],
                np.asarray(getattr(j_slab, name))[occ], atol=1e-4, rtol=0,
                err_msg=f"{where} {name}")
        n_rows += int(tv.sum())
    return n_rows, t_slab


BASE = dict(conf_thresh=0.5, capacity=32, det_capacity=24)
CASES = {
    "sort": dict(tracker="sort"),
    "c_bioutracker": dict(tracker="c_bioutracker"),
    "uavmot": dict(tracker="uavmot"),
    "botsort": dict(tracker="botsort"),
    "botsort_features": dict(tracker="botsort", feature_dim=FEAT),
    # track_buffer 10: a cascade of 10 levels (the JAX scan compiles
    # once; the port solves every level)
    "deepsort": dict(tracker="deepsort", feature_dim=FEAT, feature_hist=4,
                     track_buffer=10),
    "strongsort": dict(tracker="strongsort", feature_dim=FEAT),
    "bytetrack_features": dict(tracker="bytetrack", feature_dim=FEAT),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_matches_jax(name):
    warps = name.startswith(("botsort", "strongsort"))
    n_rows, slab = run_both({**BASE, **CASES[name]},
                            feature_stream(7, warps=warps))
    assert n_rows > 150, n_rows       # the stream really carried tracks
    assert int(slab.next_id) >= 8


@pytest.mark.parametrize("tracker", ["uavmot", "deepsort"])
def test_list_order_steps_match_jax_on_crowded_stream(tracker):
    """More objects than det slots half the time, so the mis-indexed
    lost-marking and the refind order of the list-order trackers act."""
    kw = {**BASE, "tracker": tracker, "track_buffer": 6}
    if tracker == "deepsort":
        kw.update(feature_dim=FEAT, feature_hist=3)
    n_rows, _ = run_both(kw, feature_stream(3, n_frames=60, n_obj=14))
    assert n_rows > 300


def test_resolved_configs_match_jax():
    for tracker in ("sort", "c_bioutracker", "uavmot", "botsort", "deepsort",
                    "strongsort", "bytetrack", "deepmot"):
        for extra in ({}, {"feature_dim": 512}, {"kalman_format": "naive"}):
            kw = dict(tracker=tracker, **extra)
            _, j_cfg = j_build(JS.TrackerConfig(**kw))
            _, t_cfg = t_build(TS.TrackerConfig(**kw))
            assert vars(t_cfg) == vars(j_cfg), kw
    with pytest.raises(KeyError, match="unknown tracker"):
        t_build(TS.TrackerConfig(tracker="nope"))


def _random_slab(rng, t=12, f=6, h=3):
    """A JAX-layout slab of numpy leaves with a mixed pool: tracked
    (activated or not), lost, free; scrambled list keys."""
    state = rng.choice([JS.TRACKED, JS.LOST, JS.REMOVED], t)
    occupied = state != JS.REMOVED
    mean = np.c_[rng.uniform(50, 400, (t, 2)), rng.uniform(0.3, 0.8, t),
                 rng.uniform(30, 90, t), rng.normal(0, 1, (t, 4))]
    a = rng.normal(0, 1, (t, 8, 8))
    cov = np.eye(8) + 0.05 * a @ a.transpose(0, 2, 1)
    return JS.TrackSlab(
        mean=mean.astype(np.float32), cov=cov.astype(np.float32),
        det_tlwh=rng.uniform(10, 80, (t, 4)).astype(np.float32),
        score=rng.uniform(0.3, 1, t).astype(np.float32),
        cls=np.zeros(t, np.float32), state=state.astype(np.int32),
        occupied=occupied, is_activated=occupied & (rng.random(t) < 0.7),
        track_id=np.arange(1, t + 1, dtype=np.int32),
        frame_id=rng.integers(1, 9, t).astype(np.int32),
        start_frame=np.ones(t, np.int32),
        tracklet_len=rng.integers(0, 5, t).astype(np.int32),
        time_since_update=rng.integers(0, 4, t).astype(np.int32),
        feature=rng.standard_normal((t, f)).astype(np.float32),
        feat_hist=rng.standard_normal((t, h, f)).astype(np.float32),
        feat_count=rng.integers(0, 5, t).astype(np.int32),
        extra=np.zeros((t, 0), np.float32),
        ins_seq=rng.permutation(t * 3)[:t].astype(np.int32),
        lost_seq=rng.permutation(t * 3)[:t].astype(np.int32),
        next_id=np.int32(t), frame=np.int32(9))


@pytest.mark.parametrize("seed", range(4))
def test_list_order_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    j_np = _random_slab(rng)
    j_slab = JS.TrackSlab(*(jnp.asarray(x) for x in j_np))
    t_slab = slab_from_numpy(j_np)
    j_slab = JS.rebase_seq_keys(j_slab)
    t_slab = TS.rebase_seq_keys(t_slab)
    np.testing.assert_array_equal(t_slab.ins_seq.numpy(), j_slab.ins_seq)
    np.testing.assert_array_equal(t_slab.lost_seq.numpy(), j_slab.lost_seq)
    j_pm, t_pm = JS.pool_mask(j_slab), TS.pool_mask(t_slab)
    j_rank = JS.pool_order_rank(j_slab, j_pm)
    t_rank = TS.pool_order_rank(t_slab, t_pm)
    pm = np.asarray(j_pm)
    np.testing.assert_array_equal(t_rank.numpy()[pm], np.asarray(j_rank)[pm])
    u0 = pm & (rng.random(12) < 0.6)
    un2 = u0 & (rng.random(12) < 0.6)
    j_wrong = JS.misindexed_lost_mask(j_slab, j_rank, jnp.asarray(u0),
                                      jnp.asarray(un2), j_pm)
    t_wrong = TS.misindexed_lost_mask(t_slab, t_rank, torch.from_numpy(u0),
                                      torch.from_numpy(un2), t_pm)
    np.testing.assert_array_equal(t_wrong.numpy(), j_wrong)
    j_lost = JS.mark_lost_ordered(j_slab, j_wrong, j_rank, 24)
    t_lost = TS.mark_lost_ordered(t_slab, t_wrong, t_rank)
    np.testing.assert_array_equal(t_lost.lost_seq.numpy(), j_lost.lost_seq)
    np.testing.assert_array_equal(t_lost.state.numpy(), j_lost.state)


@pytest.mark.parametrize("seed", range(3))
def test_appearance_functions_match_jax(seed):
    rng = np.random.default_rng(seed)
    j_np = _random_slab(rng)
    t_slab = slab_from_numpy(j_np)
    j_slab = JS.TrackSlab(*(jnp.asarray(x) for x in j_np))
    tf = rng.standard_normal((12, 6)).astype(np.float32)
    df = rng.standard_normal((9, 6)).astype(np.float32)
    df[3] = 0.0                       # a det without a feature

    def close(t, j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-5)

    tt, tdf = torch.from_numpy(tf), torch.from_numpy(df)
    close(TA.cosine_distance(tt, tdf), JA.cosine_distance(tf, df))
    close(TA.euclidean_distance(tt, tdf), JA.euclidean_distance(tf, df))
    close(TA.nearest_embedding_distance(t_slab.feat_hist, t_slab.feat_count,
                                        tdf),
          JA.nearest_embedding_distance(j_slab.feat_hist,
                                        j_slab.feat_count, df))
    tlbr = np.c_[rng.uniform(40, 400, (9, 2)), rng.uniform(420, 500, (9, 2))]
    tlbr = tlbr.astype(np.float32)
    valid = np.ones(9, bool)
    j_dets = JS.make_det_slab(JS.TrackerConfig(det_capacity=9), tlbr,
                              np.ones(9), np.zeros(9), valid, feature=None)
    t_dets = TS.make_det_slab(TS.TrackerConfig(det_capacity=9), tlbr,
                              np.ones(9), np.zeros(9), valid, "cpu")
    app = rng.uniform(0, 0.3, (12, 9)).astype(np.float32)
    close(TA.gate_cost_matrix(torch.from_numpy(app), t_slab, t_dets,
                              "default"),
          JA.gate_cost_matrix(jnp.asarray(app), j_slab, j_dets, "default"))
    warp = np.float32([[1.01, -0.02, 5.0], [0.02, 1.01, -3.0]])
    mask = np.array(JS.pool_mask(j_slab))
    jw = JA.apply_gmc(j_slab, jnp.asarray(warp), jnp.asarray(mask))
    tw = TA.apply_gmc(t_slab, torch.from_numpy(warp), torch.from_numpy(mask))
    np.testing.assert_allclose(tw.mean.numpy(), jw.mean, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(tw.cov.numpy(), jw.cov, atol=1e-4, rtol=1e-5)
    xy = rng.uniform(0, 800, (12, 2)).astype(np.float32)
    xy[5] = xy[4]                     # a zero-distance pair
    v = rng.random(12) < 0.8
    close(TA.structure_similarity(torch.from_numpy(xy), torch.from_numpy(v)),
          JA.structure_similarity(jnp.asarray(xy), jnp.asarray(v)))
    close(TA.structure_distance(torch.from_numpy(xy), torch.from_numpy(v),
                                torch.from_numpy(xy[:7]),
                                torch.from_numpy(v[:7])),
          JA.structure_distance(jnp.asarray(xy), jnp.asarray(v),
                                jnp.asarray(xy[:7]), jnp.asarray(v[:7])))
    rm = np.array(JS.pool_mask(j_slab))
    cm = rng.random(9) < 0.8
    cost = rng.uniform(0, 1, (12, 9)).astype(np.float32)
    j_r2c, j_c2r = JA.matching_cascade(jnp.asarray(cost), j_slab,
                                       jnp.asarray(rm), jnp.asarray(cm),
                                       0.7, 4)
    t_r2c, t_c2r = TA.matching_cascade(torch.from_numpy(cost), t_slab,
                                       torch.from_numpy(rm),
                                       torch.from_numpy(cm), 0.7, 4)
    np.testing.assert_array_equal(t_r2c.numpy(), j_r2c)
    np.testing.assert_array_equal(t_c2r.numpy(), j_c2r)


@pytest.mark.parametrize("tracker", ["sort", "deepsort"])
def test_track_scan_multi_matches_jax(tracker):
    """Two streams through both packages' track_scan_multi (the port:
    stage 1, or every cascade level, by the square auction)."""
    from yolov7_tracker_tpu.pipeline import TrackingPipeline as JPipeline
    from yolov7_tracker_tpu_torch.ops.assignment import masked_assignment

    n_ticks, s = 40, 2
    kw = {**BASE, "tracker": tracker, "track_buffer": 6}
    if tracker == "deepsort":
        kw.update(feature_dim=FEAT, feature_hist=3)
    streams = [feature_stream(seed, n_frames=n_ticks, n_obj=6 + seed)
               for seed in range(s)]
    tlbr, score, valid, feature = (
        np.stack([np.stack([st[t][k] for st in streams])
                  for t in range(n_ticks)]) for k in range(4))
    fd = feature.shape[-1] if tracker == "deepsort" else 0
    feature = feature[..., :fd]
    shape = (n_ticks, s, 24)

    t_step, t_cfg = t_build(TS.TrackerConfig(**kw))
    slabs = TS.TrackSlab(*(x[None].repeat((s,) + (1,) * x.dim())
                           for x in TS.init_slab(t_cfg, "cpu")))
    t_outs = []
    for t in range(n_ticks):
        slabs, out = t_step(slabs, TS.DetSlab(
            torch.from_numpy(tlbr[t]), torch.from_numpy(score[t]),
            torch.zeros(shape[1:]), torch.from_numpy(valid[t]),
            torch.from_numpy(feature[t])), solve_stage1=masked_assignment)
        t_outs.append(out)

    # the JAX package's own track_scan_multi, without a detector
    j_step, j_cfg = j_build(JS.TrackerConfig(**kw))
    jpipe = JPipeline.__new__(JPipeline)
    jpipe.step, jpipe.tcfg = j_step, j_cfg
    j_slabs = jax.tree.map(lambda x: jnp.tile(x[None], (s,) + (1,) * x.ndim),
                           JS.init_slab(j_cfg))
    _, j_outs = jpipe.track_scan_multi(j_slabs, JS.DetSlab(
        tlbr=jnp.asarray(tlbr), score=jnp.asarray(score),
        cls=jnp.zeros(shape), valid=jnp.asarray(valid),
        feature=jnp.asarray(feature),
        warp=jnp.tile(JS.IDENTITY_WARP, shape[:2] + (1, 1))))
    rows = 0
    for t, out in enumerate(t_outs):
        jv = np.asarray(j_outs.valid[t])
        np.testing.assert_array_equal(out.valid.numpy(), jv)
        np.testing.assert_array_equal(out.track_id.numpy()[jv],
                                      np.asarray(j_outs.track_id[t])[jv])
        np.testing.assert_allclose(out.tlwh.numpy()[jv],
                                   np.asarray(j_outs.tlwh[t])[jv], atol=1e-4,
                                   rtol=0)
        rows += int(jv.sum())
    assert rows > 150
