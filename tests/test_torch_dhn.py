"""The port's DeepMOT against the JAX package on the CPU: the Flax-msgpack
reader against flax.serialization (and msgpack) on the repo's two DHN
files and on trees of mixed dtypes; the GRU DHN (trained hidden 32, seeded
hidden 8) and the Sinkhorn DHN against DHN.apply at 1e-5; compact_cost /
uncompact permutations, with and without the pool-order key and with a
stream axis against jax.vmap; the deepmot step (no DHN, GRU h32, Sinkhorn)
over 20 frames of a crowded stream (ids and integer state exact, boxes
1e-4), at S = 3 streams against the vmapped JAX step; and --tracker
deepmot through the CLI against the JAX pipeline. The port solves stage 1
with the square auction here, as the JAX package does on the CPU: the
blend of centre and IoU distance is dense (far pairs cost 0.75), where the
private-dummy auction may land on another matching
(tests/test_torch_auction.py)."""

import os

import msgpack
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import serialization

from tests.test_torch_trackers import BASE, feature_stream, run_both
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: autouse)
    narrow_w6_cfg, one_torch_thread, random_variables, sharpen_heads,
)
from yolov7_tracker_tpu.models.spec import parse_yaml_cfg
from yolov7_tracker_tpu.reid import dhn as jdhn
from yolov7_tracker_tpu.trackers import slab as JS
from yolov7_tracker_tpu.trackers.registry import build_tracker as j_build
from yolov7_tracker_tpu_torch.ops.assignment import masked_assignment
from yolov7_tracker_tpu_torch.reid import dhn as tdhn
from yolov7_tracker_tpu_torch.trackers import slab as TS
from yolov7_tracker_tpu_torch.trackers.registry import build_tracker as t_build
from yolov7_tracker_tpu_torch.utils import flax_msgpack

GRU = "weights/dhn_h32.msgpack"
SKH = "weights/dhn_sinkhorn.msgpack"
HEADS = {"none": {},
         "gru_h32": dict(dhn_weights=GRU, dhn_hidden=32),
         "sinkhorn": dict(dhn_weights=SKH, dhn_arch="sinkhorn")}


def _assert_tree_equal(got, want, where="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, where


# ---------------------------------------------------------------------------
# the Flax-msgpack reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", [GRU, SKH])
def test_reader_matches_flax_on_the_weight_files(path):
    with open(path, "rb") as f:
        data = f.read()
    _assert_tree_equal(flax_msgpack.loads(data),
                       serialization.msgpack_restore(data))
    assert flax_msgpack.load_variables(path).keys() == {"params"}


def test_reader_matches_flax_on_mixed_dtypes():
    """Arrays of every width and kind, empty and 0-d arrays, a buffer past
    64 KiB (bin 32, ext 32), and the plain values to_bytes passes
    through."""
    rng = np.random.default_rng(0)
    tree = {
        "i8": np.arange(-6, 6, dtype=np.int8).reshape(3, 4),
        "u16": rng.integers(0, 2 ** 16, (5,)).astype(np.uint16),
        "i64": np.array([-2 ** 40, 7], np.int64),
        "f16": rng.standard_normal((2, 3)).astype(np.float16),
        "f64": rng.standard_normal((4,)),
        "flag": np.array([True, False, True]),
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.array(3.5, np.float32),
        "big": rng.standard_normal((130, 130)).astype(np.float32),
        "nested": {"a": {"b": np.ones((1, 1, 2), np.uint8)}},
        "none": None, "yes": True, "no": False, "small": 5, "neg": -3,
        "wide": 2 ** 40, "minus_wide": -2 ** 33, "frac": 0.25,
        "text": "x" * 300,
    }
    data = serialization.to_bytes(tree)
    _assert_tree_equal(flax_msgpack.loads(data),
                       serialization.msgpack_restore(data))


def test_reader_matches_msgpack_on_plain_values():
    """Every container and scalar width msgpack writes (fix / 8 / 16 / 32
    headers), without the ndarray ext."""
    value = {
        "fixmap": {str(i): i for i in range(3)},
        "map16": {str(i): -i for i in range(20)},
        "array16": list(range(-40, 40)),
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32,
                 -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 62],
        "floats": [0.5, -1e300],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 70000],
        "bins": [b"", b"\x00" * 300, b"\x01" * 70000],
        "other": [None, True, False],
    }
    data = msgpack.packb(value, use_bin_type=True)
    assert flax_msgpack.loads(data) == msgpack.unpackb(data, raw=False)


def test_reader_refuses_other_ext_types_and_bad_data():
    data = serialization.to_bytes({"s": np.float32(1.5)})   # npscalar ext
    with pytest.raises(ValueError, match="ext type"):
        flax_msgpack.loads(data)
    good = serialization.to_bytes({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(good[:-1])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.loads(good + b"\x00")


# ---------------------------------------------------------------------------
# the DHN heads
# ---------------------------------------------------------------------------

def _variables(arch, source, tmp_path):
    """(numpy variables, msgpack path): the repo's trained file, or the JAX
    module's own seeded init written with flax.serialization."""
    if source == "trained":
        path = GRU if arch == "gru" else SKH
        with open(path, "rb") as f:
            return serialization.msgpack_restore(f.read()), path, \
                (32 if arch == "gru" else 0)
    hidden = 8
    v = jdhn.build_dhn(arch, hidden).init(jax.random.PRNGKey(3),
                                          jnp.zeros((3, 4)))
    v = jax.tree.map(np.asarray, v)
    path = str(tmp_path / f"{arch}.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(v))
    return v, path, hidden


@pytest.mark.parametrize("arch,source", [("gru", "trained"),
                                         ("gru", "seeded"),
                                         ("sinkhorn", "trained"),
                                         ("sinkhorn", "seeded")])
def test_dhn_matches_jax(arch, source, tmp_path):
    """Scores on one cost and on a stack of three (the port's batch against
    jax.vmap), within 1e-5."""
    variables, path, hidden = _variables(arch, source, tmp_path)
    model = jdhn.build_dhn(arch, hidden or jdhn.HIDDEN)
    apply = jax.jit(lambda d: model.apply(variables, d))
    port = tdhn.load_dhn(path, arch, hidden or tdhn.HIDDEN)
    rng = np.random.default_rng(1)
    one = rng.uniform(0, 1, (9, 7)).astype(np.float32)
    many = rng.uniform(0, 1, (3, 6, 5)).astype(np.float32)
    want_one = np.asarray(apply(jnp.asarray(one)))
    want_many = np.asarray(jax.vmap(apply)(jnp.asarray(many)))
    with torch.no_grad():
        got_one = port(torch.from_numpy(one)).numpy()
        got_many = port(torch.from_numpy(many)).numpy()
    assert want_one.std() > 1e-4         # not a constant output
    np.testing.assert_allclose(got_one, want_one, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_many, want_many, atol=1e-5, rtol=0)


def test_dhn_file_must_fit_the_architecture():
    with pytest.raises(RuntimeError, match="size mismatch"):
        tdhn.load_dhn(GRU, "gru", 16)
    with pytest.raises(KeyError):
        tdhn.load_dhn(GRU, "sinkhorn")
    with pytest.raises(FileNotFoundError):
        tdhn.load_dhn("weights/no_such_dhn.msgpack", "gru", 32)
    with pytest.raises(ValueError, match="unknown dhn arch"):
        tdhn.build_dhn("lstm")


def _masks(rng, n, m):
    return rng.random(n) < 0.6, rng.random(m) < 0.5


@pytest.mark.parametrize("keyed", [False, True])
def test_compact_cost_matches_jax(keyed):
    rng = np.random.default_rng(2 + keyed)
    n, m, s = 11, 7, 3
    cost = rng.uniform(0, 1, (s, n, m)).astype(np.float32)
    rows, cols = zip(*(_masks(rng, n, m) for _ in range(s)))
    rows, cols = np.stack(rows), np.stack(cols)
    key = np.stack([rng.permutation(n) for _ in range(s)]).astype(np.int32)

    def jax_compact(c, r, k, key_):
        out = jdhn.compact_cost(c, r, k, row_key=key_ if keyed else None)
        return out + (jdhn.uncompact(out[0] * 2.0, out[1], out[2]),)

    t_key = torch.from_numpy(key) if keyed else None
    for i in range(s):                    # one problem at a time
        want = jax_compact(*(jnp.asarray(x[i]) for x in
                             (cost, rows, cols, key)))
        got = tdhn.compact_cost(torch.from_numpy(cost[i]),
                                torch.from_numpy(rows[i]),
                                torch.from_numpy(cols[i]),
                                row_key=t_key[i] if keyed else None)
        got = got + (tdhn.uncompact(got[0] * 2.0, got[1], got[2]),)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a stream axis: each stream compacted on its own, as under jax.vmap
    want = jax.vmap(jax_compact)(*(jnp.asarray(x) for x in
                                   (cost, rows, cols, key)))
    got = tdhn.compact_cost(torch.from_numpy(cost), torch.from_numpy(rows),
                            torch.from_numpy(cols), row_key=t_key)
    got = got + (tdhn.uncompact(got[0] * 2.0, got[1], got[2]),)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[3].numpy(), np.where(
        rows[:, :, None] & cols[:, None, :], cost * 2.0, got[3].numpy()))


# ---------------------------------------------------------------------------
# the deepmot step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head", sorted(HEADS))
def test_deepmot_step_matches_jax(head):
    kw = {**BASE, "tracker": "deepmot", "track_buffer": 6, **HEADS[head]}
    n_rows, slab = run_both(kw, feature_stream(3, n_frames=20, n_obj=14),
                            check_features=False,
                            solve_stage1=masked_assignment)
    assert n_rows > 150 and int(slab.next_id) > 14


def test_deepmot_streams_match_the_vmapped_jax_step():
    """Three streams stacked in one port step (the DHN batched over them,
    stage 1 by the batched square auction) against jax.vmap of the JAX
    step."""
    s, n_ticks = 3, 14
    kw = {**BASE, "tracker": "deepmot", "track_buffer": 6, **HEADS["gru_h32"]}
    streams = [feature_stream(seed, n_frames=n_ticks, n_obj=8 + 2 * seed)
               for seed in range(s)]
    tlbr, score, valid = (np.stack([np.stack([st[t][k] for st in streams])
                                    for t in range(n_ticks)])
                          for k in range(3))
    t_step, t_cfg = t_build(TS.TrackerConfig(**kw))
    j_step, j_cfg = j_build(JS.TrackerConfig(**kw))
    assert vars(t_cfg) == vars(j_cfg)
    t_slabs = TS.TrackSlab(*(x[None].repeat((s,) + (1,) * x.dim())
                             for x in TS.init_slab(t_cfg, "cpu")))
    j_slabs = jax.tree.map(lambda x: jnp.tile(x[None], (s,) + (1,) * x.ndim),
                           JS.init_slab(j_cfg))
    j_vstep = jax.jit(jax.vmap(j_step))
    d = tlbr.shape[2]
    rows = 0
    for t in range(n_ticks):
        t_slabs, t_out = t_step(t_slabs, TS.DetSlab(
            torch.from_numpy(tlbr[t]), torch.from_numpy(score[t]),
            torch.zeros((s, d)), torch.from_numpy(valid[t]),
            torch.zeros((s, d, 0))), solve_stage1=masked_assignment)
        j_slabs, j_out = j_vstep(j_slabs, JS.DetSlab(
            jnp.asarray(tlbr[t]), jnp.asarray(score[t]), jnp.zeros((s, d)),
            jnp.asarray(valid[t]), jnp.zeros((s, d, 0)),
            jnp.tile(JS.IDENTITY_WARP, (s, 1, 1))))
        tv = t_out.valid.numpy()
        np.testing.assert_array_equal(tv, np.asarray(j_out.valid))
        np.testing.assert_array_equal(t_out.track_id.numpy()[tv],
                                      np.asarray(j_out.track_id)[tv])
        np.testing.assert_allclose(t_out.tlwh.numpy()[tv],
                                   np.asarray(j_out.tlwh)[tv], atol=1e-4,
                                   rtol=0)
        for name in ("state", "track_id", "occupied", "ins_seq", "lost_seq",
                     "next_id"):
            np.testing.assert_array_equal(
                getattr(t_slabs, name).numpy(),
                np.asarray(getattr(j_slabs, name)), err_msg=f"{t} {name}")
        rows += int(tv.sum())
    assert rows > 200


# ---------------------------------------------------------------------------
# --tracker deepmot through the CLI
# ---------------------------------------------------------------------------

PIPE = dict(model="yolov7-w6", nc=8, img_size=128, detector_batch=3,
            dtype="float32", max_det=64)


def _sequence(tmp_path, n=9):
    """Bright blocks on a dark background, moving 3 px a frame, as PNGs of
    a one-sequence dataset; returns (config dir, the frames)."""
    import cv2

    rng = np.random.default_rng(0)
    base = rng.integers(0, 96, (96, 160, 3), np.uint8)
    for _ in range(6):
        y, x = rng.integers(0, 72), rng.integers(0, 136)
        base[y:y + 24, x:x + 24] = rng.integers(150, 255, 3)
    seq_dir = tmp_path / "data" / "images" / "test" / "SYN-01" / "img1"
    seq_dir.mkdir(parents=True)
    frames = [np.ascontiguousarray(np.roll(base, 3 * t, axis=1))
              for t in range(n)]
    for t, f in enumerate(frames):
        cv2.imwrite(str(seq_dir / f"{t + 1:06d}.png"), f)
    cfg_dir = tmp_path / "configs"
    cfg_dir.mkdir()
    with open(cfg_dir / "synth.yaml", "w") as fh:
        yaml.safe_dump({"DATASET_ROOT": str(tmp_path / "data")}, fh)
    return cfg_dir, frames


@pytest.mark.parametrize("head", ["gru_h32", "sinkhorn"])
def test_track_cli_deepmot_matches_jax_pipeline(head, tmp_path, monkeypatch):
    from yolov7_tracker_tpu.pipeline import PipelineConfig as JPipelineConfig
    from yolov7_tracker_tpu.pipeline import TrackingPipeline as JPipeline
    from yolov7_tracker_tpu_torch.cli import track
    from yolov7_tracker_tpu_torch.models import spec as tspec
    from yolov7_tracker_tpu_torch.models.from_jax import (
        jax_variables_to_torch,
    )
    from yolov7_tracker_tpu_torch.trackers import deepmot

    monkeypatch.setattr(deepmot, "solve_assignment", masked_assignment)
    cfg_dir, frames = _sequence(tmp_path)
    spec = parse_yaml_cfg(narrow_w6_cfg())
    weights = sharpen_heads(random_variables(spec, seed=1), spec,
                            obj_boost=7.0, levels=(0,))
    model_yaml = tmp_path / "w6n.yaml"
    with open(model_yaml, "w") as fh:
        yaml.safe_dump(narrow_w6_cfg(), fh)
    sd_path = tmp_path / "w6n.pt"
    torch.save(jax_variables_to_torch(
        weights, tspec.parse_yaml_cfg(narrow_w6_cfg())), sd_path)
    dhn = HEADS[head]
    flags = ["--dhn_path", dhn["dhn_weights"]] + (
        ["--dhn_hidden", "32"] if head == "gru_h32" else
        ["--dhn_arch", "sinkhorn"])
    folder = track.main([
        "--dataset", "synth", "--config_dir", str(cfg_dir),
        "--tracker", "deepmot", *flags,
        "--model", str(model_yaml), "--model_path", str(sd_path),
        "--nc", "8", "--img_size", "128", "--conf_thresh", "0.55",
        "--track_buffer", "3",
        "--detector_batch", "3", "--capacity", "32", "--det_capacity", "32",
        "--dtype", "float32", "--track_eval", "false", "--device", "cpu",
        "--output_dir", str(tmp_path / "out")])
    with open(os.path.join(folder, "SYN-01.txt")) as fh:
        got = [r.split(",") for r in fh.read().splitlines()]

    jpipe = JPipeline(
        JPipelineConfig(wpack=False, **PIPE),
        JS.TrackerConfig(tracker="deepmot", conf_thresh=0.55, track_buffer=3,
                         capacity=32, det_capacity=32, **dhn),
        variables=jax.tree.map(jnp.asarray, weights), spec=spec)
    want = [(fid, tid, *t) for fid, ids, tlwhs, _ in
            jpipe.run_sequence(iter(frames)) for tid, t in zip(ids, tlwhs)]
    assert len(got) == len(want)
    assert len({r[0] for r in want}) >= 4 and len({r[1] for r in want}) >= 2
    for g, w in zip(got, want):
        assert (int(g[0]), int(g[1])) == (w[0], w[1])
        np.testing.assert_allclose([float(x) for x in g[2:6]], w[2:6],
                                   atol=0.011)


# ---------------------------------------------------------------------------
# chip_smoke's checks of deepmot's DHN and of the paths' own solves
# ---------------------------------------------------------------------------

def _recorded_deepmot_run(n_frames=8):
    """deepmot (GRU h32) stepped on the CPU as chip_smoke's tracker_run
    steps it on the card, its DHN's inputs and outputs kept
    (chip_smoke.recording_dhn). Returns (pipe stand-in, dets, slabs before
    each step, results, kept)."""
    import types

    import chip_smoke

    kw = {**BASE, "tracker": "deepmot", "track_buffer": 6, **HEADS["gru_h32"]}
    step, cfg = t_build(TS.TrackerConfig(**kw))
    pipe = types.SimpleNamespace(step=step, tcfg=TS.TrackerConfig(**kw))
    kept = chip_smoke.recording_dhn(pipe)
    slab, dets, slabs, results = TS.init_slab(cfg, "cpu"), [], [], []
    for k, (tlbr, score, valid, _, _) in enumerate(
            feature_stream(3, n_frames=n_frames, n_obj=14)):
        det = TS.make_det_slab(cfg, tlbr, score, np.zeros_like(score), valid,
                               "cpu")
        dets.append(det)
        slabs.append(slab)
        slab, out = pipe.step(slab, det)
        v = out.valid.numpy()
        results.append((k + 1, out.track_id.numpy()[v].tolist(),
                        out.tlwh.numpy()[v].tolist(), None))
    return pipe, dets, slabs, results, kept


def test_chip_smoke_dhn_replay_holds_the_dhn_on_the_kept_costs():
    """The CPU replay of deepmot on the DHN scores a run kept holds the ids
    and boxes, runs the CPU DHN on every kept compacted cost (equal here,
    both on the CPU) and counts no pairing change; a kept score moved past
    DHN_SCORE_TOL fails the check."""
    import chip_smoke

    pipe, dets, slabs, results, kept = _recorded_deepmot_run()
    assert len(kept) == len(dets)
    assert all(c.shape == s.shape == (pipe.step.keywords["cfg"].capacity,
                                      pipe.step.keywords["cfg"].det_capacity)
               for c, s in kept)
    report = chip_smoke.replay_on_cpu(pipe, dets, slabs, results, "deepmot",
                                      kept)
    assert report == {"max_abs_diff": 0.0, "frames": len(dets),
                      "pairing_differs": []}
    comp, scores = kept[-1]
    moved = scores.clone()
    moved[0, 0] += 2 * chip_smoke.DHN_SCORE_TOL
    with pytest.raises(AssertionError, match="max .score difference"):
        chip_smoke.dhn_scores_check(t_build(pipe.tcfg)[0].keywords["dhn"],
                                    comp, moved)


def test_chip_smoke_path_solves_keeps_the_newest_problems():
    """path_solves keeps the last stage-1 problem and the last k K2
    problems that the steps hand the solvers, as clones, and puts the
    solvers back."""
    import chip_smoke
    from yolov7_tracker_tpu_torch.ops import assignment

    solvers = (assignment.masked_assignment_square,
               assignment.masked_assignment_auction)
    kw = {**BASE, "tracker": "strongsort", "feature_dim": 24}
    step, cfg = t_build(TS.TrackerConfig(**kw))
    slab = TS.init_slab(cfg, "cpu")
    with chip_smoke.path_solves(2) as kept:
        for tlbr, score, valid, feature, _ in feature_stream(5, n_frames=4):
            slab, _ = step(slab, TS.make_det_slab(
                cfg, tlbr, score, np.zeros_like(score), valid, "cpu",
                feature=feature), solve_stage1=masked_assignment)
    assert (assignment.masked_assignment_square,
            assignment.masked_assignment_auction) == solvers
    assert len(kept["square"]) == 1 and len(kept["k2"]) == 2
    (cost, rm, cm, th, kw1), = kept["square"]
    assert cost.shape == (cfg.capacity, cfg.det_capacity) and th == 0.7
    assert kw1 == {"n_phases": assignment.DEFAULT_PHASES}
    assert [p[3] for p in kept["k2"]] == [0.5, 0.7]
    r2c, _ = masked_assignment(cost, rm, cm, th)
    assert bool((r2c >= 0).any())
