"""The port's copy of eval/ (yolov7_tracker_tpu_torch/eval) and its
cli/evaluate.py against the JAX package's, on the same seeded inputs:
every metric, every benchmark's table, the lite scorers (their known
defect included), RLE and the RobMOTS baselines. Both are numpy on the
host, so the tolerance is exact equality throughout."""

import json
import os

import numpy as np
import pytest

import chip_smoke
from tests.test_baselines import synth_dets
from tests.test_eval_metrics import _synth_tracks, synth_data
from tests.test_jandf import _synth_mask_data
from tests.test_kitti_reader import synth_kitti
from tests.test_readers import (synth_bdd, synth_burst, synth_davis,
                                synth_ht, synth_mots, synth_pp22,
                                synth_robmots, synth_tao, synth_tao_ow,
                                synth_ytvis)
from yolov7_tracker_tpu.cli import evaluate as j_evaluate
from yolov7_tracker_tpu.eval import baselines as j_baselines
from yolov7_tracker_tpu.eval import cocoeval_lite as j_coco
from yolov7_tracker_tpu.eval import evaluator as j_evaluator
from yolov7_tracker_tpu.eval import metrics as j_metrics
from yolov7_tracker_tpu.eval import motmetrics_lite as j_mml
from yolov7_tracker_tpu.eval import readers as j_readers
from yolov7_tracker_tpu.eval import rle as j_rle
from yolov7_tracker_tpu_torch.cli import evaluate as t_evaluate
from yolov7_tracker_tpu_torch.eval import baselines as t_baselines
from yolov7_tracker_tpu_torch.eval import cocoeval_lite as t_coco
from yolov7_tracker_tpu_torch.eval import evaluator as t_evaluator
from yolov7_tracker_tpu_torch.eval import metrics as t_metrics
from yolov7_tracker_tpu_torch.eval import motmetrics_lite as t_mml
from yolov7_tracker_tpu_torch.eval import readers as t_readers
from yolov7_tracker_tpu_torch.eval import rle as t_rle


def assert_same(a, b, path="result"):
    """Two nested results (dicts, lists, arrays, numbers) equal exactly,
    NaN equal to NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)) and not (
            a and isinstance(a[0], (int, float, np.number))):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, (str, bytes)) or a is None:
        assert a == b, path
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape, path
        if x.dtype.kind in "fc" or y.dtype.kind in "fc":
            assert np.array_equal(x.astype(np.float64), y.astype(np.float64),
                                  equal_nan=True), path
        else:
            assert np.array_equal(x, y), path


def _with_gt_dets(data, seed):
    rng = np.random.default_rng(seed)
    data["gt_dets"] = [
        np.column_stack([rng.uniform(0, 500, len(g)),
                         rng.uniform(0, 300, len(g)),
                         rng.uniform(20, 80, len(g)),
                         rng.uniform(40, 120, len(g))])
        for g in data["gt_ids"]]
    return data


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["hota", "clear", "identity", "count",
                                  "vace", "ideucl"])
@pytest.mark.parametrize("seed", range(2))
def test_sequence_metric_equals_jax(name, seed):
    data = _with_gt_dets(synth_data(seed), seed + 100)
    got = getattr(t_metrics, name)(data)
    assert got, name
    assert_same(got, getattr(j_metrics, name)(data), name)


def test_combine_sequences_equals_jax():
    per_seq = []
    for s in range(3):
        d = _with_gt_dets(synth_data(s), s + 100)
        per_seq.append({k: v for name in ("hota", "clear", "identity",
                                          "count", "vace", "ideucl")
                        for k, v in getattr(j_metrics, name)(d).items()})
    assert_same(t_metrics.combine_sequences(per_seq),
                j_metrics.combine_sequences(per_seq))


@pytest.mark.parametrize("seed", range(2))
def test_trackmap_equals_jax(seed):
    datas = [_synth_tracks(seed * 10 + k) for k in range(3)]
    got = [t_metrics.trackmap_sequence(d) for d in datas]
    want = [j_metrics.trackmap_sequence(d) for d in datas]
    assert_same(got, want)
    assert_same(t_metrics.trackmap_combine(got),
                j_metrics.trackmap_combine(want))


@pytest.mark.parametrize("seed", range(2))
def test_jandf_equals_jax(seed):
    data = _synth_mask_data(seed)
    got = t_metrics.jandf(data)
    assert np.isfinite(got["J&F"])
    assert_same(got, j_metrics.jandf(data))


# ---------------------------------------------------------------------------
# evaluate_benchmark on every benchmark's fixture
# ---------------------------------------------------------------------------

def write_mot_like(root, benchmark, seed=0, n_seqs=2, n_frames=30):
    """A seeded MOT17 or VisDrone ground truth (chip_smoke's pedestrian
    geometry, classes of the benchmark, some zero-marked rows) and a
    tracker's rows made from it (jitter, misses, an id switch, false
    positives). Returns the evaluate_benchmark arguments."""
    rng = np.random.default_rng(seed)
    classes = {"MOT17": [1, 1, 1, 1, 2, 7, 8, 12],
               "VisDrone": [1, 2, 3, 4, 5, 6, 9, 10, 0, 11]}[benchmark]
    gt_root = os.path.join(root, "gt")
    trk_root = os.path.join(root, "trackers")
    os.makedirs(trk_root, exist_ok=True)
    seqs = {}
    for s in range(n_seqs):
        seq = f"{benchmark}-{s:02d}"
        os.makedirs(os.path.join(gt_root, seq, "gt"))
        gt_rows, trk_rows = [], []
        tracks = chip_smoke.pedestrian_tracks(rng, n_frames, (540, 960),
                                              n_peds=(8, 12), crossings=2)
        for tid, (x0, y0, vx, vy, w, h, first, last, _) in enumerate(
                tracks, start=1):
            cls = int(rng.choice(classes))
            switch = int(rng.integers(first, last + 1))
            for f in range(int(first), int(last) + 1):
                x, y = x0 + vx * (f - first), y0 + vy * (f - first)
                mark = 0 if rng.uniform() < 0.05 else 1
                gt_rows.append(f"{f},{tid},{x:.2f},{y:.2f},{w:.2f},{h:.2f},"
                               f"{mark},{cls},1.0,0")
                if rng.uniform() < 0.1:
                    continue
                jx, jy = rng.normal(0, 2.0, 2)
                out_id = tid + (100 if tid % 3 == 0 and f >= switch else 0)
                trk_rows.append(f"{f},{out_id},{x + jx:.2f},{y + jy:.2f},"
                                f"{w:.2f},{h:.2f},1.0,{cls},-1,-1")
        for f in range(1, n_frames + 1):
            x, y = rng.uniform(0, 900, 2)
            trk_rows.append(f"{f},{500 + f % 4},{x:.2f},{y:.2f},40.00,"
                            f"97.56,0.5,{int(rng.choice(classes))},-1,-1")
        with open(os.path.join(gt_root, seq, "gt", "gt.txt"), "w") as fh:
            fh.write("\n".join(gt_rows) + "\n")
        with open(os.path.join(gt_root, seq, "seqinfo.ini"), "w") as fh:
            fh.write(f"[Sequence]\nname = {seq}\nseqLength = {n_frames}\n")
        with open(os.path.join(trk_root, f"{seq}.txt"), "w") as fh:
            fh.write("\n".join(trk_rows) + "\n")
        seqs[seq] = n_frames
    return dict(gt_folder=gt_root, results_folder=trk_root, seqs=seqs,
                benchmark=benchmark)


def _gt(root):
    return os.path.join(root, "gt")


def _trk(root):
    return os.path.join(root, "trackers", "ours", "data")


def _one(root, fixture, benchmark, **kw):
    seq, frames = fixture
    return dict(gt_folder=_gt(root), results_folder=_trk(root),
                seqs={seq: frames}, benchmark=benchmark, **kw)


def _robmots(root):
    synth_robmots(root)
    sub = os.path.join(root, "gt", "train", "mots_challenge")
    return dict(
        gt_folder=os.path.join(root, "gt"),
        results_folder=os.path.join(root, "trackers", "train", "ours"),
        seqs=j_readers.read_robmots_seqmap(os.path.join(sub, "seqmap.txt")),
        benchmark="RobMOTS", classes=["person", "car", "all"],
        gt_loc_format=os.path.join(sub, "data", "{seq}.txt"),
        result_loc_format=os.path.join("{results_folder}", "data",
                                       "mots_challenge", "{seq}.txt"),
        seq_meta_extra={"sub_benchmark": "mots_challenge",
                        "valid_class_ids": (1, 3, 16)})


BENCHMARK_FIXTURES = {
    "MOT17": lambda r: write_mot_like(r, "MOT17", seed=1),
    "VisDrone": lambda r: write_mot_like(r, "VisDrone", seed=2),
    "KITTI": lambda r: _one(r, synth_kitti(r, seed=1), "KITTI",
                            gt_loc_format="{gt_folder}/label_02/{seq}.txt"),
    "BDD100K": lambda r: _one(r, synth_bdd(r, seed=1), "BDD100K",
                              classes=["pedestrian", "car"],
                              gt_loc_format="{gt_folder}/{seq}.json"),
    "HT": lambda r: _one(r, synth_ht(r, seed=1), "HT"),
    "PersonPath22": lambda r: _one(r, synth_pp22(r, seed=1), "PersonPath22"),
    "MOTS": lambda r: _one(r, synth_mots(r, seed=3, classes=(2,) * 6),
                           "MOTS"),
    "DAVIS": lambda r: _one(r, synth_davis(r, seed=2), "DAVIS",
                            gt_loc_format="{gt_folder}/{seq}"),
    "TAO": lambda r: dict(gt_folder=_gt(r), results_folder=_trk(r),
                          seqs={s: 0 for s in synth_tao(r, seed=1)},
                          benchmark="TAO", classes=["person"],
                          gt_loc_format="{gt_folder}/tao_gt.json"),
    "TAO_OW": lambda r: dict(gt_folder=_gt(r), results_folder=_trk(r),
                             seqs={synth_tao_ow(r): 0}, benchmark="TAO_OW",
                             gt_loc_format="{gt_folder}/tao_gt.json"),
    "YouTubeVIS": lambda r: dict(
        gt_folder=os.path.join(r, "gtv", "youtube_vis_train_sub_split"),
        results_folder=os.path.join(r, "trk", "youtube_vis_train_sub_split",
                                    "ours", "data"),
        seqs=dict([synth_ytvis(r)]), benchmark="YouTubeVIS",
        classes=["person", "dog"], gt_loc_format="{gt_folder}/gt.json"),
    # BURST's class names come from TAO's category list, which
    # evaluate_benchmark does not take; its class-agnostic twin does
    # (test_burst_reader_equals_jax covers the class-aware reader)
    "BURST_OW": lambda r: dict(
        gt_folder=_gt(r), results_folder=_trk(r),
        seqs={s.replace("/", "-"): 0 for s in synth_burst(r, seed=2)},
        benchmark="BURST_OW", gt_loc_format="{gt_folder}/all_classes.json",
        result_loc_format="{results_folder}/results.json"),
    "RobMOTS": _robmots,
}


@pytest.mark.parametrize("benchmark", sorted(BENCHMARK_FIXTURES))
def test_evaluate_benchmark_equals_jax(benchmark, tmp_path):
    kw = BENCHMARK_FIXTURES[benchmark](str(tmp_path))
    out = {}
    for name, ev in (("jax", j_evaluator), ("port", t_evaluator)):
        folder = str(tmp_path / f"out_{name}")
        out[name] = ev.evaluate_benchmark(output_folder=folder, **kw)
        assert not os.path.isfile(os.path.join(folder, "error_log.txt"))
    assert_same(out["port"], out["jax"], benchmark)
    scored = [out["port"][c]["COMBINED_SEQ"] for c in out["port"]
              if c != "cls_comb_cls_av"]
    assert any(r["CLR_TP"] > 0 for r in scored), benchmark
    for f in sorted(os.listdir(tmp_path / "out_jax")):
        assert (tmp_path / "out_port" / f).read_bytes() == \
            (tmp_path / "out_jax" / f).read_bytes(), f
    classes = [c for c in out["port"] if c != "cls_comb_cls_av"]
    assert t_evaluator.render_table(out["port"], classes) == \
        j_evaluator.render_table(out["jax"], classes)


def test_burst_reader_equals_jax(tmp_path):
    """BURST class by class, with TAO-style categories for its ids."""
    root = str(tmp_path)
    seqs = synth_burst(root)
    cats = [{"id": c, "name": f"cat{c}"} for c in (4, 13, 20, 95)]
    gt_json = os.path.join(root, "gt", "all_classes.json")
    trk_json = os.path.join(_trk(root), "results.json")
    scored = 0
    for seq in seqs:
        seq = seq.replace("/", "-")
        got = t_readers.load_burst_seq(seq, gt_json, trk_json,
                                       categories=cats)
        want = j_readers.load_burst_seq(seq, gt_json, trk_json,
                                        categories=cats)
        for cls in ("cat4", "cat13"):
            pre_t = t_readers.preprocess_burst(got, cls)
            pre_j = j_readers.preprocess_burst(want, cls)
            assert_same(pre_t, pre_j, f"{seq}/{cls}")
            res = t_metrics.hota(pre_t)
            assert_same(res, j_metrics.hota(pre_j))
            assert_same(t_metrics.trackmap_sequence(pre_t),
                        j_metrics.trackmap_sequence(pre_j))
            scored += pre_t["num_gt_dets"]
    assert scored > 0


# ---------------------------------------------------------------------------
# cli/evaluate.py
# ---------------------------------------------------------------------------

def _cli_runs(tmp_path, argv):
    """Both CLIs with the same arguments, each into its own output
    folder; returns {name: {file: bytes}}."""
    got = {}
    for name, cli in (("jax", j_evaluate), ("port", t_evaluate)):
        out = tmp_path / f"cli_{name}"
        assert cli.main(argv + ["--output_folder", str(out)]) == 0
        got[name] = {f: (out / f).read_bytes()
                     for f in sorted(os.listdir(out))}
    return got


@pytest.mark.parametrize("how", ["seqinfo", "seqmap", "robmots"])
def test_evaluate_cli_writes_what_jax_writes(how, tmp_path):
    root = str(tmp_path)
    if how == "robmots":
        synth_robmots(root)
        argv = ["--benchmark", "RobMOTS", "--sub_benchmark",
                "mots_challenge", "--split", "train", "--gt_folder",
                os.path.join(root, "gt"), "--trackers_folder",
                os.path.join(root, "trackers", "train", "ours")]
    else:
        kw = write_mot_like(root, "MOT17", seed=3)
        argv = ["--benchmark", "MOT17", "--gt_folder", kw["gt_folder"],
                "--trackers_folder", kw["results_folder"]]
        if how == "seqmap":
            seqmap = tmp_path / "seqmap.txt"
            seqmap.write_text("name\n" + "".join(
                f"{s} {n}\n" for s, n in list(kw["seqs"].items())[:1]))
            argv += ["--seqmap", str(seqmap), "--metrics", "hota", "clear"]
    got = _cli_runs(tmp_path, argv)
    assert got["port"] == got["jax"]
    assert "summary.json" in got["port"]
    summary = json.loads(got["port"]["summary.json"])
    assert any(v.get("CLR_TP", 0) > 0 for v in summary.values())


def test_evaluate_cli_without_sequences_fails_like_jax(tmp_path, capsys):
    argv = ["--gt_folder", str(tmp_path), "--trackers_folder",
            str(tmp_path)]
    assert t_evaluate.main(argv) == j_evaluate.main(argv) == 2


# ---------------------------------------------------------------------------
# the lite scorers, RLE, baselines
# ---------------------------------------------------------------------------

def test_motmetrics_lite_equals_jax(tmp_path):
    kw = write_mot_like(str(tmp_path), "MOT17", seed=4)
    res = [os.path.join(kw["results_folder"], f"{s}.txt") for s in kw["seqs"]]
    gts = [os.path.join(kw["gt_folder"], s, "gt", "gt.txt")
           for s in kw["seqs"]]
    got = t_mml.evaluate_files(res, gts, ignore_classes=(2, 7))
    assert_same(got, j_mml.evaluate_files(res, gts, ignore_classes=(2, 7)))
    assert all(m["TP"] > 0 and m["IDSW"] > 0 for m in got.values())


def _coco_case(seed):
    rng = np.random.default_rng(seed)
    images = list(range(1, 7))
    anns, dets = [], []
    for img in images:
        for cat in (1, 2, 3):
            for _ in range(int(rng.integers(1, 5))):
                x, y = rng.uniform(0, 400, 2)
                w, h = rng.uniform(8, 200, 2)
                anns.append({"id": len(anns), "image_id": img,
                             "category_id": cat, "bbox": [x, y, w, h],
                             "iscrowd": int(rng.uniform() < 0.05)})
                if cat == 3:       # category 3: ground truth, no detection
                    continue
                if rng.uniform() < 0.85:
                    j = rng.normal(0, 4, 4)
                    dets.append({"image_id": img, "category_id": cat,
                                 "bbox": [x + j[0], y + j[1], w + j[2],
                                          h + j[3]],
                                 "score": float(rng.uniform(0.3, 1))})
            dets.append({"image_id": img, "category_id": 1,
                         "bbox": list(rng.uniform(0, 300, 4) + 10),
                         "score": float(rng.uniform(0, 0.6))})
    gt = {"images": [{"id": i} for i in images], "annotations": anns,
          "categories": [{"id": c} for c in (1, 2, 3)]}
    return gt, dets


@pytest.mark.parametrize("seed", range(2))
def test_cocoeval_lite_equals_jax_with_its_defect(seed, tmp_path):
    gt, dets = _coco_case(seed)
    got = t_coco.COCOevalLite(gt, dets).accumulate()
    want = j_coco.COCOevalLite(gt, dets).accumulate()
    assert_same(got.precision, want.precision)
    assert_same(got.recall, want.recall)
    assert_same(got.summarize(), want.summarize())
    # the JAX package's defect (cocoeval_lite.py:194), reproduced: the
    # buckets of category 3 have ground truth and no detection, and are
    # skipped (-1) instead of scoring recall 0
    assert (got.recall[:, 2] == -1).all()
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    (tmp_path / "dt.json").write_text(json.dumps(dets))
    args = (str(tmp_path / "gt.json"), str(tmp_path / "dt.json"))
    assert t_coco.evaluate_json(*args) == j_coco.evaluate_json(*args)


@pytest.mark.parametrize("seed", range(3))
def test_rle_round_trips_equal_jax(seed):
    rng = np.random.default_rng(seed)
    h, w = 37 + seed, 53
    masks = [(rng.uniform(size=(h, w)) < p).astype(np.uint8)
             for p in (0.0, 0.1, 0.5, 0.9)]
    masks.append(np.ones((h, w), np.uint8))
    rles = []
    for m in masks:
        r = t_rle.encode(m)
        assert r == j_rle.encode(m)
        np.testing.assert_array_equal(t_rle.decode(r), m)
        assert t_rle.area(r) == j_rle.area(r) == int(m.sum())
        assert_same(t_rle.to_bbox(r), j_rle.to_bbox(r))
        runs = t_rle.counts_to_runs(r)
        assert_same(runs, j_rle.counts_to_runs(r))
        assert t_rle.runs_to_counts(runs) == j_rle.runs_to_counts(runs)
        unc = {"size": [h, w], "counts": [int(x) for x in runs]}
        assert t_rle.fr_uncompressed(unc) == j_rle.fr_uncompressed(unc)
        rles.append(r)
    box = [3.5, 4.25, 20.0, 11.5]
    assert t_rle.from_bbox(box, h, w) == j_rle.from_bbox(box, h, w)
    for inter in (False, True):
        assert t_rle.merge(rles[1:4], intersect=inter) == \
            j_rle.merge(rles[1:4], intersect=inter)
    crowd = [0, 1, 0, 0, 1]
    assert_same(t_rle.iou(rles, rles, crowd), j_rle.iou(rles, rles, crowd))


def test_baselines_equal_jax(tmp_path):
    det_file = str(tmp_path / "dets.txt")
    synth_dets(det_file)
    t_data = t_baselines.load_robmots_dets(det_file)
    j_data = j_baselines.load_robmots_dets(det_file)
    assert_same(t_baselines.stp_track_sequence(t_data),
                j_baselines.stp_track_sequence(j_data))
    assert_same(t_baselines.thresholder_sequence(t_data, 0.5),
                j_baselines.thresholder_sequence(j_data, 0.5))
    assert_same(t_baselines.non_overlap_sequence(t_data),
                j_baselines.non_overlap_sequence(j_data))
    rows = t_baselines.stp_track_sequence(t_data)
    assert rows
    for b, name in ((t_baselines, "port"), (j_baselines, "jax")):
        b.write_rows(rows, str(tmp_path / f"{name}.txt"))
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    assert_same(t_baselines.pascal_colormap(), j_baselines.pascal_colormap())
