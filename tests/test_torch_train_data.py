"""The port's training data pipeline and detection metrics
(yolov7_tracker_tpu_torch/train/datasets.py, train/metrics.py) against
the JAX package's: from one seed both YoloDatasets yield byte-equal
batches (mosaic / mosaic9 / mixup / paste_in / HSV / perspective / flips,
quad and rect batches, weighted resampling), read each other's label
cache, and the metrics give equal results on seeded inputs. The images
are written with cv2, as tests/test_train_smoke.py writes them."""

import os
import random

import numpy as np
import pytest

from yolov7_tracker_tpu.train import datasets as jds
from yolov7_tracker_tpu.train import metrics as jmet
from yolov7_tracker_tpu_torch.train import datasets as tds
from yolov7_tracker_tpu_torch.train import metrics as tmet

AUG = dict(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, degrees=10.0, translate=0.2,
           scale=0.5, shear=2.0, perspective=0.0005, fliplr=0.5, flipud=0.3,
           mosaic=1.0, mixup=0.5, paste_in=0.5)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """10 images of four sizes (two aspect ratios each way) with 1-4
    labelled filled rectangles, and one without a label file."""
    import cv2

    root = tmp_path_factory.mktemp("ds")
    img_dir = root / "images" / "train"
    lab_dir = root / "labels" / "train"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    sizes = [(96, 96), (64, 128), (128, 80), (72, 96)]
    for i in range(10):
        h, w = sizes[i % len(sizes)]
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        rows = []
        for _ in range(int(rng.integers(1, 5))):
            cx, cy = rng.uniform(0.25, 0.75, 2)
            bw, bh = rng.uniform(0.15, 0.45, 2)
            cv2.rectangle(img, (int((cx - bw / 2) * w),
                                int((cy - bh / 2) * h)),
                          (int((cx + bw / 2) * w), int((cy + bh / 2) * h)),
                          [int(c) for c in rng.integers(0, 255, 3)], -1)
            rows.append(f"{int(rng.integers(0, 3))} {cx:.4f} {cy:.4f} "
                        f"{bw:.4f} {bh:.4f}")
        cv2.imwrite(str(img_dir / f"{i:03d}.jpg"), img)
        if i != 9:
            (lab_dir / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    return str(img_dir)


def _pair(image_dir, seed=0, augment=True, img=64, **aug):
    hyp = dict(AUG, **aug)
    j = jds.YoloDataset(image_dir, img_size=img, hyp=jds.AugHyp(**hyp),
                        augment=augment, max_labels=16,
                        rng=random.Random(seed))
    t = tds.YoloDataset(image_dir, img_size=img, hyp=tds.AugHyp(**hyp),
                        augment=augment, max_labels=16,
                        rng=random.Random(seed))
    return j, t


def _same_batches(j_iter, t_iter, seed):
    """Draw both iterators under the same global numpy seed (mixup's
    np.random.beta) and compare every batch byte for byte."""
    n = 0
    np.random.seed(seed)
    want = list(j_iter)
    np.random.seed(seed)
    got = list(t_iter)
    assert len(got) == len(want) > 0
    for (ji, jt, jm), (ti, tt, tm) in zip(want, got):
        assert ji.dtype == ti.dtype and ji.shape == ti.shape
        assert ji.tobytes() == ti.tobytes()
        assert jt.tobytes() == tt.tobytes()
        assert jm.tobytes() == tm.tobytes()
        n += int(tm.sum())
    assert n > 0
    return got


@pytest.mark.parametrize("seed", [0, 1])
def test_augmented_batches_are_byte_equal(image_dir, seed):
    j, t = _pair(image_dir, seed)
    _same_batches(j.batches(3, epochs=2), t.batches(3, epochs=2), seed)


def test_mosaic9_is_byte_equal(image_dir):
    j, t = _pair(image_dir, 3)
    for idx in (0, 4, 7):
        ji, jl = j._mosaic9(idx)
        ti, tl = t._mosaic9(idx)
        assert ji.tobytes() == ti.tobytes()
        np.testing.assert_array_equal(tl, jl)


def test_plain_and_quad_batches_are_byte_equal(image_dir):
    j, t = _pair(image_dir, 2, augment=False)
    _same_batches(j.batches(4, shuffle=False), t.batches(4, shuffle=False), 0)
    j, t = _pair(image_dir, 5)
    got = _same_batches(j.quad_batches(1, epochs=2),
                        t.quad_batches(1, epochs=2), 5)
    assert got[0][0].shape == (1, 128, 128, 3) and got[0][1].shape[1] == 64


def test_rect_batches_are_byte_equal(image_dir):
    j, t = _pair(image_dir, 0, augment=False, img=256)
    got = _same_batches(j.rect_batches(2), t.rect_batches(2), 0)
    assert len({b[0].shape for b in got}) > 1      # several canvases


def test_resample_by_weights_is_equal(image_dir):
    j, t = _pair(image_dir, 4)
    nc = 3
    for ds, mod in ((j, jds), (t, tds)):
        cw = mod.labels_to_class_weights(ds.labels, nc)
        cw = cw * (1 - np.array([0.2, 0.5, 0.9])) ** 2 / nc
        ds.resample_by_weights(mod.labels_to_image_weights(ds.labels, nc,
                                                            cw))
    assert t.indices == j.indices
    assert len(set(t.indices)) < len(t)
    _same_batches(j.batches(2), t.batches(2), 4)


def test_label_cache_round_trip(image_dir):
    """Each package reads the other's cache: the same .labels_<key>.npz
    next to the images; a changed label file changes the key."""
    t = tds.YoloDataset(image_dir, img_size=64)
    cache = [f for f in os.listdir(image_dir) if f.startswith(".labels_")]
    assert len(cache) == 1
    j = jds.YoloDataset(image_dir, img_size=64)
    assert len(t.labels) == len(j.labels) == 10
    for a, b in zip(t.labels, j.labels):
        np.testing.assert_array_equal(a, b)
    assert t.labels[9].shape == (0, 5)
    # the cached arrays are what a parse gives
    for f, lab in zip(t.files, t.labels):
        np.testing.assert_array_equal(
            lab, tds.load_labels(tds.img2label_path(f)))
    # a stale key reparses (and leaves a second cache file)
    lab_path = tds.img2label_path(t.files[0])
    st = os.stat(lab_path)
    os.utime(lab_path, (st.st_atime, st.st_mtime + 10))
    t2 = tds.YoloDataset(image_dir, img_size=64)
    j2 = jds.YoloDataset(image_dir, img_size=64)
    assert len([f for f in os.listdir(image_dir)
                if f.startswith(".labels_")]) == 2
    for a, b in zip(t2.labels, j2.labels):
        np.testing.assert_array_equal(a, b)


def test_perspective_cutout_paste_in_module_random(image_dir):
    """random_perspective without an rng falls back to the module-level
    ``random``, seeded alike; cutout and paste_in draw from their rng."""
    import cv2

    img = cv2.imread(os.path.join(image_dir, "001.jpg"))
    labels = np.array([[1, 10, 12, 60, 50], [2, 30, 20, 90, 60]], float)
    hyp = tds.AugHyp(degrees=15.0, shear=3.0, perspective=0.001)
    random.seed(11)
    ji, jl = jds.random_perspective(img, labels.copy(), jds.AugHyp(
        degrees=15.0, shear=3.0, perspective=0.001))
    random.seed(11)
    ti, tl = tds.random_perspective(img, labels.copy(), hyp)
    assert ji.tobytes() == ti.tobytes()
    np.testing.assert_array_equal(tl, jl)
    ji, jl = jds.cutout(img.copy(), labels.copy(), random.Random(3))
    ti, tl = tds.cutout(img.copy(), labels.copy(), random.Random(3))
    assert ji.tobytes() == ti.tobytes()
    np.testing.assert_array_equal(tl, jl)
    samples = [(img[5:25, 5:30].copy(), 1.0), (img[0:10, 0:12].copy(), 2.0)]
    ji, jl = jds.paste_in(img.copy(), labels.copy(), samples,
                          random.Random(8), probability=1.0)
    ti, tl = tds.paste_in(img.copy(), labels.copy(), samples,
                          random.Random(8), probability=1.0)
    assert ji.tobytes() == ti.tobytes()
    np.testing.assert_array_equal(tl, jl)
    w1 = np.random.default_rng(0).uniform(1, 50, (4, 6))
    np.testing.assert_array_equal(tds.box_candidates(w1[:4], w1[:4] * 1.1),
                                  jds.box_candidates(w1[:4], w1[:4] * 1.1))


def _det_case(rng, n_img=6, nc=4):
    """Per image: detections (n, 6) [xyxy, conf, cls] around labels
    (m, 5) [cls, xyxy], with misses, false positives and duplicates."""
    out = []
    for _ in range(n_img):
        m = int(rng.integers(1, 7))
        xy = rng.uniform(0, 80, (m, 2))
        wh = rng.uniform(8, 40, (m, 2))
        labels = np.concatenate([rng.integers(0, nc, (m, 1)), xy, xy + wh],
                                axis=1)
        keep = rng.uniform(0, 1, m) < 0.8
        det = labels[keep][:, [1, 2, 3, 4, 0]].copy()
        det[:, :4] += rng.normal(0, 3, (len(det), 4))
        det = np.concatenate([det[:, :4], rng.uniform(0.05, 1, (len(det), 1)),
                              det[:, 4:5]], axis=1)
        fp = np.concatenate([rng.uniform(0, 100, (3, 2)),
                             rng.uniform(100, 140, (3, 2)),
                             rng.uniform(0, 1, (3, 1)),
                             rng.integers(0, nc, (3, 1))], axis=1)
        det = np.concatenate([det, det[:1], fp])
        det[-4, 4] = det[0, 4]                     # a tied confidence
        out.append((det, labels))
    return out


def test_metrics_match_jax():
    rng = np.random.default_rng(9)
    cases = _det_case(rng)
    stats_j, stats_t = [], []
    cm_j, cm_t = jmet.ConfusionMatrix(nc=4), tmet.ConfusionMatrix(nc=4)
    for det, lab in cases:
        np.testing.assert_array_equal(tmet.box_iou_np(lab[:, 1:], det[:, :4]),
                                      jmet.box_iou_np(lab[:, 1:], det[:, :4]))
        cj = jmet.correctness_matrix(det, lab)
        ct = tmet.correctness_matrix(det, lab)
        np.testing.assert_array_equal(ct, cj)
        assert cj.any() and not cj.all()
        stats_j.append((cj, det[:, 4], det[:, 5], lab[:, 0]))
        stats_t.append((ct, det[:, 4], det[:, 5], lab[:, 0]))
        cm_j.process_batch(det, lab)
        cm_t.process_batch(det, lab)
    np.testing.assert_array_equal(cm_t.matrix, cm_j.matrix)
    cat = [np.concatenate([s[i] for s in stats_t]) for i in range(4)]
    for curves in (False, True):
        want = jmet.ap_per_class(*cat, return_curves=curves)
        got = tmet.ap_per_class(*cat, return_curves=curves)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    p, r, ap, f1, classes = tmet.ap_per_class(*cat)
    res = {"map50": float(ap[:, 0].mean()), "map": float(ap.mean())}
    assert 0 < res["map"] < res["map50"] < 1
    assert tmet.fitness(res) == jmet.fitness(res)
    np.testing.assert_array_equal(tmet.IOUV, jmet.IOUV)
    rec = np.sort(rng.uniform(0, 1, 20))
    prec = rng.uniform(0, 1, 20)
    assert tmet.compute_ap(rec, prec) == jmet.compute_ap(rec, prec)
