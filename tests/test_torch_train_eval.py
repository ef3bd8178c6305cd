"""The port's detector test (yolov7_tracker_tpu_torch/cli/test.py) and its
multi-label NMS against the JAX package's: ``nms(..., multi_label=True)``
on seeded decoded rows with tied scores gives the same detections, and
``evaluate_map`` on converted weights (a narrow IDetect model with
sharpened heads, so that NMS keeps a real load) gives the same
detections and mAP within 1e-6, with square and rect batches and
--save_json."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import (narrow_idetect_cfg,  # noqa: F401
                                one_torch_thread, random_variables,
                                sharpen_heads)
from yolov7_tracker_tpu.cli import test as jtest
from yolov7_tracker_tpu.models.spec import parse_yaml_cfg as j_parse
from yolov7_tracker_tpu.ops import nms as jnms
from yolov7_tracker_tpu_torch.cli import test as ttest
from yolov7_tracker_tpu_torch.models.from_jax import jax_variables_to_torch
from yolov7_tracker_tpu_torch.models.spec import parse_yaml_cfg as t_parse
from yolov7_tracker_tpu_torch.ops import nms as tnms

MAP_TOL = 1e-6
BOX_TOL = 1e-3       # px, detections of a float32 forward in each package


def _rows(seed, b=2, n=300, nc=6):
    """Decoded rows (B, N, 5 + nc) [xywh, obj, cls]: clustered boxes, and
    every tenth row a copy of the row before (tied scores, one box)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(20, 200, (b, n, 2))
    wh = rng.uniform(8, 60, (b, n, 2))
    obj = rng.uniform(0, 1, (b, n, 1))
    cls = rng.uniform(0, 1, (b, n, nc)) ** 3
    p = np.concatenate([xy, wh, obj, cls], -1).astype(np.float32)
    p[:, 9::10] = p[:, 8::10]
    p[:, 5::10, 5:] = p[:, 5::10, 5:6]            # ties across classes
    return p


@pytest.mark.parametrize("seed,top_k", [(0, 4096), (1, 64)])
def test_multi_label_nms_matches_jax(seed, top_k):
    p = _rows(seed)
    for ml in (True, False):
        jd, jc = jnms.nms(jnp.asarray(p), 0.1, 0.45, multi_label=ml,
                          top_k=top_k)
        td, tc = tnms.nms(torch.tensor(p), 0.1, 0.45, multi_label=ml,
                          top_k=top_k)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        if ml:      # multi-label keeps several classes of one box
            d = td.numpy()[0][: int(tc[0])]
            assert len(np.unique(d[:, :4], axis=0)) < len(d)


@pytest.fixture(scope="module")
def weights():
    cfg = narrow_idetect_cfg()
    j_spec, t_spec = j_parse(cfg, name="idet"), t_parse(cfg, name="idet")
    variables = sharpen_heads(random_variables(j_spec), j_spec,
                              sharpen=2.0, obj_boost=2.0)
    return j_spec, t_spec, variables


def _dets(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def val_set(tmp_path_factory, weights):
    """8 val images of three sizes. Their labels are the JAX detector's
    own top detections (mapped back through the letterbox, jittered, one
    in three with another class) plus two boxes it did not find, so that
    the mAP is neither 0 nor 1."""
    import cv2

    root = tmp_path_factory.mktemp("val")
    img_dir = root / "images" / "val"
    lab_dir = root / "labels" / "val"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir(parents=True)
    rng = np.random.default_rng(5)
    sizes = [(128, 128), (64, 128), (128, 96)]
    for i in range(8):
        h, w = sizes[i % 3]
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        cv2.imwrite(str(img_dir / f"{i:03d}.png"), img)
    j_spec, _, variables = weights
    first = str(root / "first.json")
    jtest.evaluate_map(j_spec, jax.tree.map(jnp.asarray, variables),
                       str(img_dir), img=128, batch=2, save_json=first)
    dets = _dets(first)
    for i in range(8):
        h0, w0 = sizes[i % 3]
        r = 128 / max(h0, w0)
        h, w = int(h0 * r), int(w0 * r)
        dw, dh = (128 - w) // 2, (128 - h) // 2
        mine = sorted((d for d in dets if d["image_id"] == i + 1),
                      key=lambda d: -d["score"])[:6]
        rows = []
        for k, d in enumerate(mine):
            x, y, bw, bh = d["bbox"]
            cls = d["category_id"] if k % 3 else (d["category_id"] + 1) % 8
            cx = (x + bw / 2 - dw) / w + rng.normal(0, 0.01)
            cy = (y + bh / 2 - dh) / h + rng.normal(0, 0.01)
            rows.append(f"{cls} {cx:.4f} {cy:.4f} {bw / w:.4f} "
                        f"{bh / h:.4f}")
        rows += ["1 0.1 0.1 0.1 0.1", "2 0.9 0.85 0.15 0.2"]
        (lab_dir / f"{i:03d}.txt").write_text("\n".join(rows) + "\n")
    return str(img_dir)


@pytest.mark.parametrize("rect", [False, True])
def test_evaluate_map_matches_jax(val_set, weights, tmp_path, rect):
    """rect batches at 256 px, where the stride-64 canvases of the wide
    and tall images differ from the square one."""
    j_spec, t_spec, variables = weights
    img = 256 if rect else 128
    jjson, tjson = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    want = jtest.evaluate_map(j_spec, jax.tree.map(jnp.asarray, variables),
                              val_set, img=img, batch=2, rect=rect,
                              save_json=jjson)
    got = ttest.evaluate_map(t_spec, jax_variables_to_torch(variables,
                                                            t_spec),
                             val_set, img=img, batch=2, rect=rect,
                             save_json=tjson, device="cpu")
    for k in ("map50", "map", "mp", "mr"):
        assert abs(got[k] - want[k]) <= MAP_TOL, (k, got[k], want[k])
    assert got["per_class_ap"].keys() == want["per_class_ap"].keys()
    assert 0 < got["map"] < got["map50"] < 1
    jd, td = _dets(jjson), _dets(tjson)
    assert len(td) == len(jd) > 100
    for a, b in zip(td, jd):
        assert (a["image_id"], a["category_id"]) == (b["image_id"],
                                                     b["category_id"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=BOX_TOL)
        assert abs(a["score"] - b["score"]) <= 1e-5


def test_evaluate_map_plots_and_dataset_object(val_set, weights, tmp_path):
    """plots_dir writes the PR curve and the confusion matrix; a dataset
    object scores like its path."""
    from yolov7_tracker_tpu_torch.train.datasets import YoloDataset

    _, t_spec, variables = weights
    sd = jax_variables_to_torch(variables, t_spec)
    a = ttest.evaluate_map(t_spec, sd, val_set, img=128, batch=2,
                           plots_dir=str(tmp_path / "plots"), device="cpu")
    assert os.path.isfile(tmp_path / "plots" / "PR_curve.png")
    assert os.path.isfile(tmp_path / "plots" / "confusion_matrix.png")
    ds = YoloDataset(val_set, img_size=128, augment=False, max_labels=128)
    b = ttest.evaluate_map(t_spec, sd, ds, img=128, batch=2, device="cpu")
    assert a == b
