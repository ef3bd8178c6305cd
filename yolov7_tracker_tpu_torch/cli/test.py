"""Detector mAP evaluation on the PyTorch port (port of
yolov7_tracker_tpu/cli/test.py; the reference's test.py surface).

Batched float32 forward of the unfused detector, the inference decode
and multi-label NMS on the device, then the host-side 101-point
interpolated AP (train/metrics.py). Runs on the GPU unless --device says
otherwise.

    python -m yolov7_tracker_tpu_torch.cli.test --model yolov7-tiny \
        --weights runs/train/<run>/best.pt --data data.yaml [--device cpu]

--save_json writes the JAX CLI's COCO-format file, with its defect kept
(canvas coordinates, sequential image ids; ROADMAP section 3).
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np


def evaluate_map(spec, variables, val, img: int = 640, batch: int = 8,
                 conf_thres: float = 0.001, iou_thres: float = 0.65,
                 max_labels: int = 128, save_json: str = "",
                 rect: bool = False, plots_dir: str = "",
                 device=None, dtype=None) -> Dict:
    """mAP of the detector ``variables`` (an unfused state_dict in the
    port's names, e.g. TrainState.ema_variables()) on ``val``: a path the
    YoloDataset reads, or a dataset object with ``batches(batch,
    shuffle=False)`` (and ``rect_batches`` for rect=True). The forward
    runs in float32 as in JAX, or in ``dtype`` (float64 holds the card
    against the CPU below float32's rounding); NMS takes float32."""
    import torch

    from .. import resolve_device
    from ..models.yolo import YoloV7, decode_levels
    from ..ops import nms as nms_mod
    from ..train.datasets import YoloDataset
    from ..train.metrics import ConfusionMatrix, ap_per_class, \
        correctness_matrix

    dev = resolve_device(device)
    dtype = dtype or torch.float32
    model = YoloV7(spec, fused=False)
    model.load_state_dict(variables)
    model = model.to(dev, dtype).eval()
    dataset = (YoloDataset(val, img_size=img, augment=False,
                           max_labels=max_labels)
               if isinstance(val, str) else val)

    @torch.no_grad()
    def forward(imgs):
        out = model(imgs)
        pred = out if spec.head_kind == "DetectV8" else decode_levels(
            out, spec)
        return nms_mod.nms(pred.float(), conf_thres, iou_thres,
                           multi_label=True, top_k=8192)

    stats = []
    json_dets = []
    img_id = 0
    cm = ConfusionMatrix(nc=spec.nc) if plots_dir else None
    # rect=True is the reference's aspect-ratio-bucketed val loading
    # (test.py:90 rect dataloader)
    it = (dataset.rect_batches(batch) if rect
          else dataset.batches(batch, shuffle=False))
    for imgs, tgts, masks in it:
        x = torch.from_numpy(np.ascontiguousarray(
            imgs[..., ::-1].astype(np.float32) / 255.0)).to(dev, dtype)
        dets, counts = forward(x)
        dets = dets.cpu().numpy()
        counts = counts.cpu().numpy()
        ih, iw = imgs.shape[1:3]
        for b in range(len(imgs)):
            d = dets[b][: counts[b]]
            lab = tgts[b][masks[b]]
            # labels to xyxy pixels (normalized to the batch canvas)
            if len(lab):
                l_xyxy = np.zeros((len(lab), 5))
                l_xyxy[:, 0] = lab[:, 0]
                cx, cy, w, h = (lab[:, 1] * iw, lab[:, 2] * ih,
                                lab[:, 3] * iw, lab[:, 4] * ih)
                l_xyxy[:, 1] = cx - w / 2
                l_xyxy[:, 2] = cy - h / 2
                l_xyxy[:, 3] = cx + w / 2
                l_xyxy[:, 4] = cy + h / 2
            else:
                l_xyxy = np.zeros((0, 5))
            correct = correctness_matrix(d, l_xyxy)
            stats.append((correct, d[:, 4], d[:, 5], l_xyxy[:, 0]))
            if cm is not None:
                cm.process_batch(d, l_xyxy)
            if save_json:
                # COCO-format detections (test.py:173+ json path), as the
                # JAX CLI writes them
                img_id += 1
                for row in d:
                    json_dets.append({
                        "image_id": img_id,
                        "category_id": int(row[5]),
                        "bbox": [float(row[0]), float(row[1]),
                                 float(row[2] - row[0]),
                                 float(row[3] - row[1])],
                        "score": float(row[4]),
                    })
    if save_json:
        import json as _json

        with open(save_json, "w") as f:
            _json.dump(json_dets, f)
    if not stats:
        return {"map50": 0.0, "map": 0.0, "mp": 0.0, "mr": 0.0}
    tp = np.concatenate([s[0] for s in stats])
    conf = np.concatenate([s[1] for s in stats])
    pcls = np.concatenate([s[2] for s in stats])
    tcls = np.concatenate([s[3] for s in stats])
    if tp.size == 0 or len(tcls) == 0:
        return {"map50": 0.0, "map": 0.0, "mp": 0.0, "mr": 0.0}
    p, r, ap, f1, classes = ap_per_class(tp, conf, pcls, tcls)
    if plots_dir:
        import os

        from ..utils.logging import plot_confusion_matrix, plot_pr_curve

        pc, rc, *_ = ap_per_class(tp, conf, pcls, tcls, return_curves=True)
        os.makedirs(plots_dir, exist_ok=True)
        px = np.linspace(0, 1, 1000)
        # precision-vs-recall curves: (r, p) are parameterized by the
        # confidence grid; resample onto the recall grid per class
        py = [np.interp(px, rc[ci][::-1], pc[ci][::-1])
              for ci in range(len(classes))]
        plot_pr_curve(px, py, ap, os.path.join(plots_dir, "PR_curve.png"),
                      names=[str(c) for c in classes])
        plot_confusion_matrix(
            cm.matrix, os.path.join(plots_dir, "confusion_matrix.png"),
            names=[str(c) for c in range(spec.nc)],
        )
    return {
        "map50": float(ap[:, 0].mean()),
        "map": float(ap.mean()),
        "mp": float(p.mean()),
        "mr": float(r.mean()),
        "per_class_ap": {int(c): float(a) for c, a in
                         zip(classes, ap.mean(1))},
    }


def main(argv=None):
    import yaml

    p = argparse.ArgumentParser("torch yolov7 test")
    p.add_argument("--model", type=str, default="yolov7-tiny")
    p.add_argument("--weights", type=str, required=True,
                   help="detector weights: best.pt / last.pt of "
                        "cli.train, or any file cli.track's --model_path "
                        "takes but a pickled module")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--img", type=int, default=640)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--conf", type=float, default=0.001)
    p.add_argument("--iou", type=float, default=0.65)
    p.add_argument("--rect", action="store_true",
                   help="aspect-ratio-bucketed rectangular val batches")
    p.add_argument("--plots", type=str, default="",
                   help="directory for PR-curve + confusion-matrix pngs")
    p.add_argument("--save_json", type=str, default="",
                   help="write COCO-format detections json "
                        "(reference test.py --save-json)")
    p.add_argument("--coco_gt", type=str, default="",
                   help="COCO ground-truth json: score --save_json "
                        "in-process with eval/cocoeval_lite")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; refuses to run without a GPU) or "
                        "cpu")
    opts = p.parse_args(argv)
    from .. import resolve_device

    dev = resolve_device(opts.device)
    with open(opts.data) as f:
        data_cfg = yaml.safe_load(f)
    from ..models import zoo
    from ..models.convert import load_detector_weights

    spec = zoo.get_spec(opts.model, nc=int(data_cfg.get("nc", 80)))
    variables = load_detector_weights(opts.weights, spec)
    res = evaluate_map(spec, variables, data_cfg["val"], img=opts.img,
                       batch=opts.batch, conf_thres=opts.conf,
                       iou_thres=opts.iou, rect=opts.rect,
                       plots_dir=opts.plots, save_json=opts.save_json,
                       device=dev)
    if opts.save_json and opts.coco_gt:
        from ..eval.cocoeval_lite import evaluate_json

        res["coco"] = evaluate_json(opts.coco_gt, opts.save_json)
    print(res)
    return res


if __name__ == "__main__":
    main()
