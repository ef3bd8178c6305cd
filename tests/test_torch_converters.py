"""The port's dataset converters (data/converters.py) against the JAX
package's: the synthetic VisDrone / MOT17 / UAVDT trees of
tests/test_converters.py (more rows, every filter), each converted by
both packages in its own copy; the label files, the image lists and the
write_split files are byte-equal."""

import configparser
import os

import cv2
import numpy as np
import pytest

from yolov7_tracker_tpu.data import converters as j_conv
from yolov7_tracker_tpu_torch.data import converters as t_conv


def _visdrone(root):
    split = "VisDrone2019-MOT-train"
    for seq, n in (("uav0001", 4), ("uav0002", 3)):
        d = root / split / "sequences" / seq
        d.mkdir(parents=True)
        for f in range(1, n + 1):
            cv2.imwrite(str(d / f"{f:07d}.jpg"),
                        np.zeros((100, 200, 3), np.uint8))
    (root / split / "annotations").mkdir(parents=True)
    rows = [
        "1,1,20,30,40,20,1,4,0,0",       # car
        "1,2,10,10,20,20,0,4,0,0",       # score 0: dropped
        "2,1,25,35,40,20,1,1,0,0",       # pedestrian
        "2,3,5,5,10,10,1,0,0,0",         # ignored region: dropped
        "3,4,190,90,30,30,1,11,0,0",     # other: dropped
        "3,5,-5,95,30,30,1,10,0,0",      # clamped at both edges
        "4,6,150,60,80,60,1,4,0,0",      # car past the right edge
    ]
    for seq in ("uav0001", "uav0002"):
        (root / split / "annotations" / f"{seq}.txt").write_text(
            "\n".join(rows) + "\n")
    return split


def _mot(root):
    for name, n in (("MOT17-02", 3), ("MOT17-04", 2)):
        seq = root / "train" / name
        (seq / "img1").mkdir(parents=True)
        (seq / "gt").mkdir(parents=True)
        for f in range(1, n + 1):
            cv2.imwrite(str(seq / "img1" / f"{f:06d}.jpg"),
                        np.zeros((80, 160, 3), np.uint8))
        ini = configparser.ConfigParser()
        ini["Sequence"] = {"imWidth": "160", "imHeight": "80",
                           "imDir": "img1", "seqLength": str(n), "name": name}
        with open(seq / "seqinfo.ini", "w") as f:
            ini.write(f)
        gt = ["1,1,10,10,30,20,1,1,0.9",     # kept
              "1,2,50,10,30,20,1,1,0.5",     # low visibility
              "2,1,12,11,30,20,1,2,0.9",     # not a pedestrian
              "2,3,150,70,30,20,1,1,1.0",    # clamped
              "3,4,5,5,10,10,0,1,1.0"]       # mark 0
        (seq / "gt" / "gt.txt").write_text("\n".join(gt) + "\n")
    (root / "train" / "MOT17-09").mkdir()    # no gt: skipped


def _uavdt(root):
    base = root / "UAV-benchmark-M"
    for name, inner in (("M0101", True), ("M0202", False)):
        seq = base / name
        img_dir = seq / "img1" if inner else seq
        img_dir.mkdir(parents=True, exist_ok=True)
        for f in range(1, 4):
            cv2.imwrite(str(img_dir / f"img{f:06d}.jpg"),
                        np.zeros((60, 90, 3), np.uint8))
        rows = ["1,1,10,10,20,20,1,1,1", "2,1,80,50,20,20,1,1,1",
                "3,2,0,0,5,5,1,1,1"]
        if inner:
            (seq / "gt").mkdir()
            (seq / "gt" / "gt_whole.txt").write_text("\n".join(rows) + "\n")
        else:
            (root / "GT").mkdir()
            (root / "GT" / f"{name}_gt_whole.txt").write_text(
                "\n".join(rows) + "\n")


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".txt"):
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = fh.read()
    return out


CASES = {
    "visdrone": (_visdrone, lambda m, r, s: m.convert_visdrone(str(r), s)),
    "visdrone_car_half": (_visdrone, lambda m, r, s: m.convert_visdrone(
        str(r), s, car_only=True, half=True)),
    "mot17": (_mot, lambda m, r, s: m.convert_mot(str(r), "train")),
    "mot17_vis": (_mot, lambda m, r, s: m.convert_mot(str(r), "train",
                                                      vis_thresh=0.4)),
    "uavdt": (_uavdt, lambda m, r, s: m.convert_uavdt(str(r))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_converters_write_jax_files(name, tmp_path):
    make, run = CASES[name]
    lists = {}
    for side, mod in (("jax", j_conv), ("port", t_conv)):
        root = tmp_path / side
        split = make(root)
        images = run(mod, root, split)
        lists[side] = [os.path.relpath(p, root) for p in images]
        mod.write_split(images, str(root / "splits" / "train.txt"))
    assert lists["port"] == lists["jax"] and lists["jax"]
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert any("labels" in k for k in want)
    for k in want:
        if k.startswith("splits"):   # absolute paths: the roots differ
            assert got[k].replace(b"/port/", b"/jax/") == want[k]
        else:
            assert got[k] == want[k], k
