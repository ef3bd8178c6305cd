"""cli/detect.py in the port against the JAX package's: both mains on a
directory of seeded PNGs (64 to 160 px) with yolov7-tiny (nc 1, the JAX
package's msgpack weights, stride-8 head sharpened) print the same lines,
and each overlay image is byte-equal to JAX's wherever every box's
integer corners and label agree (checked on the two packages' own
detections); apply_classifier keeps what JAX's keeps for the same
classify_fn; --spatial_devices 2 (two CPU ranks, height-sharded) writes
what --spatial_devices 1 writes, and a frame too short for its ranks is
refused."""

import os

import cv2
import numpy as np
import pytest

from tests.test_torch_cli import (  # noqa: F401 (fixtures)
    jax_float32, tiny_msgpack, tiny_variables)
from tests.torch_parity import one_torch_thread  # noqa: F401 (autouse)
from yolov7_tracker_tpu import pipeline as j_pipeline
from yolov7_tracker_tpu.cli import detect as j_detect
from yolov7_tracker_tpu.trackers.slab import TrackerConfig as JTrackerConfig
from yolov7_tracker_tpu_torch.cli import detect as t_detect

SIZES = [(96, 160), (120, 100), (64, 128), (150, 150), (80, 120)]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("detect_src")
    rng = np.random.default_rng(0)
    for k, (h, w) in enumerate(SIZES):
        img = rng.integers(0, 96, (h, w, 3), np.uint8)
        for _ in range(4):
            y, x = rng.integers(0, h - 24), rng.integers(0, w - 24)
            img[y:y + 24, x:x + 24] = rng.integers(150, 255, 3)
        cv2.imwrite(str(root / f"img{k}.png"), img)
    return str(root)


def _lines(out, save_dir):
    return [line.replace(save_dir, "<dst>") for line in out.splitlines()
            if " detections -> " in line]


def _labels(boxes, scores, cls):
    return [(tuple(map(int, b)), f"{c}:{s:.2f}")
            for b, s, c in zip(boxes, scores, cls)]


def test_detect_main_equals_jax(images, tiny_variables, tiny_msgpack,
                                jax_float32, tmp_path, capsys):
    common = ["--source", images, "--model", "yolov7-tiny", "--nc", "1",
              "--img_size", "160", "--weights", tiny_msgpack,
              "--conf", "0.25"]
    j_dir, t_dir = str(tmp_path / "j"), str(tmp_path / "t")
    j_detect.main(common + ["--save_dir", j_dir])
    j_out = capsys.readouterr().out
    t_detect.main(common + ["--save_dir", t_dir, "--dtype", "float32",
                            "--device", "cpu"])
    t_out = capsys.readouterr().out
    assert _lines(t_out, t_dir) == _lines(j_out, j_dir)
    assert len(_lines(t_out, t_dir)) == len(SIZES)

    # each package's own detections, image by image
    j_pipe = j_pipeline.TrackingPipeline(
        j_pipeline.PipelineConfig(model="yolov7-tiny", nc=1, img_size=160,
                                  conf_thres=0.25, iou_thres=0.45,
                                  detector_batch=1),
        JTrackerConfig(), variables=tiny_variables)
    t_pipe = t_detect.build_pipeline(t_detect.parse_args(
        common + ["--dtype", "float32", "--device", "cpu"]))
    agreed = detected = 0
    for name in sorted(os.listdir(images)):
        img = cv2.imread(os.path.join(images, name))
        boxes, scores, cls, counts = j_pipe.detect_batch(img[None])
        n = int(counts[0])
        want = _labels(np.asarray(boxes[0][:n]), np.asarray(scores[0][:n]),
                       np.asarray(cls[0][:n]).astype(int))
        (b, s, c, m), = t_detect.detect_images(t_pipe, [img])
        assert m == n
        detected += n > 0
        if _labels(b, s, c) == want:
            agreed += 1
            with open(os.path.join(j_dir, name), "rb") as f1, \
                    open(os.path.join(t_dir, name), "rb") as f2:
                assert f1.read() == f2.read(), name
    assert detected >= 3 and agreed >= len(SIZES) - 1


def test_apply_classifier_equals_jax():
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 255, (120, 160, 3), np.uint8)
    x1 = rng.uniform(-20, 140, 12)
    y1 = rng.uniform(-20, 100, 12)
    dets = np.stack([x1, y1, x1 + rng.uniform(4, 60, 12),
                     y1 + rng.uniform(4, 60, 12), rng.uniform(0, 1, 12),
                     rng.integers(0, 3, 12)], axis=1).astype(np.float32)

    def classify(crops):
        assert crops.shape[1:] == (224, 224, 3)
        return (crops.reshape(len(crops), -1).mean(1) * 60).astype(int) % 3

    want = j_detect.apply_classifier(dets, frame, classify)
    got = t_detect.apply_classifier(dets, frame, classify)
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) < len(dets)
    assert len(t_detect.apply_classifier(dets[:0], frame, classify)) == 0


def test_spatial_devices_is_refused(images, tiny_msgpack, tmp_path,
                                    capfd):
    """--spatial_devices 2 with --device cpu height-shards each frame over
    two gloo ranks: the same printed lines and overlay bytes as one
    device. Refused: more ranks than the letterboxed frame has rows of
    the coarsest level (64 px: 2 rows of stride 32 for 3 ranks)."""
    common = ["--source", images, "--model", "yolov7-tiny", "--nc", "1",
              "--img_size", "160", "--weights", tiny_msgpack, "--conf",
              "0.25", "--dtype", "float32", "--device", "cpu"]
    out = {}
    for n in (1, 2):
        save = str(tmp_path / f"n{n}")
        t_detect.main(common + ["--save_dir", save, "--spatial_devices",
                                str(n)])
        out[n] = _lines(capfd.readouterr().out, save)
    assert out[2] == out[1] and len(out[1]) == len(SIZES)
    assert sum(int(line.split(": ")[1].split()[0]) for line in out[1]) > 0
    for name in sorted(os.listdir(images)):
        with open(tmp_path / "n1" / name, "rb") as f1, \
                open(tmp_path / "n2" / name, "rb") as f2:
            assert f1.read() == f2.read(), name
    with pytest.raises(Exception, match="H / max_stride"):
        t_detect.main(common[:7] + ["64"] + common[8:]
                      + ["--save_dir", str(tmp_path / "n3"),
                         "--spatial_devices", "3"])
