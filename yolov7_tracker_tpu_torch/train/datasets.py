"""Training data pipeline (port of yolov7_tracker_tpu/train/datasets.py,
a copy: host numpy / OpenCV code, nothing here touches the card).

YOLO-format datasets with mosaic / affine / HSV augmentation producing
fixed-shape padded batches, the host-side equivalent of
utils/datasets.py (LoadImagesAndLabels + LoadImagesAndLabelsCustom):
YOLO txt labels (cls cx cy w h normalized), label caching, mosaic-4
composition (:548-569), random_perspective affine with candidate
filtering (:1148-1230), HSV jitter (:814-830), horizontal flip, and
letterboxed rect loading for validation. The random streams are drawn in
the JAX module's order (``self.rng``, numpy's global ``np.random.beta``
for mixup, the ``random`` module where random_perspective gets no rng),
so one seed gives both packages byte-equal batches.

Every batch is (imgs uint8 (B, S, S, 3), targets (B, T, 5) [cls, cx, cy,
w, h] normalized, mask (B, T)): no ragged label lists, so the SimOTA loss
has static shapes.
"""

from __future__ import annotations

import dataclasses
import glob
import math
import os
import random
from typing import Iterator, Optional, Tuple

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


@dataclasses.dataclass
class AugHyp:
    """Augmentation hyperparameters (data/hyp.scratch.custom.yaml)."""

    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    degrees: float = 0.0
    translate: float = 0.2
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0
    fliplr: float = 0.5
    flipud: float = 0.0
    mosaic: float = 1.0
    mixup: float = 0.0
    paste_in: float = 0.0   # copy-paste prob (utils/datasets.py:604)


def img2label_path(img_path: str) -> str:
    sa, sb = os.sep + "images" + os.sep, os.sep + "labels" + os.sep
    return os.path.splitext(img_path.replace(sa, sb, 1))[0] + ".txt"


def load_labels(path: str) -> np.ndarray:
    """(N, 5) [cls, cx, cy, w, h] normalized, empty if missing."""
    if not os.path.isfile(path):
        return np.zeros((0, 5), np.float32)
    rows = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) >= 5:
                rows.append([float(x) for x in p[:5]])
    return np.asarray(rows, np.float32).reshape(-1, 5)


class YoloDataset:
    """Image list + cached labels, mosaic/affine/HSV augmentation."""

    def __init__(self, path_or_list, img_size: int = 640,
                 hyp: AugHyp = AugHyp(), augment: bool = True,
                 max_labels: int = 128, rng: Optional[random.Random] = None):
        if isinstance(path_or_list, str):
            if os.path.isdir(path_or_list):
                files = sorted(
                    p for p in glob.glob(
                        os.path.join(path_or_list, "**", "*.*"), recursive=True
                    )
                    if p.lower().endswith(IMG_EXTS)
                )
            else:  # txt list file
                with open(path_or_list) as f:
                    files = [l.strip() for l in f if l.strip()]
        else:
            files = list(path_or_list)
        assert files, f"no images found in {path_or_list}"
        self.files = files
        self.labels = self._load_labels_cached(files)
        self.img_size = img_size
        self.hyp = hyp
        self.augment = augment
        self.max_labels = max_labels
        self.rng = rng or random.Random(0)

    def __len__(self):
        return len(self.files)

    @staticmethod
    def _load_labels_cached(files):
        """Label cache (reference .cache files, utils/datasets.py:484-537):
        parsed labels persist next to the first image dir as an .npz
        keyed by a hash of paths+mtimes; a stale key reparses."""
        import hashlib

        label_paths = [img2label_path(p) for p in files]
        key_src = "".join(
            f"{p}{os.path.getmtime(p) if os.path.isfile(p) else 0}"
            for p in label_paths
        )
        key = hashlib.sha1(key_src.encode()).hexdigest()[:16]
        cache_path = os.path.join(
            os.path.dirname(files[0]), f".labels_{key}.npz"
        )
        if os.path.isfile(cache_path):
            try:
                z = np.load(cache_path, allow_pickle=False)
                return [z[f"l{i}"] for i in range(len(files))]
            except Exception:
                pass
        labels = [load_labels(p) for p in label_paths]
        try:
            np.savez_compressed(
                cache_path, **{f"l{i}": l for i, l in enumerate(labels)}
            )
        except OSError:
            pass  # read-only dataset dir: skip caching
        return labels

    # -- image io -----------------------------------------------------

    def _load_image(self, idx: int):
        import cv2

        img = cv2.imread(self.files[idx])
        assert img is not None, self.files[idx]
        h0, w0 = img.shape[:2]
        r = self.img_size / max(h0, w0)
        if r != 1:
            img = cv2.resize(
                img, (int(w0 * r), int(h0 * r)),
                interpolation=cv2.INTER_LINEAR,
            )
        return img, (h0, w0)

    def _sample_pool(self, n_min: int, max_tries: int = 8):
        """Object crops [(patch, cls), ...] harvested from random
        images for paste_in — the load_samples pool the reference
        fills to >=30 labels (utils/datasets.py:604-612). Stops after
        max_tries images so a sparsely-labeled dataset terminates."""
        samples = []
        for _ in range(max_tries):
            if len(samples) >= n_min:
                break
            j = self.rng.randrange(len(self))
            img, (h0, w0) = self._load_image(j)
            h, w = img.shape[:2]
            for lab in self.labels[j]:
                cls = lab[0]
                cx, cy, bw, bh = lab[1:5]
                x1 = int(max((cx - bw / 2) * w, 0))
                y1 = int(max((cy - bh / 2) * h, 0))
                x2 = int(min((cx + bw / 2) * w, w))
                y2 = int(min((cy + bh / 2) * h, h))
                if x2 - x1 >= 4 and y2 - y1 >= 4:
                    samples.append((img[y1:y2, x1:x2].copy(), cls))
        return samples

    # -- augmentation -------------------------------------------------

    def _mosaic(self, idx: int):
        """4-image mosaic (utils/datasets.py load_mosaic semantics)."""
        import cv2

        s = self.img_size
        yc = int(self.rng.uniform(s // 2, 2 * s - s // 2))
        xc = int(self.rng.uniform(s // 2, 2 * s - s // 2))
        idxs = [idx] + [self.rng.randrange(len(self)) for _ in range(3)]
        canvas = np.full((2 * s, 2 * s, 3), 114, np.uint8)
        labels4 = []
        for i, index in enumerate(idxs):
            img, _ = self._load_image(index)
            h, w = img.shape[:2]
            if i == 0:
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
                x2b, y2b = w, h
            elif i == 1:
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
                x1b, y1b = 0, h - (y2a - y1a)
                x2b, y2b = min(w, x2a - x1a), h
            elif i == 2:
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(2 * s, yc + h)
                x1b, y1b = w - (x2a - x1a), 0
                x2b, y2b = w, min(y2a - y1a, h)
            else:
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(2 * s, yc + h)
                x1b, y1b = 0, 0
                x2b, y2b = min(w, x2a - x1a), min(y2a - y1a, h)
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            padw, padh = x1a - x1b, y1a - y1b
            lab = self.labels[index].copy()
            if len(lab):
                xy = lab[:, 1:5].copy()
                lab[:, 1] = w * (xy[:, 0] - xy[:, 2] / 2) + padw
                lab[:, 2] = h * (xy[:, 1] - xy[:, 3] / 2) + padh
                lab[:, 3] = w * (xy[:, 0] + xy[:, 2] / 2) + padw
                lab[:, 4] = h * (xy[:, 1] + xy[:, 3] / 2) + padh
                labels4.append(lab)
        labels4 = (
            np.concatenate(labels4, 0) if labels4 else np.zeros((0, 5))
        )
        np.clip(labels4[:, 1:], 0, 2 * s, out=labels4[:, 1:])
        canvas, labels4 = random_perspective(
            canvas, labels4, self.hyp, border=(-s // 2, -s // 2),
            rng=self.rng,
        )
        return canvas, labels4

    def _mosaic9(self, idx: int):
        """9-image mosaic (utils/datasets.py:898-970): a 3s canvas tiled
        center/top/right/... by each image's own size chained off the
        previous tile, then a random 2s crop and the same border-(-s/2)
        perspective warp as mosaic4."""
        s = self.img_size
        idxs = [idx] + [self.rng.randrange(len(self)) for _ in range(8)]
        canvas = np.full((3 * s, 3 * s, 3), 114, np.uint8)
        labels9 = []
        h0 = w0 = hp = wp = 0
        for i, index in enumerate(idxs):
            img, _ = self._load_image(index)
            h, w = img.shape[:2]
            if i == 0:
                h0, w0 = h, w
                c = s, s, s + w, s + h
            elif i == 1:
                c = s, s - h, s + w, s
            elif i == 2:
                c = s + wp, s - h, s + wp + w, s
            elif i == 3:
                c = s + w0, s, s + w0 + w, s + h
            elif i == 4:
                c = s + w0, s + hp, s + w0 + w, s + hp + h
            elif i == 5:
                c = s + w0 - w, s + h0, s + w0, s + h0 + h
            elif i == 6:
                c = s + w0 - wp - w, s + h0, s + w0 - wp, s + h0 + h
            elif i == 7:
                c = s - w, s + h0 - h, s, s + h0
            else:
                c = s - w, s + h0 - hp - h, s, s + h0 - hp
            padx, pady = c[:2]
            x1, y1, x2, y2 = (max(v, 0) for v in c)
            canvas[y1:y2, x1:x2] = img[y1 - pady:, x1 - padx:][
                : y2 - y1, : x2 - x1
            ]
            hp, wp = h, w
            lab = self.labels[index].copy()
            if len(lab):
                xy = lab[:, 1:5].copy()
                lab[:, 1] = w * (xy[:, 0] - xy[:, 2] / 2) + padx
                lab[:, 2] = h * (xy[:, 1] - xy[:, 3] / 2) + pady
                lab[:, 3] = w * (xy[:, 0] + xy[:, 2] / 2) + padx
                lab[:, 4] = h * (xy[:, 1] + xy[:, 3] / 2) + pady
                labels9.append(lab)
        yc = int(self.rng.uniform(0, s))
        xc = int(self.rng.uniform(0, s))
        canvas = np.ascontiguousarray(canvas[yc:yc + 2 * s, xc:xc + 2 * s])
        labels9 = (
            np.concatenate(labels9, 0) if labels9 else np.zeros((0, 5))
        )
        if len(labels9):
            labels9[:, [1, 3]] -= xc
            labels9[:, [2, 4]] -= yc
            np.clip(labels9[:, 1:], 0, 2 * s, out=labels9[:, 1:])
        canvas, labels9 = random_perspective(
            canvas, labels9, self.hyp, border=(-s // 2, -s // 2),
            rng=self.rng,
        )
        return canvas, labels9

    def _plain(self, idx: int, out_shape: Optional[Tuple[int, int]] = None):
        """Letterboxed single image (val / no-mosaic path); labels xyxy.
        out_shape (th, tw) letterboxes into a rectangular canvas (the
        reference's rect=True val loading, utils/datasets.py:385-400)."""
        import cv2

        s = self.img_size
        img, _ = self._load_image(idx)
        h, w = img.shape[:2]
        th, tw = out_shape if out_shape is not None else (s, s)
        if h > th or w > tw:  # rect canvas smaller than cached resize
            r = min(th / h, tw / w)
            img = cv2.resize(img, (int(w * r), int(h * r)),
                             interpolation=cv2.INTER_LINEAR)
            h, w = img.shape[:2]
        canvas = np.full((th, tw, 3), 114, np.uint8)
        dw, dh = (tw - w) // 2, (th - h) // 2
        canvas[dh:dh + h, dw:dw + w] = img
        lab = self.labels[idx].copy()
        if len(lab):
            xy = lab[:, 1:5].copy()
            lab[:, 1] = w * (xy[:, 0] - xy[:, 2] / 2) + dw
            lab[:, 2] = h * (xy[:, 1] - xy[:, 3] / 2) + dh
            lab[:, 3] = w * (xy[:, 0] + xy[:, 2] / 2) + dw
            lab[:, 4] = h * (xy[:, 1] + xy[:, 3] / 2) + dh
        return canvas, lab

    def __getitem__(self, idx, out_shape: Optional[Tuple[int, int]] = None):
        """Returns (img uint8 (S, S, 3), targets (T, 5) normalized xywh,
        mask (T,)); out_shape selects a rectangular val canvas."""
        use_mosaic = self.augment and self.rng.random() < self.hyp.mosaic
        if use_mosaic:
            # 80/20 mosaic4/mosaic9 split (utils/datasets.py:553-558)
            mfn = (self._mosaic if self.rng.random() < 0.8
                   else self._mosaic9)
            img, labels = mfn(idx)
            if self.rng.random() < self.hyp.mixup:
                mfn2 = (self._mosaic if self.rng.random() < 0.8
                        else self._mosaic9)
                img2, labels2 = mfn2(self.rng.randrange(len(self)))
                r = np.random.beta(8.0, 8.0)
                img = (img * r + img2 * (1 - r)).astype(np.uint8)
                labels = np.concatenate([labels, labels2], 0)
        else:
            img, labels = self._plain(idx, out_shape)
            if self.augment:
                img, labels = random_perspective(
                    img, labels, self.hyp, border=(0, 0), rng=self.rng
                )
        if self.augment:
            img = augment_hsv(img, self.hyp, self.rng)
            if self.rng.random() < self.hyp.paste_in:
                # object crops sampled from random images (the
                # load_samples pool, utils/datasets.py:604-612)
                img = np.ascontiguousarray(img)
                img, labels = paste_in(
                    img, labels, self._sample_pool(30), self.rng
                )
            if self.rng.random() < self.hyp.fliplr:
                img = np.ascontiguousarray(img[:, ::-1])
                if len(labels):
                    x1 = labels[:, 1].copy()
                    labels[:, 1] = img.shape[1] - labels[:, 3]
                    labels[:, 3] = img.shape[1] - x1
            if self.rng.random() < self.hyp.flipud:
                img = np.ascontiguousarray(img[::-1])
                if len(labels):
                    y1 = labels[:, 2].copy()
                    labels[:, 2] = img.shape[0] - labels[:, 4]
                    labels[:, 4] = img.shape[0] - y1
        # xyxy pixels -> normalized xywh, pad to max_labels
        t = np.zeros((self.max_labels, 5), np.float32)
        m = np.zeros((self.max_labels,), bool)
        n = min(len(labels), self.max_labels)
        if n:
            lab = labels[:n]
            s_img = img.shape[0]
            cx = (lab[:, 1] + lab[:, 3]) / 2 / img.shape[1]
            cy = (lab[:, 2] + lab[:, 4]) / 2 / img.shape[0]
            ww = (lab[:, 3] - lab[:, 1]) / img.shape[1]
            hh = (lab[:, 4] - lab[:, 2]) / img.shape[0]
            t[:n, 0] = lab[:, 0]
            t[:n, 1], t[:n, 2], t[:n, 3], t[:n, 4] = cx, cy, ww, hh
            m[:n] = True
        return img, t, m

    def resample_by_weights(self, image_weights: np.ndarray):
        """Weighted-with-replacement epoch resample (train.py:312-317:
        dataset.indices = random.choices(range(n), weights=iw, k=n))."""
        n = len(self)
        self.indices = self.rng.choices(
            range(n), weights=list(image_weights), k=n
        )

    def batches(self, batch_size: int, shuffle: bool = True,
                epochs: int = 1) -> Iterator[Tuple[np.ndarray, ...]]:
        for _ in range(epochs):
            order = list(getattr(self, "indices", range(len(self))))
            if shuffle:
                self.rng.shuffle(order)
            for k in range(0, len(order) - batch_size + 1, batch_size):
                items = [self[i] for i in order[k:k + batch_size]]
                imgs = np.stack([x[0] for x in items])
                tgts = np.stack([x[1] for x in items])
                masks = np.stack([x[2] for x in items])
                yield imgs, tgts, masks

    def quad_batches(self, batch_size: int, shuffle: bool = True,
                     epochs: int = 1) -> Iterator[Tuple[np.ndarray, ...]]:
        """Quad collate (--quad, utils/datasets.py collate_fn4:653-677):
        every 4 items become one 2S-sized sample — 50% one image
        bilinearly upscaled 2x, 50% a 2x2 tile with labels shifted and
        halved. Normalized-xywh labels make the transforms pure
        offset/scale ops; target capacity grows to 4T."""
        import cv2

        t4 = 4 * self.max_labels
        for imgs, tgts, masks in self.batches(
            batch_size * 4, shuffle=shuffle, epochs=epochs
        ):
            s = imgs.shape[1]
            out_i = np.zeros((batch_size, 2 * s, 2 * s, 3), imgs.dtype)
            out_t = np.zeros((batch_size, t4, 5), np.float32)
            out_m = np.zeros((batch_size, t4), bool)
            for b in range(batch_size):
                k = 4 * b
                if self.rng.random() < 0.5:
                    out_i[b] = cv2.resize(
                        imgs[k], (2 * s, 2 * s),
                        interpolation=cv2.INTER_LINEAR,
                    )
                    n = int(masks[k].sum())
                    out_t[b, :n] = tgts[k][masks[k]]
                    out_m[b, :n] = True
                else:
                    offs = [(0, 0), (1, 0), (0, 1), (1, 1)]  # (dy, dx)
                    pos = 0
                    for q, (dy, dx) in enumerate(offs):
                        out_i[b, dy * s:(dy + 1) * s,
                              dx * s:(dx + 1) * s] = imgs[k + q]
                        lab = tgts[k + q][masks[k + q]].copy()
                        if len(lab):
                            lab[:, 1] = (lab[:, 1] + dx) * 0.5
                            lab[:, 2] = (lab[:, 2] + dy) * 0.5
                            lab[:, 3:5] *= 0.5
                            out_t[b, pos:pos + len(lab)] = lab
                            out_m[b, pos:pos + len(lab)] = True
                            pos += len(lab)
            yield out_i, out_t, out_m

    # -- rect validation ----------------------------------------------

    def _image_shapes(self):
        """(h0, w0) per image from file headers (PIL, no pixel decode)."""
        if not hasattr(self, "_shapes"):
            from PIL import Image

            shapes = []
            for p in self.files:
                with Image.open(p) as im:
                    w, h = im.size
                shapes.append((h, w))
            self._shapes = np.asarray(shapes, float)
        return self._shapes

    def rect_batches(self, batch_size: int, stride: int = 64,
                     pad: float = 0.5) -> Iterator[Tuple[np.ndarray, ...]]:
        """Aspect-ratio-sorted rectangular val batches (the reference's
        rect=True loader, utils/datasets.py:417-443), with the JAX
        module's quantization: the padded dim rounds up to `stride`
        (default 64, coarser than the reference's 32), so the number of
        distinct batch shapes is bounded by img_size/stride while still
        cutting most of the square-letterbox padding."""
        shapes = self._image_shapes()
        ar = shapes[:, 0] / shapes[:, 1]             # h/w
        order = np.argsort(ar)
        s = self.img_size
        n = len(order) // batch_size * batch_size
        for k in range(0, n, batch_size):
            idxs = order[k:k + batch_size]
            a = ar[idxs]
            # per-batch canvas from the extreme aspect ratios
            # (datasets.py:437-441), ceil to stride
            th, tw = 1.0, 1.0
            if a.max() < 1:
                th, tw = a.max(), 1.0
            elif a.min() > 1:
                th, tw = 1.0, 1.0 / a.min()
            out = (
                int(np.ceil(s * th / stride + pad) * stride),
                int(np.ceil(s * tw / stride + pad) * stride),
            )
            out = (min(out[0], s), min(out[1], s))
            items = [self.__getitem__(int(i), out_shape=out) for i in idxs]
            yield (np.stack([x[0] for x in items]),
                   np.stack([x[1] for x in items]),
                   np.stack([x[2] for x in items]))


def augment_hsv(img: np.ndarray, hyp: AugHyp, rng) -> np.ndarray:
    """HSV jitter (utils/datasets.py:814-830)."""
    import cv2

    r = np.array([rng.uniform(-1, 1) for _ in range(3)]) * np.array(
        [hyp.hsv_h, hyp.hsv_s, hyp.hsv_v]
    ) + 1
    hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    x = np.arange(0, 256, dtype=np.int16)
    lut_hue = ((x * r[0]) % 180).astype(np.uint8)
    lut_sat = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_val = np.clip(x * r[2], 0, 255).astype(np.uint8)
    img_hsv = cv2.merge(
        (cv2.LUT(hue.astype(np.uint8), lut_hue), cv2.LUT(sat, lut_sat),
         cv2.LUT(val, lut_val))
    )
    return cv2.cvtColor(img_hsv, cv2.COLOR_HSV2BGR)


def random_perspective(img, targets, hyp: AugHyp, border=(0, 0), rng=None):
    """Affine/perspective warp + label transform + candidate filter
    (utils/datasets.py:1148-1230)."""
    import cv2

    rng = rng or random
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2

    c = np.eye(3)
    c[0, 2] = -img.shape[1] / 2
    c[1, 2] = -img.shape[0] / 2
    p = np.eye(3)
    p[2, 0] = rng.uniform(-hyp.perspective, hyp.perspective)
    p[2, 1] = rng.uniform(-hyp.perspective, hyp.perspective)
    r = np.eye(3)
    a = rng.uniform(-hyp.degrees, hyp.degrees)
    s = rng.uniform(1 - hyp.scale, 1.1 + hyp.scale)
    r[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
    sh = np.eye(3)
    sh[0, 1] = math.tan(rng.uniform(-hyp.shear, hyp.shear) * math.pi / 180)
    sh[1, 0] = math.tan(rng.uniform(-hyp.shear, hyp.shear) * math.pi / 180)
    t = np.eye(3)
    t[0, 2] = rng.uniform(0.5 - hyp.translate, 0.5 + hyp.translate) * width
    t[1, 2] = rng.uniform(0.5 - hyp.translate, 0.5 + hyp.translate) * height
    m = t @ sh @ r @ p @ c
    if (border[0] != 0) or (border[1] != 0) or (m != np.eye(3)).any():
        if hyp.perspective:
            img = cv2.warpPerspective(
                img, m, dsize=(width, height), borderValue=(114, 114, 114)
            )
        else:
            img = cv2.warpAffine(
                img, m[:2], dsize=(width, height),
                borderValue=(114, 114, 114),
            )
    n = len(targets)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        xy = xy @ m.T
        xy = (
            (xy[:, :2] / xy[:, 2:3]) if hyp.perspective else xy[:, :2]
        ).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.stack(
            [x.min(1), y.min(1), x.max(1), y.max(1)], axis=1
        )
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = box_candidates(targets[:, 1:5].T * s, new.T)
        targets = targets[keep]
        targets[:, 1:5] = new[keep]
    return img, targets


def cutout(img: np.ndarray, labels: np.ndarray, rng) -> np.ndarray:
    """Random occlusion squares (utils/datasets.py:1314-1347): scales
    [0.5] + [0.25]*2 + [0.125]*4 + [0.0625]*8 filled with random colors;
    labels with >60% obscured area are dropped by the caller's
    box_candidates-style filter — here we mirror the reference and drop
    labels whose IoA with a cutout box exceeds 0.6."""
    h, w = img.shape[:2]
    scales = [0.5] + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8
    keep = np.ones(len(labels), bool)
    for s in scales:
        mask_h = rng.randrange(1, int(h * s))
        mask_w = rng.randrange(1, int(w * s))
        xmin = max(0, rng.randrange(0, w) - mask_w // 2)
        ymin = max(0, rng.randrange(0, h) - mask_h // 2)
        xmax = min(w, xmin + mask_w)
        ymax = min(h, ymin + mask_h)
        img[ymin:ymax, xmin:xmax] = [
            rng.randrange(64, 191) for _ in range(3)
        ]
        if len(labels):
            box = np.array([xmin, ymin, xmax, ymax], np.float32)
            ioa = _bbox_ioa(box, labels[:, 1:5])
            keep &= ioa < 0.60
    return img, labels[keep]


def _bbox_ioa(box1, box2, eps=1e-7):
    """Intersection over box2 area (utils/general.py bbox_ioa)."""
    iw = np.maximum(
        0, np.minimum(box1[2], box2[:, 2]) - np.maximum(box1[0], box2[:, 0])
    )
    ih = np.maximum(
        0, np.minimum(box1[3], box2[:, 3]) - np.maximum(box1[1], box2[:, 1])
    )
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1]) + eps
    return iw * ih / area2


def paste_in(img: np.ndarray, labels: np.ndarray, samples, rng,
             probability: float = 0.5):
    """Copy-paste augmentation (utils/datasets.py:1264-1311): paste
    cropped object samples [(patch, cls), ...] at random free locations;
    skips pastes overlapping existing labels (IoA > 0.3)."""
    h, w = img.shape[:2]
    out_labels = list(labels)
    for patch, cls in samples:
        if rng.random() > probability:
            continue
        ph, pw = patch.shape[:2]
        if ph >= h or pw >= w or ph < 4 or pw < 4:
            continue
        x = rng.randrange(0, w - pw)
        y = rng.randrange(0, h - ph)
        box = np.array([x, y, x + pw, y + ph], np.float32)
        if len(out_labels):
            ioa = _bbox_ioa(box, np.stack(out_labels)[:, 1:5])
            if (ioa > 0.3).any():
                continue
        img[y:y + ph, x:x + pw] = patch
        out_labels.append(np.array([cls, *box], np.float32))
    return img, (np.stack(out_labels) if out_labels else labels)


def box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.1):
    """(utils/datasets.py:1233-1240)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    return (
        (w2 > wh_thr) & (h2 > wh_thr)
        & (w2 * h2 / (w1 * h1 + 1e-16) > area_thr)
        & (ar < ar_thr)
    )


def labels_to_class_weights(labels, nc: int) -> np.ndarray:
    """Inverse-frequency class weights from label arrays
    (utils/general.py:216-232)."""
    if not labels:
        return np.ones(nc) / nc
    cls = np.concatenate([l[:, 0] for l in labels]).astype(int) \
        if any(len(l) for l in labels) else np.zeros(0, int)
    w = np.bincount(cls, minlength=nc).astype(np.float64)
    w[w == 0] = 1
    w = 1.0 / w
    return w / w.sum()


def labels_to_image_weights(labels, nc: int,
                            class_weights: np.ndarray) -> np.ndarray:
    """Per-image sampling weights = class_weights . per-image class
    counts (utils/general.py:235-240)."""
    counts = np.stack([
        np.bincount(l[:, 0].astype(int), minlength=nc) for l in labels
    ])
    return (class_weights.reshape(1, nc) * counts).sum(1)
