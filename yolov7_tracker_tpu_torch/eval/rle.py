"""COCO run-length-encoding codec for segmentation masks.

pycocotools is not available in this environment, so the compressed-RLE
format its `mask` module defines (and that MOTS/KITTI-MOTS ship their
annotations in) is implemented here from the format definition:

- a binary mask is flattened in column-major (Fortran) order and stored
  as alternating run lengths starting with the zero-run;
- the `counts` string packs each run length 5 bits per character
  (chr(48 + bits), continuation flag at 0x20, sign extension from the
  0x10 bit of the last chunk), with runs at index >= 3 stored as deltas
  from the run two places earlier.

The run-level operations (area / merge / IoU-IoA) work directly on the
interval lists without densifying, like pycocotools' C kernels do. The
dict format is {'size': [h, w], 'counts': bytes}; tests/test_rle.py
checks the counts encoding against strings hand-derived from the spec
and the ops against dense-mask computations.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

Rle = Dict[str, Union[List[int], bytes]]


# ---------------------------------------------------------------------------
# counts string <-> run lengths
# ---------------------------------------------------------------------------

def counts_to_runs(rle: Rle) -> np.ndarray:
    """Decode a compressed (or already-uncompressed) counts field into
    the alternating run-length array."""
    counts = rle["counts"]
    if isinstance(counts, (list, tuple, np.ndarray)):
        return np.asarray(counts, dtype=np.int64)
    if isinstance(counts, str):
        counts = counts.encode("utf-8")
    runs: List[int] = []
    p = 0
    n = len(counts)
    while p < n:
        x = 0
        k = 0
        more = True
        while more:
            c = counts[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(runs) > 2:
            x += runs[-2]
        runs.append(x)
    return np.asarray(runs, dtype=np.int64)


def runs_to_counts(runs: Sequence[int]) -> bytes:
    """Encode an alternating run-length array into the compressed
    counts string."""
    out = bytearray()
    runs = list(map(int, runs))
    for i, cnt in enumerate(runs):
        x = cnt - runs[i - 2] if i > 2 else cnt
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


# ---------------------------------------------------------------------------
# dense <-> rle
# ---------------------------------------------------------------------------

def encode(mask: np.ndarray) -> Rle:
    """Binary (h, w) mask -> compressed RLE dict."""
    h, w = mask.shape
    flat = np.asfortranarray(mask).reshape(-1, order="F").astype(bool)
    # run boundaries of the 0/1 alternation, leading zero-run included
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(bounds)
    if flat.size and flat[0]:
        runs = np.concatenate([[0], runs])
    if flat.size == 0:
        runs = np.asarray([0], dtype=np.int64)
    return {"size": [h, w], "counts": runs_to_counts(runs)}


def decode(rle: Rle) -> np.ndarray:
    """RLE dict -> binary (h, w) uint8 mask."""
    h, w = rle["size"]
    runs = counts_to_runs(rle)
    vals = np.zeros(len(runs), dtype=np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, runs)
    if flat.size < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - flat.size, np.uint8)])
    return flat[: h * w].reshape((h, w), order="F")


# ---------------------------------------------------------------------------
# run-level ops (no densify)
# ---------------------------------------------------------------------------

def _intervals(runs: np.ndarray) -> np.ndarray:
    """(k, 2) [start, end) intervals of the 1-runs in flat F-order."""
    ends = np.cumsum(runs)
    starts = ends - runs
    return np.stack([starts[1::2], ends[1::2]], axis=1)


def _intervals_to_runs(iv: np.ndarray, total: int) -> np.ndarray:
    if len(iv) == 0:
        return np.asarray([total], dtype=np.int64)
    runs = []
    pos = 0
    for s, e in iv:
        runs.append(s - pos)   # zero-run (possibly 0 for the first)
        runs.append(e - s)
        pos = e
    runs.append(total - pos)
    if runs[-1] == 0:
        runs.pop()
    return np.asarray(runs, dtype=np.int64)


def area(rle: Rle) -> int:
    return int(counts_to_runs(rle)[1::2].sum())


def _inter_area(iv_a: np.ndarray, iv_b: np.ndarray) -> int:
    """Total overlap of two sorted disjoint interval lists (two-pointer
    walk, the same scheme as pycocotools rleArea/rleIou)."""
    i = j = 0
    total = 0
    na, nb = len(iv_a), len(iv_b)
    while i < na and j < nb:
        s = max(iv_a[i, 0], iv_b[j, 0])
        e = min(iv_a[i, 1], iv_b[j, 1])
        if e > s:
            total += e - s
        if iv_a[i, 1] <= iv_b[j, 1]:
            i += 1
        else:
            j += 1
    return int(total)


def merge(rles: Sequence[Rle], intersect: bool = False) -> Rle:
    """Union (or intersection) of RLEs (pycocotools mask.merge)."""
    if len(rles) == 0:
        return {"size": [0, 0], "counts": runs_to_counts([0])}
    h, w = rles[0]["size"]
    total = h * w
    iv = _intervals(counts_to_runs(rles[0]))
    for r in rles[1:]:
        iv2 = _intervals(counts_to_runs(r))
        if intersect:
            out = []
            i = j = 0
            while i < len(iv) and j < len(iv2):
                s = max(iv[i][0], iv2[j][0])
                e = min(iv[i][1], iv2[j][1])
                if e > s:
                    out.append((s, e))
                if iv[i][1] <= iv2[j][1]:
                    i += 1
                else:
                    j += 1
            iv = np.asarray(out, dtype=np.int64).reshape(-1, 2)
        else:
            pts = np.concatenate([iv, iv2]) if len(iv2) else iv
            if len(pts) == 0:
                iv = pts.reshape(-1, 2)
                continue
            pts = pts[np.argsort(pts[:, 0])]
            out = [list(pts[0])]
            for s, e in pts[1:]:
                if s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], e)
                else:
                    out.append([s, e])
            iv = np.asarray(out, dtype=np.int64)
    return {"size": [h, w],
            "counts": runs_to_counts(_intervals_to_runs(iv, total))}


def iou(dts: Sequence[Rle], gts: Sequence[Rle],
        iscrowd: Sequence[bool]) -> np.ndarray:
    """Pairwise mask IoU (pycocotools mask.iou): shape (len(dts),
    len(gts)); entry = inter/union, or inter/area(dt) where the gt is
    flagged iscrowd."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    out = np.zeros((len(dts), len(gts)))
    d_iv = [_intervals(counts_to_runs(d)) for d in dts]
    d_area = [area(d) for d in dts]
    g_iv = [_intervals(counts_to_runs(g)) for g in gts]
    g_area = [area(g) for g in gts]
    for j in range(len(gts)):
        crowd = bool(iscrowd[j]) if j < len(iscrowd) else False
        for i in range(len(dts)):
            inter = _inter_area(d_iv[i], g_iv[j])
            denom = d_area[i] if crowd \
                else d_area[i] + g_area[j] - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


def encode_pycoco(arr: np.ndarray):
    """pycocotools-shaped encode: a (h, w) mask -> one RLE dict, a
    (h, w, n) stack -> list of RLE dicts (mask.encode contract, used by
    the DAVIS reader and the test shim)."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        return encode(arr)
    return [encode(arr[:, :, i]) for i in range(arr.shape[2])]


def fr_uncompressed(obj, h=None, w=None):
    """pycocotools mask.frPyObjects for RLE inputs: an uncompressed
    {'size', 'counts': list} dict (or a list of them) compresses to the
    string form; already-compressed dicts pass through. Polygon
    segmentations are not supported (they need COCO's 5x-upsampled
    crossing rasterizer) — supply RLE, as tracker outputs do."""
    if isinstance(obj, dict):
        counts = obj["counts"]
        if isinstance(counts, (bytes, str)):
            return {"size": list(obj["size"]),
                    "counts": counts.encode("utf-8")
                    if isinstance(counts, str) else counts}
        return {"size": list(obj["size"]), "counts": runs_to_counts(counts)}
    if isinstance(obj, (list, tuple)) and obj and isinstance(obj[0], dict):
        return [fr_uncompressed(o, h, w) for o in obj]
    raise NotImplementedError(
        "polygon segmentations are not supported; supply RLE dicts")


def to_bbox(rle: Rle) -> np.ndarray:
    """pycocotools mask.toBbox: tight [x, y, w, h] of the mask (zeros
    for an empty mask)."""
    h, w = rle["size"]
    iv = _intervals(counts_to_runs(rle))
    if len(iv) == 0 or h == 0:
        return np.zeros(4)
    # flat F-order index = col * h + row
    cols = iv // h                      # [start_col, (end-1)//h] per run
    rows_s = iv[:, 0] % h
    rows_e = (iv[:, 1] - 1) % h
    c0 = int(cols[:, 0].min())
    c1 = int(((iv[:, 1] - 1) // h).max())
    # a run can span column boundaries; rows then cover the full height
    spans = (iv[:, 1] - 1) // h > iv[:, 0] // h
    r0 = 0 if spans.any() else int(rows_s.min())
    r1 = h - 1 if spans.any() else int(rows_e.max())
    return np.asarray([c0, r0, c1 - c0 + 1, r1 - r0 + 1], float)


def from_bbox(box, h: int, w: int) -> Rle:
    """pycocotools frPyObjects on an [x, y, w, h] box: the filled
    rectangle as RLE."""
    import numpy as _np

    x0 = int(round(box[0]))
    y0 = int(round(box[1]))
    x1 = int(round(box[0] + box[2]))
    y1 = int(round(box[1] + box[3]))
    m = _np.zeros((h, w), _np.uint8)
    m[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = 1
    return encode(m)
