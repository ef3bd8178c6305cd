"""Local experiment-artifact store (port of
yolov7_tracker_tpu/utils/artifacts.py, a copy) — the zero-egress analogue
of the reference's W&B integration (utils/wandb_logging/wandb_utils.py:
80-306).

Capabilities mirrored:
  * dataset / model / checkpoint artifacts, content-addressed (sha256
    over file bytes; directories hash the sorted relative-path+digest
    list) — `log_artifact`;
  * named artifact versions with aliases (latest / best / epoch-N),
    like wandb's artifact aliases (wandb_utils.py:150-163);
  * checkpoint lineage: each version records its parent refs and free
    metadata, so a run's provenance chain is walkable offline;
  * run resume from an artifact ref (`resolve` + train CLI
    ``--resume artifact:<name>:<alias>``), replacing
    wandb_utils.py:42-54's artifact download;
  * bbox media panels as PNG grids (`log_bbox_panel`), replacing the
    wandb bounding-box media panel (wandb_utils.py:245-262).

Layout under the store root:
  objects/<digest>/...        immutable content (copied once)
  artifacts/<name>/<digest>.json   version manifest (type, metadata,
                                   parents, created, files)
  artifacts/<name>/aliases.json    alias -> digest map
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def _file_digest(path: str, h=None) -> str:
    h = h or hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def digest_path(path: str) -> str:
    """Content digest of a file, or of a directory tree (sorted
    relative-path + per-file digest pairs)."""
    if os.path.isfile(path):
        return _file_digest(path)
    entries = []
    for root, _, files in os.walk(path):
        for fn in sorted(files):
            fp = os.path.join(root, fn)
            rel = os.path.relpath(fp, path)
            entries.append((rel, _file_digest(fp)))
    h = hashlib.sha256()
    for rel, d in sorted(entries):
        h.update(rel.encode())
        h.update(d.encode())
    return h.hexdigest()


class ArtifactStore:
    def __init__(self, root: str = ".artifacts"):
        self.root = os.path.abspath(root)
        os.makedirs(os.path.join(self.root, "objects"), exist_ok=True)
        os.makedirs(os.path.join(self.root, "artifacts"), exist_ok=True)

    # ------------------------------------------------------------------
    def _name_dir(self, name: str) -> str:
        d = os.path.join(self.root, "artifacts", name)
        os.makedirs(d, exist_ok=True)
        return d

    def _aliases(self, name: str) -> Dict[str, str]:
        p = os.path.join(self._name_dir(name), "aliases.json")
        if os.path.isfile(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def _write_aliases(self, name: str, aliases: Dict[str, str]):
        p = os.path.join(self._name_dir(name), "aliases.json")
        with open(p, "w") as f:
            json.dump(aliases, f, indent=2)

    # ------------------------------------------------------------------
    def log_artifact(
        self,
        path: str,
        name: str,
        type: str = "model",
        aliases: Sequence[str] = ("latest",),
        metadata: Optional[dict] = None,
        parents: Sequence[str] = (),
    ) -> str:
        """Store `path` (file or directory) as a version of artifact
        `name`. Returns the ref ``name:<digest12>``. Content already in
        the store is not copied again (content addressing)."""
        digest = digest_path(path)
        obj_dir = os.path.join(self.root, "objects", digest)
        if not os.path.exists(obj_dir):
            tmp = obj_dir + ".tmp"
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            if os.path.isfile(path):
                os.makedirs(tmp, exist_ok=True)
                shutil.copy2(path, os.path.join(tmp,
                                                os.path.basename(path)))
            else:
                shutil.copytree(path, tmp)
            os.replace(tmp, obj_dir)
        manifest = {
            "name": name,
            "type": type,
            "digest": digest,
            "created": time.time(),
            "source": os.path.abspath(path),
            "is_file": os.path.isfile(path),
            "metadata": metadata or {},
            "parents": list(parents),
        }
        with open(os.path.join(self._name_dir(name),
                               f"{digest}.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        al = self._aliases(name)
        for a in aliases:
            al[a] = digest
        self._write_aliases(name, al)
        return f"{name}:{digest[:12]}"

    # ------------------------------------------------------------------
    def _digest_for(self, name: str, sel: str) -> str:
        al = self._aliases(name)
        digest = al.get(sel)
        if digest is None:
            cands = [
                fn[:-5]
                for fn in os.listdir(self._name_dir(name))
                if fn.endswith(".json") and fn != "aliases.json"
                and fn.startswith(sel)
            ]
            if len(cands) != 1:
                raise KeyError(
                    f"artifact {name!r}: no alias/version {sel!r}"
                    f" (aliases: {sorted(al)})"
                )
            digest = cands[0]
        return digest

    @staticmethod
    def _split_ref(ref: str):
        if ref.startswith("artifact:"):
            ref = ref[len("artifact:"):]
        name, _, sel = ref.partition(":")
        return name, sel or "latest"

    def resolve_ref(self, ref: str) -> str:
        """Pin a possibly-aliased ref to its immutable digest form
        (``name:<digest12>``) — lineage parents must use this, since an
        alias like 'latest' re-points to the child itself once the new
        version is logged."""
        name, sel = self._split_ref(ref)
        return f"{name}:{self._digest_for(name, sel)[:12]}"

    def resolve(self, ref: str) -> str:
        """Resolve ``name:alias`` / ``name:digestprefix`` (optionally
        prefixed with ``artifact:``) to the stored content path. A
        stored single file resolves to the file itself."""
        name, sel = self._split_ref(ref)
        digest = self._digest_for(name, sel)
        obj_dir = os.path.join(self.root, "objects", digest)
        manifest = self.manifest(name, digest)
        if manifest.get("is_file"):
            files = os.listdir(obj_dir)
            if len(files) == 1:
                return os.path.join(obj_dir, files[0])
        return obj_dir

    def manifest(self, name: str, digest: str) -> dict:
        p = os.path.join(self._name_dir(name), f"{digest}.json")
        with open(p) as f:
            return json.load(f)

    def versions(self, name: str) -> List[dict]:
        d = self._name_dir(name)
        out = []
        for fn in os.listdir(d):
            if fn.endswith(".json") and fn != "aliases.json":
                with open(os.path.join(d, fn)) as f:
                    out.append(json.load(f))
        return sorted(out, key=lambda m: m["created"])

    def lineage(self, ref: str) -> List[str]:
        """Walk parent refs back to the roots (checkpoint provenance)."""
        chain, seen = [], set()
        todo = [ref]
        while todo:
            r = todo.pop(0)
            if r in seen:
                continue
            seen.add(r)
            chain.append(r)
            name, sel = self._split_ref(r)
            try:
                digest = self._digest_for(name, sel)
                todo.extend(self.manifest(name, digest).get("parents", []))
            except (KeyError, OSError):
                pass
        return chain


# ---------------------------------------------------------------------------
# bbox media panels (wandb_utils.py:245-262 analogue)
# ---------------------------------------------------------------------------

def log_bbox_panel(
    store: ArtifactStore,
    images,
    boxes: Iterable,
    out_path: str,
    name: str = "media",
    labels: Optional[Iterable] = None,
    cols: int = 4,
    metadata: Optional[dict] = None,
) -> str:
    """Render a grid PNG of images with drawn tlbr boxes (+ labels) and
    log it as a media artifact. images: (N, H, W, 3) uint8; boxes:
    per-image (K, 4) tlbr arrays."""
    import numpy as np
    from PIL import Image, ImageDraw

    images = np.asarray(images)
    n, h, w = images.shape[:3]
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    grid = Image.new("RGB", (cols * w, rows * h))
    labels = list(labels) if labels is not None else [None] * n
    palette = [(255, 99, 71), (60, 179, 113), (65, 105, 225),
               (255, 215, 0), (186, 85, 211), (0, 206, 209)]
    for i in range(n):
        im = Image.fromarray(images[i])
        draw = ImageDraw.Draw(im)
        for k, b in enumerate(np.asarray(boxes[i]).reshape(-1, 4)):
            color = palette[k % len(palette)]
            draw.rectangle([float(b[0]), float(b[1]),
                            float(b[2]), float(b[3])],
                           outline=color, width=2)
            if labels[i] is not None and k < len(labels[i]):
                draw.text((float(b[0]) + 2, float(b[1]) + 2),
                          str(labels[i][k]), fill=color)
        grid.paste(im, ((i % cols) * w, (i // cols) * h))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    grid.save(out_path)
    return store.log_artifact(out_path, name, type="media",
                              metadata=metadata)
