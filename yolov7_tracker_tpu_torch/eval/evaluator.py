"""Evaluator: benchmark x tracker -> metric tables.

Equivalent of trackeval.Evaluator (tracker/trackeval/eval.py:18-225):
optional process-parallel per-sequence evaluation, combine over
sequences then classes, summary + detailed CSV output, per-tracker
error capture.
"""

from __future__ import annotations

import csv
import os
import traceback
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import data as D
from . import metrics as M


# metric families selectable like trackeval's METRICS config
# (run_mot_challenge.py --METRICS); hota/clear/identity/count are the
# reference flow's defaults, vace/ideucl are opt-in extras
METRIC_FNS = {
    "hota": M.hota,
    "clear": M.clear,
    "identity": M.identity,
    "count": M.count,
    "vace": M.vace,
    "ideucl": M.ideucl,
    # jandf needs dense-mask dets (MOTS data); selectable when the
    # caller's loader supplies them
    "jandf": M.jandf,
}
DEFAULT_METRICS = ("hota", "clear", "identity", "count")


def _reader_registry():
    """Benchmark -> (loader, per-class preprocessor) for benchmarks with
    their own file formats; MOT/VisDrone use the default MOT-txt path."""
    from . import readers as R

    return {
        "KITTI": (D.load_kitti_seq, D.preprocess_kitti),
        "BDD100K": (R.load_bdd100k_seq, R.preprocess_bdd100k),
        "HT": (R.load_ht_seq, R.preprocess_ht),
        "PersonPath22": (R.load_personpath_seq, R.preprocess_personpath),
        "MOTS": (R.load_mots_seq, R.preprocess_mots),
        "KittiMOTS": (R.load_kitti_mots_seq, R.preprocess_kitti_mots),
        "DAVIS": (R.load_davis_seq, R.preprocess_davis),
        "TAO": (R.load_tao_seq, R.preprocess_tao),
        "TAO_OW": (R.load_tao_ow_seq, R.preprocess_tao_ow),
        "YouTubeVIS": (R.load_ytvis_seq, R.preprocess_ytvis),
        "BURST": (R.load_burst_seq, R.preprocess_burst),
        "BURST_OW": (R.load_burst_ow_seq, R.preprocess_burst_ow),
    }


_READERS = _reader_registry()


def _empty_result(metric_names: Sequence[str] = DEFAULT_METRICS):
    """All-zero metric dict used when a sequence errors out."""
    empty = {
        "gt_ids": [], "tracker_ids": [], "gt_dets": [],
        "similarity_scores": [],
        "num_timesteps": 0, "num_gt_ids": 0, "num_tracker_ids": 0,
        "num_gt_dets": 0, "num_tracker_dets": 0,
    }
    res = {}
    for name in metric_names:
        res.update(METRIC_FNS[name](empty))
    return res


def eval_sequence(seq: str, gt_path: str, result_path: str,
                  num_timesteps: int, benchmark: str,
                  classes: Sequence[str],
                  metric_names: Sequence[str] = DEFAULT_METRICS,
                  seq_meta: Optional[Dict] = None,
                  ) -> Dict[str, Dict]:
    if benchmark == "RobMOTS":
        # needs per-seq metadata from the RobMOTS seqmap (frame size,
        # ignore classes) plus benchmark config (sub_benchmark, clsmap)
        from . import readers as R

        meta = seq_meta or {}
        raw = R.load_robmots_seq(
            seq, gt_path, result_path, num_timesteps,
            frame_size=meta.get("size", (1080, 1920)),
            sub_benchmark=meta.get("sub_benchmark", "mots_challenge"),
            ignore_class_ids=tuple(meta.get("ignore_class_ids", ())),
            valid_class_ids=meta.get("valid_class_ids"),
        )
        return {cls: _run_metrics(R.preprocess_robmots(raw, cls),
                                  metric_names)
                for cls in classes}
    load, pre_fn = _READERS.get(benchmark, (None, None))
    if load is not None:
        raw = load(seq, gt_path, result_path, num_timesteps)
    else:
        raw = D.load_raw_seq(seq, gt_path, result_path, num_timesteps)
    out = {}
    for cls in classes:
        pre = (pre_fn(raw, cls) if pre_fn is not None
               else D.preprocess_sequence(raw, benchmark, cls))
        out[cls] = _run_metrics(pre, metric_names)
    return out


def _run_metrics(pre: Dict, metric_names: Sequence[str]) -> Dict:
    res = {}
    for name in metric_names:
        res.update(METRIC_FNS[name](pre))
    return res


def evaluate_benchmark(
    gt_folder: str,
    results_folder: str,
    seqs: Dict[str, int],
    benchmark: str = "MOT17",
    classes: Optional[Sequence[str]] = None,
    gt_loc_format: str = "{gt_folder}/{seq}/gt/gt.txt",
    num_parallel: int = 0,
    output_folder: Optional[str] = None,
    metric_names: Sequence[str] = DEFAULT_METRICS,
    result_ext: Optional[str] = None,
    result_loc_format: Optional[str] = None,
    seq_meta_extra: Optional[Dict] = None,
):
    """Evaluate result files against gt.

    Args:
      seqs: {seq_name: num_timesteps} — or, for benchmarks needing
        per-seq metadata (RobMOTS), {seq_name: meta_dict} where
        meta_dict has at least "length" (e.g. from
        readers.read_robmots_seqmap).
      num_parallel: >1 enables a process pool over sequences
        (trackeval eval.py:82-103).
      result_ext: result-file extension; default ".txt" except for
        json-format benchmarks (BDD100K).
      result_loc_format: full result-path template with {results_folder}
        and {seq}; overrides result_ext. TAO defaults to the single
        shared {results_folder}/results.json.
      seq_meta_extra: benchmark-level metadata merged into every seq's
        meta (RobMOTS: sub_benchmark, valid_class_ids).

    Returns {cls: {seq: res, 'COMBINED_SEQ': res}} plus a class-averaged
    summary under 'cls_comb_cls_av' when multiple classes.
    """
    classes = list(classes or D.BENCHMARKS[benchmark]["eval_classes"])
    if result_ext is None:
        result_ext = {"BDD100K": ".json", "DAVIS": ""}.get(benchmark, ".txt")
    if result_loc_format is None:
        result_loc_format = ("{results_folder}/results.json"
                             if benchmark in ("TAO", "TAO_OW", "YouTubeVIS")
                             else "{results_folder}/{seq}" + result_ext)

    def norm(v):
        if isinstance(v, dict):
            meta = dict(v, **(seq_meta_extra or {}))
            return meta["length"], meta
        return v, (dict(seq_meta_extra) if seq_meta_extra else None)

    jobs = [
        (
            seq,
            gt_loc_format.format(gt_folder=gt_folder, seq=seq),
            result_loc_format.format(results_folder=results_folder,
                                     seq=seq),
            length,
            benchmark,
            classes,
            metric_names,
            meta,
        )
        for seq, v in seqs.items()
        for length, meta in (norm(v),)
    ]
    # per-sequence error capture (trackeval eval.py:191-209: log and
    # continue rather than aborting the whole run)
    def safe_eval(*job):
        try:
            return eval_sequence(*job)
        except Exception:
            err = traceback.format_exc()
            if output_folder:
                os.makedirs(output_folder, exist_ok=True)
                with open(os.path.join(output_folder, "error_log.txt"),
                          "a") as f:
                    f.write(f"seq {job[0]}:\n{err}\n")
            return {c: _empty_result(metric_names) for c in classes}

    if num_parallel > 1:
        from multiprocessing import Pool

        with Pool(num_parallel) as pool:
            results = pool.starmap(safe_eval, jobs)
    else:
        results = [safe_eval(*j) for j in jobs]

    table: Dict[str, Dict[str, Dict]] = {c: {} for c in classes}
    for (seq, *_), res in zip(jobs, results):
        for c in classes:
            table[c][seq] = res[c]
    for c in classes:
        table[c]["COMBINED_SEQ"] = M.combine_sequences(
            [table[c][s] for s, _ in seqs.items()]
        )
    if len(classes) > 1:
        # class-averaged headline (trackeval combine_classes_class_averaged)
        combined = [table[c]["COMBINED_SEQ"] for c in classes]
        avg = {}
        for k in ("HOTA", "DetA", "AssA", "MOTA", "IDF1", "IDSW"):
            vals = [np.asarray(r[k], float) for r in combined if k in r]
            if vals:
                avg[k] = np.mean(vals, axis=0)
        table["cls_comb_cls_av"] = avg
    if output_folder:
        os.makedirs(output_folder, exist_ok=True)
        _write_csv(table, classes, output_folder)
    return table


SUMMARY_FIELDS = [
    "HOTA", "DetA", "AssA", "DetRe", "DetPr", "AssRe", "AssPr", "LocA",
    "MOTA", "MOTP", "IDSW", "IDF1", "IDR", "IDP", "CLR_TP", "CLR_FN",
    "CLR_FP", "MT", "ML", "Frag", "SFDA", "ATA", "IDEucl",
]


def summarize(res: Dict) -> Dict[str, float]:
    """Flatten one result dict to scalar summary values (HOTA-family
    arrays are averaged over alphas, like trackeval's summary rows)."""
    out = {}
    for k in SUMMARY_FIELDS:
        if k not in res:
            continue
        v = np.asarray(res[k], float)
        out[k] = float(np.mean(v)) if v.ndim else float(v)
    return out


def _write_csv(table, classes, folder):
    for c in classes:
        path = os.path.join(folder, f"{c}_summary.csv")
        rows = [(seq, summarize(r)) for seq, r in table[c].items()]
        if not rows:
            continue
        keys = list(rows[0][1].keys())
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["seq"] + keys)
            for seq, r in rows:
                w.writerow([seq] + [f"{r.get(k, float('nan')):.5g}" for k in keys])


def render_table(table, classes) -> str:
    """Pretty text table like trackeval's print_summary."""
    lines = []
    for c in classes:
        lines.append(f"=== class: {c} ===")
        rows = list(table[c].items())
        keys = SUMMARY_FIELDS
        header = f"{'seq':24s}" + "".join(f"{k:>9s}" for k in keys)
        lines.append(header)
        for seq, r in rows:
            s = summarize(r)
            lines.append(
                f"{seq:24s}"
                + "".join(
                    f"{s.get(k, float('nan')) * (100 if k not in ('IDSW','CLR_TP','CLR_FN','CLR_FP','MT','ML','Frag') else 1):>9.3f}"
                    for k in keys
                )
            )
    return "\n".join(lines)
