"""Standalone benchmark evaluation CLI (port of
yolov7_tracker_tpu/cli/evaluate.py, on the port's own copy of eval/).

Mirrors the reference's evaluation entries (tracker/evaluate.py and the
trackeval run scripts' surface) over all 16 registered benchmark
formats. Reads sequences either from --seqmap ("name length" rows /
RobMOTS-style rows) or from seqinfo.ini folders under the gt root.

Examples:
  python -m yolov7_tracker_tpu_torch.cli.evaluate \\
      --benchmark MOT17 --gt_folder data/gt --trackers_folder out/trk \\
      --metrics hota clear identity count
  python -m yolov7_tracker_tpu_torch.cli.evaluate --benchmark BDD100K \\
      --gt_folder gt/ --trackers_folder trk/ \\
      --gt_loc_format '{gt_folder}/{seq}.json'
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def discover_seqs(gt_folder: str, gt_loc_format: str):
    """Sequences from seqinfo.ini subfolders of the gt root."""
    from ..eval.data import seq_length_from_seqinfo

    seqs = {}
    if os.path.isdir(gt_folder):
        for name in sorted(os.listdir(gt_folder)):
            d = os.path.join(gt_folder, name)
            if os.path.isdir(d):
                n = seq_length_from_seqinfo(d)
                if n:
                    seqs[name] = n
    return seqs


def read_seqmap(path: str):
    seqs = {}
    with open(path) as f:
        for line in f:
            parts = line.replace(",", " ").split()
            if len(parts) >= 2 and parts[1].isdigit():
                seqs[parts[0]] = int(parts[1])
    return seqs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--benchmark", default="MOT17",
                   help="MOT17/MOT20/VisDrone/KITTI/KittiMOTS/MOTS/"
                        "BDD100K/HT/PersonPath22/DAVIS/TAO/TAO_OW/"
                        "YouTubeVIS/BURST/BURST_OW/RobMOTS")
    p.add_argument("--sub_benchmark", default="mots_challenge",
                   help="RobMOTS only: mots_challenge/kitti_mots/"
                        "bdd_mots/davis_unsupervised/youtube_vis/ovis/"
                        "waymo/tao (rob_mots.py:46)")
    p.add_argument("--split", default="train",
                   help="RobMOTS only: gt split folder")
    p.add_argument("--gt_folder", required=True)
    p.add_argument("--trackers_folder", required=True)
    p.add_argument("--seqmap", default="",
                   help="seqmap file (name length per row); default: "
                        "discover seqinfo.ini folders under gt_folder")
    p.add_argument("--gt_loc_format",
                   default="{gt_folder}/{seq}/gt/gt.txt")
    p.add_argument("--classes", nargs="*", default=None)
    p.add_argument("--metrics", nargs="*",
                   default=["hota", "clear", "identity", "count"])
    p.add_argument("--num_parallel", type=int, default=0)
    p.add_argument("--output_folder", default="")
    p.add_argument("--result_ext", default=None)
    args = p.parse_args(argv)
    # numpy on the host: scoring needs no card

    from ..eval import evaluator

    seq_meta_extra = None
    result_loc_format = None
    gt_loc_format = args.gt_loc_format
    if args.benchmark == "RobMOTS":
        # reference layout (rob_mots.py:93-135 + run_rob_mots.py):
        #   gt:      GT_FOLDER/{split}/{sub}/data/{seq}.txt
        #   tracker: TRACKERS_FOLDER(/data)/{sub}/{seq}.txt
        #   seqmap:  GT_FOLDER/{split}/{sub}/seqmap.txt (seq len h w ig…)
        #   clsmap:  GT_FOLDER/{split}/{sub}/clsmap.txt (valid class ids)
        from ..eval import readers as R

        sub_dir = os.path.join(args.gt_folder, args.split,
                               args.sub_benchmark)
        seqmap_path = args.seqmap or os.path.join(sub_dir, "seqmap.txt")
        seqs = R.read_robmots_seqmap(seqmap_path)
        clsmap_path = os.path.join(sub_dir, "clsmap.txt")
        valid_ids = None
        if os.path.isfile(clsmap_path):
            with open(clsmap_path) as f:
                valid_ids = tuple(
                    int(float(x)) for x in f.read().split())
        seq_meta_extra = {"sub_benchmark": args.sub_benchmark,
                          "valid_class_ids": valid_ids}
        if gt_loc_format == p.get_default("gt_loc_format"):
            gt_loc_format = os.path.join(sub_dir, "data", "{seq}.txt")
        result_loc_format = os.path.join(
            "{results_folder}", "data", args.sub_benchmark, "{seq}.txt")
        if args.classes is None and valid_ids is not None:
            args.classes = [R.COCO_CLASSES[i] for i in valid_ids
                            if i in R.COCO_CLASSES] + ["all"]
    elif args.seqmap:
        seqs = read_seqmap(args.seqmap)
    else:
        seqs = discover_seqs(args.gt_folder, args.gt_loc_format)
    if not seqs:
        print("no sequences found (use --seqmap or seqinfo.ini folders)",
              file=sys.stderr)
        return 2

    table = evaluator.evaluate_benchmark(
        args.gt_folder, args.trackers_folder, seqs,
        benchmark=args.benchmark, classes=args.classes,
        gt_loc_format=gt_loc_format,
        num_parallel=args.num_parallel,
        output_folder=args.output_folder or None,
        metric_names=tuple(args.metrics),
        result_ext=args.result_ext,
        result_loc_format=result_loc_format,
        seq_meta_extra=seq_meta_extra,
    )
    classes = args.classes or list(
        evaluator.D.BENCHMARKS[args.benchmark]["eval_classes"])
    print(evaluator.render_table(table, classes))
    if args.output_folder:
        summary = {
            c: evaluator.summarize(table[c]["COMBINED_SEQ"])
            for c in classes
        }
        with open(os.path.join(args.output_folder,
                               "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
