"""Single video / image-folder / live-stream tracking demo on the PyTorch
port (port of yolov7_tracker_tpu/cli/track_demo.py; the reference's
tracker/track_demo.py surface): no GT, no scoring, just the pipeline, a
MOT txt and, on request, overlays and a video.

    python -m yolov7_tracker_tpu_torch.cli.track_demo --obj clip.mp4 \\
        [--model_path w.msgpack] [--save_images] [--save_videos] \\
        [--state_ckpt state.npz] [--resume_state state.npz] [--device cpu]

An image directory or a video file goes through
TrackingPipeline.run_sequence_stateful (the offline batches, stage 1 by
the private-dummy auction); a webcam id or an rtsp/http URL goes through
StreamFrames and step_frame, one frame at a time (stage 1 by the square
auction), with its rows flushed at the state-checkpoint cadence. A run
resumed from --resume_state appends past the last frame its txt holds.
Video files and streams are read with OpenCV on the host.
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser("torch tracker demo")
    p.add_argument("--obj", type=str, required=True,
                   help="video file, image directory, webcam id (e.g. 0)"
                        " or rtsp/http stream URL")
    p.add_argument("--max_frames", type=int, default=0,
                   help="stop a live stream after N frames (0 = run on)")
    p.add_argument("--tracker", type=str, default="bytetrack",
                   choices=["sort", "bytetrack", "c_bioutracker", "uavmot",
                            "botsort", "deepsort", "strongsort", "deepmot"])
    p.add_argument("--model", type=str, default="yolov7-tiny")
    p.add_argument("--model_path", type=str, default="",
                   help="detector weights, read as cli/track.py reads "
                        "them: a Flax variables file (.msgpack/.npz), a "
                        "state_dict in the reference's names or an unfused "
                        "one in the port's names (default: seeded random "
                        "weights)")
    p.add_argument("--nc", type=int, default=80)
    p.add_argument("--img_size", type=int, default=640)
    p.add_argument("--conf_thresh", type=float, default=0.2)
    p.add_argument("--kalman_format", type=str, default="default")
    p.add_argument("--reid_model_path", type=str, default="",
                   help="appearance embeddings for the feature trackers "
                        "(DeepSORT CNN / OSNet; arch inferred from the file "
                        "name)")
    p.add_argument("--reid_capacity", type=int, default=0,
                   help="embed only the top-K score-ordered dets per "
                        "frame (0 = all det_capacity)")
    p.add_argument("--save_images", action="store_true")
    p.add_argument("--save_videos", action="store_true")
    p.add_argument("--save_dir", type=str, default="./demo_result")
    p.add_argument("--state_ckpt", type=str, default="",
                   help="checkpoint tracker state to this npz (live "
                        "streams: every --state_ckpt_every frames; "
                        "always at end of input)")
    p.add_argument("--state_ckpt_every", type=int, default=100)
    p.add_argument("--resume_state", type=str, default="",
                   help="resume tracker state from an npz written by "
                        "--state_ckpt: track ids and frame numbering "
                        "continue across the restart")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda, which must exist)")
    return p.parse_args(argv)


def _write_results(writer, opts, name, results):
    """A resumed run (--resume_state) appends past the rows the run before
    it already wrote, instead of clobbering the txt."""
    os.makedirs(opts.save_dir, exist_ok=True)
    append = bool(opts.resume_state)
    rows = results
    if append:
        upto = writer.last_written_frame(opts.save_dir, name)
        rows = [r for r in results if r[0] > upto]
    writer.save_results(opts.save_dir, name, rows, append=append)


def _run_stream(pipe, opts, writer):
    """A live source through step_frame; rows flush (before each state
    save, as serve does) at the checkpoint cadence: a live stream cannot
    be replayed, so rows held only in memory at a kill would be a
    permanent hole in the txt."""
    from ..data import sequence as seqmod

    src = seqmod.StreamFrames(opts.obj, max_frames=opts.max_frames)
    name = f"stream_{opts.obj.replace('://', '_').replace('/', '_')}"
    slab = (pipe.load_tracker_state(opts.resume_state)
            if opts.resume_state else pipe.init_tracker())
    base = int(slab.frame)
    results, pending = [], []
    append = bool(opts.resume_state)
    written_upto = (writer.last_written_frame(opts.save_dir, name)
                    if append else 0)

    def flush_rows():
        nonlocal append, written_upto
        rows = [r for r in pending if r[0] > written_upto]
        if rows or not append:
            writer.save_results(opts.save_dir, name, rows, append=append)
            if rows:
                written_upto = rows[-1][0]
            append = True
        pending.clear()

    t0 = time.time()
    n = 0
    try:
        for frame in src:
            slab, out = pipe.step_frame(slab, frame)
            row = writer.frame_row(
                base + n + 1, pipe.unpack_output(pipe.pack_output(out)))
            results.append(row)
            pending.append(row)
            n += 1
            if (opts.state_ckpt and opts.state_ckpt_every > 0
                    and n % opts.state_ckpt_every == 0):
                flush_rows()
                pipe.save_tracker_state(slab, opts.state_ckpt)
    finally:
        src.release()
    flush_rows()
    if opts.state_ckpt:
        pipe.save_tracker_state(slab, opts.state_ckpt)
    dt = time.time() - t0
    print(f"{name}: {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.1f} fps) "
          f"on {pipe.device}")
    return results


def main(argv=None):
    opts = parse_args(argv)
    from ..data import sequence as seqmod
    from ..data import writer
    from ..models import zoo
    from ..models.convert import load_detector_weights
    from ..pipeline import PipelineConfig, TrackingPipeline
    from ..reid import resolve_reid
    from ..trackers.slab import TrackerConfig

    reid, reid_state_dict = resolve_reid(opts.tracker, opts.reid_model_path)
    pcfg = PipelineConfig(model=opts.model, nc=opts.nc,
                          img_size=opts.img_size, conf_thres=0.001,
                          dtype=opts.dtype, reid=reid,
                          reid_capacity=opts.reid_capacity)
    tcfg = TrackerConfig(tracker=opts.tracker,
                         kalman_format=opts.kalman_format,
                         conf_thresh=opts.conf_thresh,
                         feature_dim=512 if reid != "none" else 0)
    spec = zoo.get_spec(opts.model, nc=opts.nc)
    state_dict = (load_detector_weights(opts.model_path, spec)
                  if opts.model_path else None)
    pipe = TrackingPipeline(pcfg, tcfg, state_dict=state_dict, spec=spec,
                            device=opts.device,
                            reid_state_dict=reid_state_dict)

    if opts.obj.isdigit() or "://" in opts.obj:
        return _run_stream(pipe, opts, writer)

    if os.path.isdir(opts.obj):
        frames = list(seqmod.image_dir_frames(opts.obj))
        name = os.path.basename(opts.obj.rstrip("/"))
    else:
        frames = list(seqmod.VideoFrames(opts.obj))
        name = os.path.splitext(os.path.basename(opts.obj))[0]
    t0 = time.time()
    init_slab = (pipe.load_tracker_state(opts.resume_state)
                 if opts.resume_state else None)
    results, final_slab = pipe.run_sequence_stateful(
        iter(frames), initial_slab=init_slab)
    if opts.state_ckpt:
        pipe.save_tracker_state(final_slab, opts.state_ckpt)
    dt = time.time() - t0
    print(f"{name}: {len(frames)} frames in {dt:.1f}s "
          f"({len(frames) / max(dt, 1e-9):.1f} fps) on {pipe.device}")
    _write_results(writer, opts, name, results)
    if opts.save_images or opts.save_videos:
        img_dir = os.path.join(opts.save_dir, name + "_imgs")
        for (fid, ids, tlwhs, _), frame in zip(results, frames):
            writer.plot_frame(frame, fid, ids, tlwhs, save_dir=img_dir)
        if opts.save_videos:
            writer.save_video(img_dir, os.path.join(opts.save_dir,
                                                    name + ".mp4"))
    return results


if __name__ == "__main__":
    main()
