"""Multi-camera serving CLI on the PyTorch port (port of
yolov7_tracker_tpu/cli/serve.py): S independent streams advance in
lockstep, one detector batch (with --reid_model_path, one ReID crop gather
and forward over the streams' top --reid_capacity dets) and one stacked
tracker step per tick (``TrackingPipeline.process_multistream``). Result
D2H keeps one packed batch in flight -- a non-blocking copy into a pinned
buffer with a CUDA event -- so the transfer overlaps the next tick's
compute.

Frame acquisition is per-stream prefetch threads feeding bounded queues,
so one stalled-but-alive camera cannot head-of-line-block the other
streams' ticks: a healthy stream is waited on for at most
--stall_timeout, after which its tracker state is frozen (same mechanism
as dead-stream freeze) and the tick proceeds without it -- the lane
coasts unstepped on its last frame. A stalled stream is then polled
without blocking each tick and rejoins the moment a frame arrives, its
frozen state restored first so the phantom lane updates during the stall
never touch its real trajectory.

Fault tolerance: per-stream tracker state checkpoints under --state_dir
every --state_ckpt_every ticks; SIGTERM/SIGINT checkpoints every stream
and exits 75 (EX_TEMPFAIL) so a supervisor relaunches the same command --
existing state files auto-resume, with ids and frame numbering continuing
per stream. Checkpoints are tagged with the stream's source string, so a
reordered/edited --streams list fails loudly instead of resuming another
camera's state; their npz layout is the JAX package's, so either package
resumes the other's files. Results flush to the per-stream MOT txt
incrementally (append mode), so a crash loses at most one checkpoint
interval and a relaunch never clobbers rows already written.

Sources (data/sequence.py): image directories, video files, ``synth://``
specs, and webcams (a digit id) or RTSP/HTTP URLs. The first three replay
from their first frame, so a resumed stream fast-forwards to its
checkpointed frame; a live source resumes at its live point. Video files
and live sources are read through cv2.VideoCapture (OpenCV on the host).

    python -m yolov7_tracker_tpu_torch.cli.serve \\
        --streams cam1_frames/ cam2_frames/ "synth://600x1080x1920?seed=3" \\
        --model yolov7-w6 --model_path w6_state_dict.pt --img_size 1088 \\
        --state_dir ./serve_state --save_dir ./serve_out [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import queue
import re
import signal
import threading
import time

import numpy as np

# in-memory result rows kept per stream for the API return value; disk
# output is flushed incrementally and unaffected by this cap, which only
# bounds memory over an indefinite serving run
MAX_RETURN_ROWS = 100_000


def parse_args(argv=None):
    p = argparse.ArgumentParser("torch multi-stream tracking server")
    p.add_argument("--streams", type=str, nargs="+", required=True,
                   help="N sources: image directories, video files, "
                        "synth:// specs, webcam ids or rtsp/http URLs "
                        "(same resolution)")
    p.add_argument("--tracker", type=str, default="bytetrack",
                   choices=["sort", "bytetrack", "c_bioutracker", "uavmot",
                            "botsort", "deepsort", "strongsort", "deepmot"])
    p.add_argument("--model", type=str, default="yolov7-tiny",
                   help="zoo model name or reference cfg yaml path")
    p.add_argument("--model_path", type=str, default="",
                   help="detector weights, read as cli/track.py reads them: "
                        "a Flax variables file, a reference checkpoint or "
                        "an unfused state_dict in the port's names "
                        "(default: seeded random weights)")
    p.add_argument("--trust_model_path", action="store_true",
                   help="unpickle a --model_path that holds a full "
                        "reference checkpoint (runs code from the file; the "
                        "reference repository must be on PYTHONPATH)")
    p.add_argument("--nc", type=int, default=80)
    p.add_argument("--img_size", type=int, default=640)
    p.add_argument("--conf_thresh", type=float, default=0.2)
    p.add_argument("--kalman_format", type=str, default="default")
    p.add_argument("--reid_model_path", type=str, default="",
                   help="torch ReID checkpoint for the feature trackers: "
                        "a torchreid OSNet when the file name gives its "
                        "width (osnet_x1_0_*.pth), else the DeepSORT CNN's "
                        "ckpt.t7 for deepsort and osnet_x0_25 for the "
                        "other trackers")
    p.add_argument("--reid_capacity", type=int, default=128,
                   help="embed only the top-K score-ordered dets per frame "
                        "(0 = all det_capacity; the serving default 128 "
                        "bounds the ReID stage at the slab capacity)")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--capacity", type=int, default=128)
    p.add_argument("--det_capacity", type=int, default=300)
    p.add_argument("--max_frames", type=int, default=0,
                   help="stop after N ticks (0 = run until all streams "
                        "end)")
    p.add_argument("--save_dir", type=str, default="./serve_result")
    p.add_argument("--state_dir", type=str, default="",
                   help="per-stream tracker-state checkpoints "
                        "(stream_<i>.npz); existing files auto-resume")
    p.add_argument("--state_ckpt_every", type=int, default=100,
                   help="ticks between state checkpoints (also the "
                        "results flush cadence)")
    p.add_argument("--stall_timeout", type=float, default=1.0,
                   help="seconds to wait on a healthy stream's next "
                        "frame before freezing it and ticking without "
                        "it (it rejoins when frames resume)")
    p.add_argument("--prefetch_depth", type=int, default=4,
                   help="frames buffered per stream by its reader "
                        "thread")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda, which must exist)")
    return p.parse_args(argv)


class _StreamReader:
    """Per-stream prefetch thread over a frame iterator.

    Decouples each camera's (possibly blocking) read from the tick
    loop: the thread pulls frames into a bounded queue; the loop asks
    `get(timeout)` for a healthy stream or `poll()` for one already
    marked stalled. `skip` frames are consumed inside the thread (the
    resume fast-forward), so S resuming streams skip in parallel instead
    of serially on the main thread. `close()` ends the thread unless it
    hangs inside the source's own read (it is a daemon for that case)."""

    _DONE = object()

    def __init__(self, src, skip=0, depth=4):
        self._q = queue.Queue(maxsize=max(1, depth))
        self._error = None
        self._closed = threading.Event()
        self._t = threading.Thread(
            target=self._run, args=(src, skip), daemon=True)
        self._t.start()

    def _put(self, item) -> bool:
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, src, skip):
        try:
            for _ in range(skip):
                if next(src, None) is None:
                    return  # exhausted during resume fast-forward
            while True:
                f = next(src, None)
                if f is None or not self._put(f):
                    return
        except Exception as e:  # surfaced on the main thread
            self._error = e
        finally:
            self._put(self._DONE)

    def _classify(self, item):
        if item is self._DONE:
            if self._error is not None:
                raise self._error
            return "done", None
        return "frame", item

    def get(self, timeout):
        """-> ("frame", f) | ("stalled", None) | ("done", None)."""
        try:
            return self._classify(self._q.get(timeout=timeout))
        except queue.Empty:
            return "stalled", None

    def poll(self):
        """Nonblocking get: a stalled stream is checked, never waited
        on, so it cannot re-block the tick while it lags."""
        try:
            return self._classify(self._q.get_nowait())
        except queue.Empty:
            return "stalled", None

    def close(self, timeout=1.0):
        self._closed.set()
        self._t.join(timeout)


def _stream_name(i, obj):
    # URL queries (synth://...?stall=...) don't belong in filenames;
    # neither do separators or unbounded length
    base = os.path.splitext(
        os.path.basename(obj.split("?")[0].rstrip("/")))[0]
    safe = re.sub(r"[^A-Za-z0-9._-]+", "_", base)[:80] or "stream"
    return f"{i:02d}_{safe}"


def _is_live(obj):
    """Webcam/RTSP sources cannot be replayed; files, dirs and synth specs
    can (synth regenerates deterministically from its spec)."""
    if obj.startswith("synth://"):
        return False
    return obj.isdigit() or "://" in obj


def _open_source(obj, max_frames):
    """Frame iterator over one source: a synth:// spec, a live webcam or
    URL (at most ``max_frames`` frames when > 0), an image directory (an
    unreadable image is skipped with a warning: one truncated camera dump
    must not end the stream) or a video file."""
    from ..data import sequence as seqmod

    if obj.startswith("synth://"):
        return iter(seqmod.SynthFrames(obj))
    if _is_live(obj):
        return iter(seqmod.StreamFrames(obj, max_frames=max_frames))
    if os.path.isdir(obj):
        return seqmod.image_dir_frames(obj, on_error="skip")
    return iter(seqmod.VideoFrames(obj))


def main(argv=None):
    opts = parse_args(argv)

    import torch

    from ..data import writer
    from ..models import zoo
    from ..models.convert import load_detector_weights
    from ..models.spec import load_yaml_file
    from ..pipeline import PipelineConfig, TrackingPipeline
    from ..reid import resolve_reid
    from ..trackers import slab as S
    from ..utils import trace

    n = len(opts.streams)
    reid, reid_state_dict = resolve_reid(opts.tracker, opts.reid_model_path)
    pcfg = PipelineConfig(model=opts.model, nc=opts.nc,
                          img_size=opts.img_size, conf_thres=0.001,
                          dtype=opts.dtype, reid=reid,
                          reid_capacity=opts.reid_capacity)
    tcfg = S.TrackerConfig(tracker=opts.tracker,
                           kalman_format=opts.kalman_format,
                           conf_thresh=opts.conf_thresh,
                           capacity=opts.capacity,
                           det_capacity=opts.det_capacity,
                           feature_dim=512 if reid != "none" else 0)
    if opts.model.endswith((".yaml", ".yml")):
        spec = load_yaml_file(opts.model, nc=opts.nc)
    else:
        spec = zoo.get_spec(opts.model, nc=opts.nc)
    state_dict = (load_detector_weights(opts.model_path, spec,
                                        opts.trust_model_path)
                  if opts.model_path else None)
    pipe = TrackingPipeline(pcfg, tcfg, state_dict=state_dict, spec=spec,
                            device=opts.device,
                            reid_state_dict=reid_state_dict)
    on_card = pipe.device.type == "cuda"

    def state_path(i):
        return os.path.join(opts.state_dir, f"stream_{i:02d}.npz")

    # per-stream slabs (auto-resume), stacked over the stream axis;
    # expect_tag pins each checkpoint to its source string
    per_stream = []
    resumed = [False] * n
    for i in range(n):
        if opts.state_dir and os.path.isfile(state_path(i)):
            per_stream.append(pipe.load_tracker_state(
                state_path(i), expect_tag=opts.streams[i]))
            resumed[i] = True
            print(f"stream {i}: resumed state from {state_path(i)}")
        else:
            per_stream.append(pipe.init_tracker())
    slabs = S.TrackSlab(*(torch.stack(xs) for xs in zip(*per_stream)))
    bases = [int(s.frame) for s in per_stream]

    def snapshot(i, slabs):
        return S.TrackSlab(*(x[i].clone() for x in slabs))

    # a finished/failed stream must not keep advancing: its state is
    # frozen here at death and the frozen copy is what gets checkpointed.
    # stalled_state is the same freeze for stalled-but-alive streams --
    # restored into the slab stack when the stream rejoins.
    dead_state = {}
    stalled_state = {}

    def checkpoint_states(slabs):
        if not opts.state_dir:
            return
        os.makedirs(opts.state_dir, exist_ok=True)
        for i in range(n):
            if i in dead_state:
                sl = dead_state[i]
            elif i in stalled_state:
                sl = stalled_state[i]
            else:
                sl = snapshot(i, slabs)
            pipe.save_tracker_state(sl, state_path(i), tag=opts.streams[i])

    def restore_lane(slabs, i, snap):
        """Write a frozen lane back into the stacked slabs
        (rejoin-after-stall only, so off the hot path)."""
        def put(full, lane):
            full = full.clone()
            full[i] = lane
            return full
        return S.TrackSlab(*(put(f, x) for f, x in zip(slabs, snap)))

    stop = {"requested": False}

    def _on_term(signum, frame):
        stop["requested"] = True

    old = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old[sig] = signal.signal(sig, _on_term)
        except ValueError:      # not the main thread: no handlers
            pass

    names = [_stream_name(i, s) for i, s in enumerate(opts.streams)]
    os.makedirs(opts.save_dir, exist_ok=True)
    # frames already in the output txt (an interrupted run's rows):
    # flushes append strictly beyond this, so relaunch never clobbers
    # or duplicates. Only resumed streams inherit old rows -- a fresh
    # (non-resumed) stream's leftover txt is some other run's output in
    # a different id space; appending past its last frame would
    # silently drop this run's rows, so truncate instead.
    written_upto = []
    for i in range(n):
        if resumed[i]:
            written_upto.append(
                writer.last_written_frame(opts.save_dir, names[i]))
        else:
            stale = os.path.join(opts.save_dir, names[i] + ".txt")
            if os.path.isfile(stale):
                os.remove(stale)
            written_upto.append(0)
    results = [[] for _ in range(n)]   # API return value (capped)
    pending = [[] for _ in range(n)]   # rows not yet flushed to disk
    emitted = [0] * n                  # frames harvested this run

    def flush_results():
        for i in range(n):
            rows = [r for r in pending[i] if r[0] > written_upto[i]]
            if rows:
                writer.save_results(opts.save_dir, names[i], rows,
                                    append=True)
                written_upto[i] = rows[-1][0]
            pending[i].clear()

    inflight = None  # (stepped flags, host tensor, copy-done event): 1 tick
    # two pinned buffers, taken in turn: a tick's copy starts before the
    # tick before it is harvested, and that one's buffer is the other
    pinned = []
    copies = 0

    def start_copy(stepped, packed):
        """Begin the packed outputs' D2H: on the card a non-blocking copy
        into a pinned buffer, marked by an event that harvest waits on."""
        nonlocal copies
        if not on_card:
            return stepped, packed, None
        if not pinned:
            pinned.extend(torch.empty(packed.shape, dtype=packed.dtype,
                                      pin_memory=True) for _ in range(2))
        host = pinned[copies % 2]
        copies += 1
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return stepped, host, done

    def harvest(item):
        stepped, host, done = item
        if done is not None:
            trace.count("host_syncs.rows_out")
            done.synchronize()
        out = pipe.unpack_output(host.numpy())
        for i in range(n):
            if not stepped[i]:
                continue
            valid = out.valid[i]
            emitted[i] += 1
            row = (
                bases[i] + emitted[i],
                out.track_id[i][valid].tolist(),
                list(out.tlwh[i][valid]),
                out.cls[i][valid].astype(int).tolist(),
            )
            pending[i].append(row)
            if len(results[i]) < MAX_RETURN_ROWS:
                results[i].append(row)

    def drain():
        nonlocal inflight
        if inflight is not None:
            harvest(inflight)
            inflight = None

    readers = []
    live = [True] * n
    last = [None] * n
    preempted = False
    t0 = time.time()
    tick = 0
    try:
        # replayable sources resume at the checkpointed frame (a live
        # stream resumes at its live point by nature); the fast-forward
        # skip runs inside each reader thread
        for i, s in enumerate(opts.streams):
            readers.append(_StreamReader(
                _open_source(s, opts.max_frames),
                skip=0 if _is_live(s) else bases[i],
                depth=opts.prefetch_depth))
        while not stop["requested"]:
            if opts.max_frames and tick >= opts.max_frames:
                break
            frames, stepped = [], []
            for i in range(n):
                if not live[i]:
                    frames.append(last[i])  # dead lane coasts
                    stepped.append(False)
                    continue
                # a healthy stream is waited on for at most
                # stall_timeout; one already stalled is only polled so
                # it cannot re-block the tick while it lags
                if i in stalled_state:
                    status, f = readers[i].poll()
                else:
                    status, f = readers[i].get(opts.stall_timeout)
                if status == "frame":
                    if i in stalled_state:
                        slabs = restore_lane(
                            slabs, i, stalled_state.pop(i))
                        print(f"stream {i}: rejoined after stall")
                    last[i] = f
                    frames.append(f)
                    stepped.append(True)
                    continue
                if status == "stalled":
                    if i not in stalled_state:
                        stalled_state[i] = snapshot(i, slabs)
                        print(f"stream {i}: stalled -- freezing state "
                              "and ticking without it")
                    frames.append(last[i])
                    stepped.append(False)
                    continue
                # done: source exhausted
                live[i] = False
                dead_state[i] = stalled_state.pop(i, None)
                if dead_state[i] is None:
                    dead_state[i] = snapshot(i, slabs)
                if last[i] is None:
                    # died before yielding a frame this run: a resumed
                    # stream whose source was already exhausted is
                    # simply done (its frozen state carries over); a
                    # never-resumed one is a genuinely empty source --
                    # fail loudly
                    if not resumed[i]:
                        raise SystemExit(
                            f"empty stream: {opts.streams[i]}")
                    print(f"stream {i}: source exhausted before "
                          "resume point -- serving it as finished")
                frames.append(last[i])
                stepped.append(False)
            if not any(live):
                break
            if not any(stepped):
                # every live stream is stalled: no device work this
                # tick; stay responsive to signals and rejoins
                time.sleep(0.02)
                continue
            # a dead-on-arrival lane has no frame of its own; it is not
            # stepped, so any live stream's frame fills its slot
            filler = next(f for f in frames if f is not None)
            frames = [filler if f is None else f for f in frames]
            shapes = {f.shape for f in frames}
            if len(shapes) != 1:
                raise SystemExit(
                    "streams must share one resolution, got "
                    f"{sorted(shapes)}")
            slabs, outs = pipe.process_multistream(slabs, np.stack(frames))
            prev, inflight = inflight, start_copy(
                stepped, pipe.pack_output(outs))
            if prev is not None:
                # previous tick's D2H completes while this tick computes
                harvest(prev)
            tick += 1
            if (opts.state_ckpt_every > 0
                    and tick % opts.state_ckpt_every == 0):
                drain()
                flush_results()
                checkpoint_states(slabs)
        preempted = stop["requested"]

        drain()
        flush_results()
        checkpoint_states(slabs)
    finally:
        for sig, h in old.items():
            signal.signal(sig, h)
        for r in readers:
            r.close()

    dt = time.time() - t0
    total = sum(emitted)
    print(f"served {n} streams on {pipe.device}, {tick} ticks, {total} "
          f"frames in {dt:.1f}s ({total / max(dt, 1e-9):.1f} fps aggregate)"
          + (" [preempted]" if preempted else ""))
    if preempted and opts.state_dir:
        with open(os.path.join(opts.state_dir, "preempted.json"),
                  "w") as f:
            f.write('{"tick": %d}' % tick)
    return results, preempted


if __name__ == "__main__":
    import sys

    _, was_preempted = main()
    if was_preempted:
        sys.exit(75)  # EX_TEMPFAIL: supervisor should relaunch
