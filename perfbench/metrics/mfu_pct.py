"""The whole step's share of the card's peak: the time the work of the
frames done would take at the peak of the precision each part runs in,
over the window. The work is perfbench's own count over the published
architectures: the detector (``pipeline.model``) on each frame it ran
on, at the letterboxed size, in ``pipeline.dtype``, and the ReID network (``pipeline.reid``)
on the crop of each valid detection, in float32, whatever the program
pads to."""

from perfbench.harness import yardstick
from perfbench.reference.detector import (Yolo, architecture,
                                          letterbox_geometry)
from perfbench.reference.reid import network


def read(r):
    p = r.config["pipeline"]
    if not r.detected:
        return None                 # the detector did not run
    arch = architecture(p["model"])
    canvas, _, _ = letterbox_geometry(
        (r.traffic["height"], r.traffic["width"]), p["img_size"],
        max(arch.STRIDES))
    at_peak = (yardstick.conv_flops(Yolo(arch, p["nc"]),
                                    (1, 3) + tuple(canvas)) * r.detected
               / yardstick.peak_flops(p["dtype"]))
    if p.get("reid", "none") != "none":
        net = network(p["reid"])
        at_peak += (yardstick.conv_flops(net.Net(), (1, 3) + net.CROP_HW)
                    * r.detections / yardstick.peak_flops("float32"))
    return 100.0 * at_peak / r.window_s
