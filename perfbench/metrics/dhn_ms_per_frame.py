"""DeepMOT's Deep Hungarian Net a frame: the profiler's time of the
DHN's kernels in the traced window, over the frames. Under the tracker
step's CUDA graph no span can see them, so the kernels are picked by
name, as a trace of the DHN alone at hidden 256 on 128 x 48 on an H100
names them (torch 2.11, CUDA 12.8): cuBLAS's ``gemvx`` at the template
the recurrent 768 x 256 mat-vec of each GRU step takes (the Kalman
filter's batched products take another), cuDNN's ``elemWiseRNNcell``
(the GRU cell), the float32 GEMMs of the input projections and the head
at the tiles cuBLAS picks for them, and ``gemv2T_kernel_val`` (the
head's last layer). PyTorch's elementwise kernels around it (copies,
the bias add, the zero state, the sigmoid: under 0.1% of its time) and
the 32 x 32 float32 GEMM tile, which the Kalman filter's products use
too, are left out. A card test pins the pattern against traces of the
DHN alone, of a deepmot step without a DHN and of yolov7-w6's detector
batch.

The rule for kernels to come: a kernel written for the DHN (CUDA C++ or
Triton) carries a function name that begins with ``dhn_`` or ``gru_``
(after any ``void`` and namespace), which the pattern also takes, so a
hand-written DHN keeps being read as the DHN. The sum is kernel time,
not wall time: a replayed graph runs the GRU's two directions on
parallel branches, so their kernels overlap and count twice; a DHN that
runs them one after the other reads the same sum in more wall time."""

import re

SPANS = {}

DHN = re.compile(r"gemvx::kernel<int, int, float, float, float, float, false, "
                 r"true, true, false, 7, |elemWiseRNNcell|gemv2T_kernel_val|"
                 r"_f32f32_f32f32_f32_tn_n_tilesize(?:64x64x8|128x32x8)_|"
                 r"cutlass_80_simt_sgemm_128x32_8x5_tn|"
                 r"(?:^|[ :])(?:dhn|gru)_")


def kernel_s(r) -> float:
    """Seconds of the DHN's kernels in the traced window."""
    return sum(s for n, s in r.device_ops.items() if DHN.search(n))


def read(r):
    s = kernel_s(r)
    return 1e3 * s / r.frames if s > 0 and r.frames else None
