"""lldslam_tpu_torch — the PyTorch/CUDA port of lldslam_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module layout and
function names so each counterpart is easy to find. It runs the synchronous
stereo SLAM path (frame build, tracking step, keyframe mapping with local BA)
as plain PyTorch on tensors; the two Pallas kernels of the JAX package are
hand-written CUDA kernels here (`csrc/`, bound in `ops/patch_sample.py` and
`ops/match_best2.py`).

The JAX package (lldslam_tpu) is the reference this port is tested against;
this package never imports it, nor JAX.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry is correctness-critical (pose composition, triangulation, normal
# equations at tens of metres): keep every float32 matmul and convolution in
# full float32, as lldslam_tpu/__init__.py forces "highest" precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
