"""OpenImuCameraCalibrator in PyTorch for NVIDIA Hopper GPUs.

A port of ``openimucameracalibrator_tpu`` (the JAX package, which stays the
reference): plain tensor code is PyTorch, and the JAX package's two TPU
kernels are hand-written CUDA kernels: the fused densify + Gram step of
the chunk linearizer (``csrc/gram.cu``) and the corner response + NMS of
the detectors (``csrc/corner_nms.cu``), built with ``nvcc`` at first use.
The GoPro MP4 telemetry reader is host C++ (``csrc/gpmf_reader.cc``),
built with ``g++`` at first use.

Importing the package has no side effects: subpackages are imported by
their users, and nothing is built until it is first used.
"""

__version__ = "0.1.0"
