"""OpenImuCameraCalibrator in PyTorch for NVIDIA Hopper GPUs.

A port of ``openimucameracalibrator_tpu`` (the JAX package, which stays the
reference): plain tensor code is PyTorch, and the one TPU kernel on the
continuous-time calibration path (the fused densify + Gram step of the
chunk linearizer) is a hand-written CUDA kernel (``csrc/gram.cu``), built
with ``nvcc`` at first use.

Importing the package has no side effects: subpackages are imported by
their users, and no kernel is built until one is launched.
"""

__version__ = "0.1.0"
