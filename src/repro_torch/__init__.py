"""PyTorch/CUDA port of the execution-idle reproduction, for one NVIDIA H100.

Imports ``torch`` and numpy only. The serving path (dense models under the
Algorithm-1 controller with 1 Hz execution-idle telemetry) runs its RMSNorm,
prefill attention and decode attention through hand-written Hopper kernels
(``csrc/``), built by ``kernels/_build.py`` at first use.
"""
