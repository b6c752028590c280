"""clip_calibration_tpu_torch — the PyTorch/CUDA port of clip_calibration_tpu.

Same calibrated open-vocabulary evaluation of a frozen CLIP (zero-shot and
CoOp prompts, Distance-Aware Calibration, ECE/MCE/ACE/PIECE), written for
an NVIDIA Hopper GPU: plain tensor code is PyTorch, and the fused
attention of both towers is a hand-written CUDA kernel (``csrc/``).
Every entry point takes an explicit ``device`` and defaults to ``cuda``.
"""

__version__ = "0.1.0"
