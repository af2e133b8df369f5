"""Hand-written Hopper kernels of the port, one per TPU kernel on its path.

Each kernel ships: ``csrc/<name>.cu`` (CUDA C++ for sm_90a), a launch
module (``svm_step.py``, ``hinge_score.py``), a plain PyTorch version
in ``ref.py`` and a checked, counted wrapper in ``ops.py``.
"""
from repro_torch.kernels.ops import LAUNCHES, cd_solve, hinge_scores, reset_launches

__all__ = ["LAUNCHES", "cd_solve", "hinge_scores", "reset_launches"]
