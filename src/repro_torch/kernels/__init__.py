"""Hand-written Hopper kernels of the port, one per TPU kernel on its path.

Each kernel ships: ``csrc/<name>.cu`` (CUDA C++ for sm_90a), a launch
module (``svm_step.py``, ``hinge_score.py``, ``gram.py`` for the dense
and sparse Gram, ``gram_solve.py``, ``decode_attention.py``), a plain PyTorch version in
``ref.py`` and a checked, counted wrapper in ``ops.py``.
"""
from repro_torch.kernels.ops import (LAUNCHES, cd_solve, cd_solve_gram,
                                     decode_attention, gram, hinge_scores,
                                     reset_launches, sparse_gram,
                                     sparse_gram_scores)

__all__ = ["LAUNCHES", "cd_solve", "cd_solve_gram", "decode_attention",
           "gram", "hinge_scores", "reset_launches", "sparse_gram",
           "sparse_gram_scores"]
