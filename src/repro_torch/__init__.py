"""PyTorch + CUDA port of the MapReduce SVM (Çatak 2014) for one NVIDIA H100.

The module layout mirrors the JAX package ``repro`` file for file
(``repro_torch/core/svm.py`` ↔ ``repro/core/svm.py``). The port never
imports JAX or ``repro``; it keeps its own copies of what it needs.

Device rule: entry points put numpy inputs on ``cuda`` unless the
caller passes ``device=``; with no card and no ``device="cpu"`` they
raise instead of quietly running on the CPU (:mod:`repro_torch.device`).
The hand-written kernels run for CUDA tensors; CPU tensors take their
plain PyTorch versions (:mod:`repro_torch.kernels.ops`).

TF32 is switched off here, once for the whole package: the reference
accumulates its matrix products in full float32.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
