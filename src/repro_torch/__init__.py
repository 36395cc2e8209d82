"""PyTorch / CUDA port of the learned metric index (LMI) for proteins.

The package mirrors the layout of the JAX package ``repro`` module for
module, so each file has an obvious counterpart there, but it imports
only ``torch`` and ``numpy``. Plain tensor code is PyTorch; every Pallas
TPU kernel on the ported path is a hand-written CUDA C++ kernel for
Hopper (``sm_90a``) under ``repro_torch/kernels/*/csrc``, built with
``nvcc`` at first use and bound with ``ctypes``.

Entry points run on the card: a ``device`` argument defaults to
``"cuda"`` and raises when no card is present. The CPU is used only when
the caller asks for it (``device="cpu"``), as the tests do; there each
kernel wrapper runs its plain PyTorch version.

Float32 products stay in full float32 everywhere: TF32 is switched off
for both matmuls and cuDNN here, where the port starts, because the
leaf log-probability panel and the K-Means distances are compared with
the JAX reference at float32 tolerances.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another. Raises when CUDA is asked for (explicitly or by
    default) and no card is present, instead of quietly using the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
