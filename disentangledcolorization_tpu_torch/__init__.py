"""DISCO on PyTorch + CUDA: the port of ``disentangledcolorization_tpu`` to an NVIDIA H100.

The JAX package beside this one is the reference. This package mirrors its
module layout and names, so each module here has a counterpart there with the
same path. It imports ``torch`` and never ``jax``, ``flax``, ``cv2`` or the JAX
package.

Layout conventions, kept from the JAX package so that tests compare like with
like:
  * public functions take and return NHWC images and feature maps;
  * token sequences are (batch, tokens, channels);
  * parameter names follow the reference torch ``state_dict`` keys.

Every op that the JAX package wrote as a Pallas kernel is a hand-written CUDA
kernel here (``csrc/``), behind a wrapper that launches it for CUDA tensors and
runs its plain PyTorch version only for CPU tensors.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when the card is asked for and absent:
    nothing here carries on on the CPU unless the caller said ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev
