"""pings_tpu_torch — the PyTorch + CUDA port of ``pings_tpu``.

A second package beside the JAX one, held against it module by module
(``tests/test_torch_*.py``). Module names mirror ``pings_tpu`` so each
module's counterpart is easy to find. The port imports torch, numpy and
yaml only: never JAX and nothing of ``pings_tpu``.

Float32 is pinned: TF32 matmuls and convolutions are turned off, for the
reason ``pings_tpu/__init__.py`` gives (reduced-precision matmuls make the
joint GS+SDF training collapse).

Every entry point takes ``device=`` and defaults to ``"cuda"``. Without a
card that raises; the CPU runs only when the caller asks for it.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device with no card
    present raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
