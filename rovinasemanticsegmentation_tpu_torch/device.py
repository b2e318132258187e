"""Device selection for the port: explicit, never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cpu"``, ``"cuda"`` or ``"cuda:N"`` -> a usable ``torch.device``.

    ``"cuda"`` on a machine without a GPU raises instead of becoming the CPU:
    the CPU runs the kernels' plain versions, which is a different program.
    Resolving a CUDA device also pins float32 matmuls and convolutions to full
    float32 (TF32 off), the counterpart of the reference's
    ``precision=HIGHEST`` geometry.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(name)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist"
            )
        if dev.index is None:  # one canonical name per card
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r}; use cpu or cuda")
    return dev
