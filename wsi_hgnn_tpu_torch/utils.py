"""Device resolution, CUDA numerics flags, the numpy <-> torch boundary and
the reference's logger."""
from __future__ import annotations

import logging
from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the card. Asking for CUDA without one raises: the port
    never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_cuda_numerics() -> None:
    """Full-f32 products and convolutions on the card.

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits), which moves conv features past 1e-4 and can change KNN
    neighbour sets; cuBLAS's default is already full f32. Both flags are
    set explicitly at every entry point so the f32 numerics are stated,
    not inherited. bf16 work is unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_torch(arr, device: torch.device, dtype: Optional[torch.dtype] = None
             ) -> torch.Tensor:
    """numpy (or array-like) -> tensor on `device`; pinned, asynchronous
    copy for host->card transfers."""
    t = torch.from_numpy(np.asarray(arr, order="C"))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def get_logger() -> logging.Logger:
    """The reference's `utils.get_logger`: "main-logger" at INFO with one
    stream handler."""
    logger = logging.getLogger("main-logger")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        handler = logging.StreamHandler()
        fmt = ("[%(asctime)s %(levelname)s %(filename)s line %(lineno)d "
               "%(process)d] %(message)s")
        handler.setFormatter(logging.Formatter(fmt))
        logger.addHandler(handler)
    return logger
