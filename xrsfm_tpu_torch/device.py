"""Device resolution and the float32 precision scope of the port.

Every entry point of the port takes an explicit ``device``.  A CUDA device
that is not there is an error: nothing falls back to the CPU.  CPU runs
(the tests) name ``"cpu"`` themselves.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device` ("cuda", "cuda:1", "cpu" or a device);
    raises if it names CUDA and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {device!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


@contextlib.contextmanager
def full_precision():
    """float32 matmuls and convolutions in full float32 inside the scope.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits; the JAX reference runs at "highest" precision.
    Both TF32 switches are turned off here and restored on exit."""
    prev_matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled,
            benchmark=torch.backends.cudnn.benchmark,
            deterministic=torch.backends.cudnn.deterministic,
            allow_tf32=False,
        ):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_matmul
