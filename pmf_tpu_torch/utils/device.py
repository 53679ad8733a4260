"""Device selection for the port.

Every entry point takes ``device=``.  ``None`` means the CUDA card and
raises when there is none: the CPU runs only when the caller names it
(``device="cpu"``, as the tests do), so no run silently measures or
trains on the host.  Float32 matrix products and convolutions are kept
in full float32 (TF32 off) so the card's numbers compare with the JAX
reference's f32 ``HIGHEST`` dots.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the host")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is absent")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def mark(tensor: torch.Tensor):
    """A wait for the device work queued so far on ``tensor``'s stream.
    Work queued after this call is not waited for, unlike
    ``torch.cuda.synchronize``."""
    if not tensor.is_cuda:
        return lambda: None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(tensor.device))
    return done.synchronize


class ScalarReader:
    """Reads 0-d tensors to the host without waiting for device work queued
    after the read was requested (``float()`` on a CUDA tensor queues its
    copy behind all work queued so far).  The copy lands in one pinned
    buffer allocated at the first read: allocating pinned memory
    synchronizes the device."""

    def __init__(self) -> None:
        self._host: torch.Tensor | None = None

    def start(self, *scalars: torch.Tensor):
        """Queue the copy now; the returned function waits for that copy
        alone and gives the values as floats.  Read its result before the
        next ``start``, which reuses the buffer."""
        vals = torch.stack([s.detach() for s in scalars])
        if not vals.is_cuda:
            return vals.tolist
        if self._host is None or self._host.shape != vals.shape \
                or self._host.dtype != vals.dtype:
            self._host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
        host = self._host
        host.copy_(vals, non_blocking=True)
        copied = mark(vals)

        def result() -> list:
            copied()
            return host.tolist()

        return result
