"""Host <-> device copies that never block the serving stream.

A plain ``torch.tensor(arr, device="cuda")`` copies from pageable host
memory, which makes the host wait for every launch queued on the stream
before it — under async dispatch, for the whole in-flight step.  These
helpers copy through a fresh host buffer of their own (pinned on CUDA)
with ``non_blocking=True``, so the host queues the copy and goes on, and
the caller may change its array at once: the device reads the buffer,
never the array.  Off CUDA the same calls are plain synchronous copies.
"""
from __future__ import annotations

import numpy as np
import torch


def to_device(arr, device, dtype=None) -> torch.Tensor:
    """Copy host data ``arr`` to ``device`` without blocking the host.

    The data is first copied into a host tensor of its own, so the device
    copy can never see a later change of ``arr``.  On CUDA that tensor is
    pinned (one host copy), and PyTorch's caching host allocator does not
    reuse it before the non-blocking copy out of it has run."""
    device = torch.device(device)
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None:
        host = host.to(dtype)
    host = host.pin_memory() if device.type == "cuda" else host.clone()
    return host.to(device, non_blocking=True)


class HostCopy:
    """Non-blocking device -> host copies of some tensors, each into a
    host buffer of its own (pinned on CUDA), with an event recorded on
    the current stream after them.  ``numpy()`` waits on that event
    alone — not on the launches queued since — and returns the
    buffers."""

    def __init__(self, *tensors):
        self.host = []
        self.event = None
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            h.copy_(t, non_blocking=True)
            self.host.append(h)
        cuda = [t.device for t in tensors if t.is_cuda]
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(cuda[0]))

    def numpy(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]
