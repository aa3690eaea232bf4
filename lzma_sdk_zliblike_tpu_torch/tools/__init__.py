"""Microbenchmarks of the range coder's bit call on the card.

The counterparts of the JAX package's ``tools/dev_v12_probe.py`` (P1) and
``tools/compact_probe.py`` (P2): the same synthetic work, bit for bit, as
kernels written for Hopper, timed with CUDA events.  They decode nothing;
they measure what one bit call costs per stream in several layouts, the
number a faster decode kernel starts from.

    python -m lzma_sdk_zliblike_tpu_torch.tools.dev_v12_probe [variant ...]
    python -m lzma_sdk_zliblike_tpu_torch.tools.compact_probe [kernel|all] [iters]
"""

from __future__ import annotations

import torch

from ..utils.errors import UnsupportedError


def probe_device(device) -> torch.device:
    """``device`` as a torch.device; raises UnsupportedError for a CUDA
    device when there is no card, and for any device but cuda and cpu."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise UnsupportedError("no CUDA device; pass device='cpu' to run the "
                               "plain version on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise UnsupportedError(f"unsupported device {device}")
    return device


def best_ms(launch, reps: int = 3, before=None) -> float:
    """The shortest of ``reps`` timed calls of ``launch()`` on the card, in
    ms by CUDA events around each call, after one warm-up call.
    ``before(rep)`` runs ahead of each timed call, outside its events."""
    launch()
    torch.cuda.synchronize()
    best = float("inf")
    for rep in range(reps):
        if before is not None:
            before(rep)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best
