"""Zlib-like one-call API of the PyTorch/CUDA port: LZMA2 decode.

The counterpart of the JAX package's ``lzma2_uncompress`` (``api.py:98-126``)
with the port's three engines: the group-decode kernel K1 alone under the
budget-sized batch shape (``"device"``), host threads and K1 on one group
queue (``"hybrid"``), and host threads alone (``"host"``).
"""

from __future__ import annotations

import torch

from .utils.errors import UnsupportedError

ENGINES = ("device", "hybrid", "host")


def check_device(device) -> torch.device:
    """``device`` as a torch.device the kernels run on; raises
    UnsupportedError for another type, or for CUDA with no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise UnsupportedError("no CUDA device; pass device='cpu' to run the "
                               "kernels' plain versions on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise UnsupportedError(f"unsupported device {device}")
    return device


def lzma2_uncompress(stream: bytes, dict_prop: int, *, engine="device",
                     device="cuda", threads: int | None = None,
                     progress=None) -> bytes:
    """Decompress a raw LZMA2 stream.

    ``engine``: ``"device"`` (the default) decodes the dict-reset groups
    with K1 on ``device``; ``"hybrid"`` runs host threads and K1 on one
    group queue (``parallel/hybrid.py``); ``"host"`` decodes on ``threads``
    host threads (``parallel/host_pool.decode_lzma2_mt``).  ``device="cuda"``
    (the default) launches the CUDA kernel and raises when there is no card;
    ``device="cpu"`` runs the kernel's plain PyTorch version.  ``threads``
    is the host engines' thread count (None: every core).

    ``progress(in_bytes, out_bytes)`` is called as groups complete; returning
    False aborts with ``ProgressAborted``.  The hybrid and host engines report
    per group.  The device engine has no per-group hook, so a ``progress``
    callback there sends the call to the host engine instead, as the JAX
    package does (abort semantics preserved).

    Each group's (lc, lp, pb) comes from the stream: the scheduler launches
    each props in its own batch.
    """
    from .models.lzma2 import framing

    if engine not in ENGINES:
        raise UnsupportedError(f"unknown engine {engine!r}; one of {ENGINES}")
    if engine == "host" or (engine == "device" and progress is not None):
        from .parallel.host_pool import decode_lzma2_mt
        return decode_lzma2_mt(stream, dict_prop, threads=threads,
                               progress=progress)
    if engine == "hybrid":
        from .parallel.hybrid import decode_lzma2_hybrid
        return decode_lzma2_hybrid(stream, dict_prop, threads=threads,
                                   device=device, progress=progress)
    from .parallel.scheduler import BatchedLzma2Decoder
    from .utils.memory import shape_for_groups

    device = check_device(device)
    framing.decode_dict_prop(dict_prop)  # validate
    groups = framing.split_groups(framing.scan(stream)[0])
    dec = BatchedLzma2Decoder(shape_for_groups(groups, device=device),
                              device=device)
    return b"".join(dec.decode_groups(stream, groups))
