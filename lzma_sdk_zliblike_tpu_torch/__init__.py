"""PyTorch/CUDA port of lzma_sdk_zliblike_tpu: LZMA2 on an NVIDIA GPU.

Dict-reset groups of a raw LZMA2 stream decode lane-parallel in a CUDA
kernel written for Hopper (sm_90a, K1), alone, beside host threads on one
group queue (``decode_lzma2_hybrid``), or on host threads alone
(``decode_lzma2_mt``); device-coded encode parses groups on host threads and
range-codes them lane-parallel in a second one (K2), alone or beside host
encoders on one group queue (``encode_lzma2_hybrid``); device-assisted
encode finds match candidates on the card (X2, torch ops) for the host
coder (``encode_lzma2_device``).  ``containers/xz.py``
reads and writes .xz images, its blocks decoded through the same engines.
``device="cpu"`` runs the kernels' plain PyTorch versions instead.
"""

from .api import lzma2_uncompress
from .parallel.device_encode import (encode_lzma2_device,
                                     encode_lzma2_device_coded,
                                     encode_lzma2_hybrid)
from .parallel.host_pool import decode_lzma2_mt
from .parallel.hybrid import decode_lzma2_hybrid
from .utils.errors import (ArchiveError, CrcError, DataError, InputEofError,
                           LzmaError, ParamError, ProgressAborted,
                           UnsupportedError)

__all__ = ["lzma2_uncompress", "encode_lzma2_device_coded",
           "encode_lzma2_hybrid", "encode_lzma2_device",
           "decode_lzma2_mt", "decode_lzma2_hybrid", "LzmaError",
           "DataError", "CrcError", "InputEofError", "ParamError",
           "ProgressAborted", "ArchiveError", "UnsupportedError"]
