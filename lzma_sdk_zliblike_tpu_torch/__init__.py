"""PyTorch/CUDA port of lzma_sdk_zliblike_tpu: LZMA2 on an NVIDIA GPU.

Dict-reset groups of a raw LZMA2 stream decode lane-parallel in a CUDA
kernel written for Hopper (sm_90a, K1); device-coded encode parses groups
on host threads and range-codes them lane-parallel in a second one (K2).
``device="cpu"`` runs the kernels' plain PyTorch versions instead.
"""

from .api import lzma2_uncompress
from .parallel.device_encode import encode_lzma2_device_coded
from .utils.errors import (DataError, InputEofError, LzmaError, ParamError,
                           UnsupportedError)

__all__ = ["lzma2_uncompress", "encode_lzma2_device_coded", "LzmaError",
           "DataError", "InputEofError", "ParamError", "UnsupportedError"]
