"""PyTorch/CUDA port of lzma_sdk_zliblike_tpu: LZMA2 on an NVIDIA GPU.

Dict-reset groups of a raw LZMA2 stream decode lane-parallel in a CUDA
kernel written for Hopper (sm_90a, K1), alone, beside host threads on one
group queue (``decode_lzma2_hybrid``), or on host threads alone
(``decode_lzma2_mt``); device-coded encode parses groups on host threads and
range-codes them lane-parallel in a second one (K2), alone or beside host
encoders on one group queue (``encode_lzma2_hybrid``); device-assisted
encode finds match candidates on the card (X2, a CUDA kernel) for the host
coder (``encode_lzma2_device``).  ``containers/xz.py``
reads and writes .xz images, its blocks decoded through the same engines.
``decode_groups_distributed`` / ``encode_groups_distributed`` deal the
groups over the ranks of a ``torch.distributed`` process group, K1 on each
rank's card (``parallel/distributed.py``).  ``device="cpu"`` runs the kernels' plain PyTorch versions instead.
The zlib-like one-calls ``compress``/``uncompress`` (raw LZMA, ``.lzma`` and
``.lzma86`` in ``containers/``, ``cli/lzma_util.py``) and ``lzma2_compress``
run on the host.  ``ops/checksum.py`` (X3) computes CRC32/CRC64 and
``ops/device_filters.py`` (X4) the batched branch and delta filters on the
card.
"""

from .api import compress, lzma2_compress, lzma2_uncompress, uncompress
from .parallel.device_encode import (encode_lzma2_device,
                                     encode_lzma2_device_coded,
                                     encode_lzma2_hybrid)
from .parallel.distributed import (decode_groups_distributed,
                                   encode_groups_distributed)
from .parallel.host_pool import decode_lzma2_mt
from .parallel.hybrid import decode_lzma2_hybrid
from .utils.errors import (ArchiveError, CrcError, DataError, InputEofError,
                           LzmaError, MemError, OutputEofError, ParamError,
                           ProgressAborted, UnsupportedError)

__all__ = ["compress", "uncompress", "lzma2_compress", "lzma2_uncompress",
           "encode_lzma2_device_coded",
           "encode_lzma2_hybrid", "encode_lzma2_device",
           "decode_lzma2_mt", "decode_lzma2_hybrid",
           "decode_groups_distributed", "encode_groups_distributed",
           "LzmaError",
           "DataError", "CrcError", "InputEofError", "OutputEofError",
           "MemError", "ParamError", "ProgressAborted", "ArchiveError",
           "UnsupportedError"]
