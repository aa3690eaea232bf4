"""Entry point ``lzma2_stream``: a file's block payloads joined as one raw
LZMA2 stream, decoded by ``lzma2_uncompress(stream, dict_prop,
engine="device", device=...)``.

A file's image is ``pool.join`` of its blocks' payloads; the warm-up image
is the first chunk of each block of the first file, joined the same way.
The control decodes each dict-reset group with liblzma and joins the
groups in lane order (``Control``).
"""

from __future__ import annotations

from port_bench import lzma2_chunks
from port_bench import pool as P

CALL = "lzma2_uncompress"
TIMED = ()


def images(pool, files, payloads) -> tuple[list, bytes]:
    streams = [P.join(payloads[b] for b in f) for f in files]
    warm = P.join(lzma2_chunks.first_chunk(payloads[b]) for b in files[0])
    return streams, warm


def work(stream: bytes) -> tuple[int, int]:
    return lzma2_chunks.work_bytes(stream)


class Port:
    """The system under test: the port's ``lzma2_uncompress`` on K1."""

    def __init__(self, config: dict, device: str):
        from lzma_sdk_zliblike_tpu_torch import api
        from lzma_sdk_zliblike_tpu_torch.ops import group_decode
        from lzma_sdk_zliblike_tpu_torch.utils.trace import TRACE
        self.device = device
        self.prop = P.dict_prop(config["dict_size"])
        self._api, self._G, self._trace = api, group_decode, TRACE

    def __call__(self, stream: bytes) -> bytes:
        return self._api.lzma2_uncompress(stream, self.prop, engine="device",
                                          device=self.device)

    def reset_counters(self) -> None:
        self._G.launches = 0
        self._trace.reset()

    def counters(self) -> dict:
        snap = self._trace.snapshot()
        return {"k1_launches": self._G.launches,
                "host_fallback_groups": snap.get(
                    "scheduler.host_fallback_groups", 0),
                "lane_retries": snap.get("scheduler.lane_retries", 0)}


def lane_order(outs: list, packed: list) -> bytes:
    """``outs`` joined in lane order, largest packed first, as the
    scheduler places groups on K1's lanes (``parallel/scheduler._pack_lanes``):
    the ordered join left out."""
    lanes = sorted(range(len(outs)), key=lambda g: -packed[g])
    return b"".join(outs[g] for g in lanes)


class Control:
    """The control: liblzma per dict-reset group, joined in lane order."""

    def __init__(self, config: dict):
        self.dict_size = config["dict_size"]

    def __call__(self, stream: bytes) -> bytes:
        import lzma
        groups = []
        for c in lzma2_chunks.chunks(stream):
            if c.dict_reset:
                groups.append([c.start, c.end, 0])
            groups[-1][1] = c.end
            groups[-1][2] += c.packed
        filters = [{"id": lzma.FILTER_LZMA2, "dict_size": self.dict_size}]
        outs = [lzma.decompress(stream[a:b] + b"\x00", lzma.FORMAT_RAW,
                                filters=filters) for a, b, _ in groups]
        return lane_order(outs, [g[2] for g in groups])
