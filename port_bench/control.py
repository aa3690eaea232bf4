"""The control of the comparison that decides ``correct``.

The configurations state no precision, so the control breaks a guarantee
they state: that a file's blocks come back in the file's order.  It puts
the plain reference decoder (liblzma, through Python's ``lzma``) in the
port's place, decodes each dict-reset group alone, and joins the groups in
lane order, largest packed group first, as the scheduler places them on
K1's lanes (``parallel/scheduler._pack_lanes``): the ordered join left
out, the step a later change to the join could be tempted to drop.

    python3 port_bench/control.py --workload <cell> --seed <n> \
        --seconds <s>

runs the cell's own files and window with the control and prints the
result line; ``correct`` has to come out false.  The benchmark's own runs
never run it.
"""

import time

T0 = time.perf_counter()


class UnorderedJoin:
    """liblzma per dict-reset group, joined in lane order."""

    def __init__(self, dict_size: int):
        self.dict_size = dict_size

    def __call__(self, stream: bytes, dict_prop: int) -> bytes:
        import lzma
        from port_bench import lzma2_chunks
        groups = []
        for c in lzma2_chunks.chunks(stream):
            if c.dict_reset:
                groups.append([c.start, c.end, 0])
            groups[-1][1] = c.end
            groups[-1][2] += c.packed
        filters = [{"id": lzma.FILTER_LZMA2, "dict_size": self.dict_size}]
        outs = [lzma.decompress(stream[a:b] + b"\x00", lzma.FORMAT_RAW,
                                filters=filters) for a, b, _ in groups]
        lanes = sorted(range(len(groups)), key=lambda g: -groups[g][2])
        return b"".join(outs[g] for g in lanes)


def main(argv=None) -> int:
    from port_bench import bench, spec
    args = bench.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    result = bench.run_cell(
        cell, args.seed, args.seconds, False, t0=T0, device="cpu",
        decoder=UnorderedJoin(cell.config["dict_size"]))
    bench.emit(result)
    return 0


if __name__ == "__main__":
    import os
    import sys
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
