"""The control of the comparison that decides ``correct``.

The configurations state no precision, so the control breaks a guarantee
they state: that a file's blocks come back in the file's order.  It puts
the plain reference decoder (liblzma, through Python's ``lzma``) in the
port's place, decodes each dict-reset group (each ``.xz`` block) alone,
and joins them in lane order, largest packed first, as the scheduler
places them on K1's lanes (``parallel/scheduler._pack_lanes``): the
ordered join left out, the step a later change to the join could be
tempted to drop.  The decoder is the entry point's ``Control``
(``entries/<entry>.py``).

    python3 port_bench/control.py --workload <cell> --seed <n> \
        --seconds <s>

runs the cell's own files and window with the control and prints the
result line; ``correct`` has to come out false.  The benchmark's own runs
never run it.
"""

import time

T0 = time.perf_counter()


def main(argv=None) -> int:
    from port_bench import bench, spec
    args = bench.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    result = bench.run_cell(
        cell, args.seed, args.seconds, False, t0=T0, device="cpu",
        decoder=spec.entry(cell.entry).Control(cell.config))
    bench.emit(result)
    return 0


if __name__ == "__main__":
    import os
    import sys
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
