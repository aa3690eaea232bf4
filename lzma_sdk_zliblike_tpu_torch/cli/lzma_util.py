"""``lzma e|d`` CLI — the reference's LzmaUtil (``LzmaUtil.c``).

Usage:  python -m lzma_sdk_zliblike_tpu_torch.cli.lzma_util <e|d> in out [opts]

The port's copy of the JAX package's ``cli/lzma_util.py``, on the host.
``--engine`` takes auto, native or python; a device engine name (tpu,
device, hybrid) exits with UnsupportedError's code, 4, where the JAX CLI
runs the pure-Python codec instead.  Exit codes: 0 ok, an LzmaError's SRes
code, 8 for an I/O error.
"""

from __future__ import annotations

import argparse
import sys

from ..containers import lzma_file
from ..models.lzma.spec import LzmaProps
from ..utils.errors import LzmaError
from ..api import default_dict_size


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="lzma", description="LZMA file compressor (.lzma format)")
    ap.add_argument("command", choices=["e", "d"],
                    help="e: encode file, d: decode file")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-l", "--level", type=int, default=5)
    ap.add_argument("--dict-size", type=int, default=None)
    ap.add_argument("--lc", type=int, default=3)
    ap.add_argument("--lp", type=int, default=0)
    ap.add_argument("--pb", type=int, default=2)
    ap.add_argument("--end-mark", action="store_true",
                    help="write end marker instead of size header")
    ap.add_argument("--effort", type=int, default=9,
                    help="9 = greedy/lazy; 10 = optimal parse")
    ap.add_argument("--engine", default="auto",
                    help="auto, native or python (raw LZMA runs on the host)")
    args = ap.parse_args(argv)

    try:
        with open(args.input, "rb") as f:
            data = f.read()
        if args.command == "e":
            props = LzmaProps(lc=args.lc, lp=args.lp, pb=args.pb,
                              dict_size=args.dict_size
                              or default_dict_size(args.level))
            from ..engine import lzma_raw_encode
            from ..containers.lzma_file import build_header
            body = lzma_raw_encode(data, props,
                                   write_end_mark=args.end_mark,
                                   effort=args.effort, engine=args.engine)
            out = build_header(props,
                               None if args.end_mark else len(data)) + body
        else:
            out = lzma_file.decode(data, engine=args.engine)
        with open(args.output, "wb") as f:
            f.write(out)
    except LzmaError as e:
        print(f"error: {e}", file=sys.stderr)
        return e.sres
    except OSError as e:
        print(f"io error: {e}", file=sys.stderr)
        return 8
    return 0


if __name__ == "__main__":
    sys.exit(main())
