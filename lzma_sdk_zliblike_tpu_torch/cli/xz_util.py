"""``xz``-style CLI over the port's .xz implementation.

Usage:
  python -m lzma_sdk_zliblike_tpu_torch.cli.xz_util c in out.xz [--check c]
  python -m lzma_sdk_zliblike_tpu_torch.cli.xz_util d in.xz out
      [--engine device|hybrid|host] [--device cuda|cpu]
  python -m lzma_sdk_zliblike_tpu_torch.cli.xz_util l in.xz   (block index)

``d`` decodes on the card by default (``--engine device``: kernel K1);
``--device cpu`` runs the kernel's plain PyTorch version.  ``c`` encodes on
the host; a device engine there exits with SZ_ERROR_UNSUPPORTED.  Errors
exit with the reference's SRes code.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..api import ENGINES
from ..containers import xz
from ..utils.errors import LzmaError


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="xzutil")
    ap.add_argument("command", choices=["c", "d", "l"])
    ap.add_argument("input")
    ap.add_argument("output", nargs="?")
    ap.add_argument("--check", default="crc32",
                    choices=["none", "crc32", "crc64", "sha256"])
    ap.add_argument("--dict-size", type=int, default=1 << 24)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--engine", default=None, choices=ENGINES,
                    help="decode: device (default), hybrid or host; "
                         "encode: host only")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--effort", type=int, default=9,
                    help="1-9 fast..best lazy; 10 = optimal parse")
    ap.add_argument("--threads", type=int, default=None,
                    help="block-parallel encode threads (0 = all cores)")
    args = ap.parse_args(argv)
    if args.command in "cd" and args.output is None:
        ap.error(f"{args.command} needs an output file")
    try:
        with open(args.input, "rb") as f:
            data = f.read()
        if args.command == "c":
            threads = args.threads
            if threads == 0:
                threads = os.cpu_count() or 1
            out = xz.encode(data, check=args.check, dict_size=args.dict_size,
                            block_size=args.block_size, effort=args.effort,
                            threads=threads, engine=args.engine or "host")
            with open(args.output, "wb") as f:
                f.write(out)
        elif args.command == "d":
            out = xz.decode(data, engine=args.engine or "device",
                            device=args.device)
            with open(args.output, "wb") as f:
                f.write(out)
        else:
            for si, info in enumerate(xz.read_backward(data)):
                print(f"stream {si}: check={info.check_id:#x} "
                      f"blocks={len(info.blocks)}")
                for bi, (unpadded, uncomp) in enumerate(info.blocks):
                    print(f"  block {bi}: unpadded={unpadded} "
                          f"uncompressed={uncomp}")
    except LzmaError as e:
        print(f"error: {e}", file=sys.stderr)
        return e.sres
    except OSError as e:
        print(f"io error: {e}", file=sys.stderr)
        return 8
    return 0


if __name__ == "__main__":
    sys.exit(main())
