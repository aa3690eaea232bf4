"""``7z l|t|e|x`` CLI — the reference's 7zMain (``7zMain.c``) plus archive
creation (``a``) and carving (``carve``), which the reference lacks.

Usage:
  python -m lzma_sdk_zliblike_tpu_torch.cli.sevenz l  archive.7z
  python -m lzma_sdk_zliblike_tpu_torch.cli.sevenz t  archive.7z
  python -m lzma_sdk_zliblike_tpu_torch.cli.sevenz e  archive.7z [-o DIR]   (flat)
  python -m lzma_sdk_zliblike_tpu_torch.cli.sevenz x  archive.7z [-o DIR]   (paths)
  python -m lzma_sdk_zliblike_tpu_torch.cli.sevenz xs archive.7z [-o DIR]   (streaming)
  python -m lzma_sdk_zliblike_tpu_torch.cli.sevenz a  archive.7z FILE... [--method m]
  python -m lzma_sdk_zliblike_tpu_torch.cli.sevenz carve host.bin [-o out.7z]

The port's copy of the JAX package's ``cli/sevenz.py``: the same commands,
output and exit codes (an error's SRes code, 8 for an I/O error).
"""

from __future__ import annotations

import argparse
import os
import sys

from ..containers import sevenzip as SZ
from ..streams import extract7z
from ..utils.errors import LzmaError

_METHODS = {"copy": SZ.M_COPY, "lzma": SZ.M_LZMA, "lzma2": SZ.M_LZMA2,
            "ppmd": SZ.M_PPMD}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="7z", description="7z archive tool")
    ap.add_argument("command",
                    choices=["l", "t", "e", "x", "xs", "a", "carve"])
    ap.add_argument("archive")
    ap.add_argument("files", nargs="*")
    ap.add_argument("-o", "--out", default=".")
    ap.add_argument("--method", default="lzma2", choices=sorted(_METHODS))
    ap.add_argument("--dict-size", type=int, default=1 << 24)
    ap.add_argument("--bcj", action="store_true", help="x86 BCJ pre-filter")
    ap.add_argument("--bcj2", action="store_true", help="BCJ2 pre-filter")
    ap.add_argument("--non-solid", action="store_true")
    ap.add_argument("--encode-header", action="store_true")
    ap.add_argument("--effort", type=int, default=9,
                    help="1-9 fast..best lazy; 10 = optimal parse")
    args = ap.parse_args(argv)

    try:
        return _run(args)
    except LzmaError as e:
        print(f"error: {e}", file=sys.stderr)
        return e.sres
    except OSError as e:
        print(f"io error: {e}", file=sys.stderr)
        return 8


def _run(args) -> int:
    cmd = args.command
    if cmd == "a":
        files = {}
        for path in args.files:
            if os.path.isdir(path):
                for root, _dirs, fnames in os.walk(path):
                    for fn in fnames:
                        full = os.path.join(root, fn)
                        files[os.path.relpath(full)] = open(full, "rb").read()
            else:
                files[os.path.basename(path)] = open(path, "rb").read()
        pre = SZ.M_BCJ2 if args.bcj2 else (SZ.M_BCJ if args.bcj else None)
        img = SZ.write(files, method=_METHODS[args.method],
                       dict_size=args.dict_size, solid=not args.non_solid,
                       pre_filter=pre, encode_header=args.encode_header,
                       effort=args.effort)
        open(args.archive, "wb").write(img)
        print(f"created {args.archive}: {len(files)} files, "
              f"{len(img)} bytes")
        return 0

    if cmd == "carve":
        host = open(args.archive, "rb").read()
        img = SZ.carve(host)
        out = args.out if args.out != "." else "7zpart.7z"
        open(out, "wb").write(img)
        print(f"carved {len(img)} bytes -> {out}")
        return 0

    if cmd == "xs":
        names = extract7z.extract_streaming(args.archive, args.out)
        for n in names:
            print(n)
        return 0

    data = open(args.archive, "rb").read()
    if cmd == "l":
        for f in SZ.list_files(data):
            kind = "D" if f.is_dir else "."
            print(f"{kind} {f.size:12d}  {f.name}")
        return 0
    if cmd == "t":
        names = SZ.test(data)
        for n in names:
            print(f"T {n}")
        print("Everything is Ok")
        return 0
    # e / x
    out = SZ.extract(data)
    mtimes = {f.name: f.mtime for f in SZ.parse(data).files}
    for name, blob in out.items():
        target = os.path.join(args.out,
                              name if cmd == "x" else os.path.basename(name))
        os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
        with open(target, "wb") as f:
            f.write(blob)
        SZ.apply_mtime(target, mtimes.get(name))
        print(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
