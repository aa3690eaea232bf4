"""The one traffic generator: reads a mix's parameters from
``traffic/<name>.json`` and draws, from ``--seed``, the files a run sends.

A mix of kind ``closed_loop_files`` is one caller in a closed loop: it
sends its next file when the previous call has returned.  Each file is
``file_bytes`` long and cut as ``xz -T0`` cuts it: into blocks of the
configuration's ``block_size``, the last one short where the size is not
a whole number of blocks.  A block is ``(index, size)`` in the
configuration's pool.  The pool holds ``pool_per_file`` files' worth of
full blocks, and one short last block for each file of a cycle.

The seed deals the full blocks in a random order around a ring; file f
takes the next blocks of the ring, in an order of their own, and a short
block of its own last.  So every seed sends every full block equally
often over a cycle of ``lcm(pool, blocks a file) / blocks a file`` files
and every short block once, and the seed changes which blocks share a file
and in what order, not the work.  The run sends the cycle's files in turn.
``check_calls`` is how many calls' outputs are kept, a sample drawn from
the seed, for the comparison after the window.
"""

from __future__ import annotations

import math
import random

KINDS = ("closed_loop_files",)


def check(mix: dict) -> None:
    """Raise ValueError unless ``mix`` is a mix this generator reads."""
    if mix.get("kind") not in KINDS:
        raise ValueError(f"traffic kind {mix.get('kind')!r}: one of {KINDS}")
    for k in ("file_bytes", "check_calls", "callers"):
        if not isinstance(mix.get(k), int) or mix[k] < 1:
            raise ValueError(f"traffic {k} must be a positive whole number")
    if mix["callers"] != 1:
        raise ValueError("closed_loop_files has one caller")
    per = mix.get("pool_per_file")
    if not isinstance(per, (int, float)) or per < 1:
        raise ValueError("a pool holds at least one file's worth of blocks")


def shape(mix: dict, block_size: int) -> tuple[int, int, int]:
    """(full blocks a file, the size of its short last block (0: none),
    full blocks in the pool)."""
    full, tail = divmod(mix["file_bytes"], block_size)
    return full, tail, max(full, math.ceil(mix["pool_per_file"] * full))


def files(mix: dict, seed: int, block_size: int) -> list[list[tuple]]:
    """The cycle of files ``seed`` sends: each a list of pool blocks
    ``(index, size)``, in the order the file holds them.  Short blocks
    have the indices after the full ones."""
    check(mix)
    k, tail, n = shape(mix, block_size)
    rng = random.Random(seed)
    ring = rng.sample(range(n), n)
    count = math.lcm(n, k) // k if k else 1
    tails = rng.sample(range(count), count)
    out = []
    for f in range(count):
        blocks = [(ring[(f * k + j) % n], block_size) for j in range(k)]
        rng.shuffle(blocks)
        if tail:
            blocks.append((n + tails[f], tail))
        out.append(blocks)
    return out


class Sample:
    """A uniform sample of at most ``size`` of a run's calls, drawn from
    ``seed`` as the calls come (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(f"check:{seed}")
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = item
