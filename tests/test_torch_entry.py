"""The port's driver entry points (``lzma_sdk_zliblike_tpu_torch/entry.py``),
the counterpart of the JAX package's ``__graft_entry__.py``.

``entry()``'s function must decode each lane of the JAX entry's batch to
its original slice, and ``dryrun_multichip(2)`` must pass on two Gloo ranks
of the plain K1; on a card, both run K1 (``cuda`` marker).
"""

from __future__ import annotations

import pytest
import torch

from lzma_sdk_zliblike_tpu_torch import entry as E
from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G


def _check_entry(device):
    fn, args = E.entry(device=device)
    assert all(a.device.type == torch.device(device).type for a in args)
    out, ok, consumed = fn(*args)
    _, dic_cap, origs = E.make_batch(8)
    assert tuple(out.shape) == (8, dic_cap) and bool(ok.all())
    for li, orig in enumerate(origs):
        assert out[li, :len(orig)].numpy().tobytes() == orig, li
        assert int(consumed[li]) == int(args[1][li, -1])


def test_entry_decodes_each_lane_to_its_original():
    _check_entry("cpu")


def test_entry_batch_is_the_jax_entry_shape():
    (src, pe, ue, fl, act), dic_cap, origs = E.make_batch(8)
    data = E.big_mixed(4 * 2048, seed=7)
    assert src.shape == (8, 2048) and dic_cap == 2048 and act.tolist() == [1] * 8
    assert fl.tolist() == [[1]] * 8 and (pe[:, 0] <= 2048).all()
    assert all(o == data[(li % 4) * 2048:(li % 4 + 1) * 2048]
               for li, o in enumerate(origs))


def test_dryrun_multichip_on_two_cpu_ranks():
    res = E.dryrun_multichip(2, device="cpu", timeout=300)
    assert res["ranks"] == 2 and res["launches"] == 0      # plain K1
    assert [r["rank"] for r in sorted(res["per_rank"],
                                      key=lambda r: r["rank"])] == [0, 1]
    assert [r["shard"] for r in sorted(res["per_rank"],
                                       key=lambda r: r["rank"])] == \
        [[0, 4], [4, 8]]
    assert res["summary"].startswith("dryrun_multichip(2): ok")


def test_dryrun_multichip_fails_when_a_rank_fails():
    """A rank that cannot reach its device fails, and so does the call."""
    with pytest.raises(RuntimeError, match="exited non-zero"):
        E.dryrun_multichip(2, device="meta", timeout=300)


@pytest.mark.cuda
def test_entry_and_dryrun_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    G.launches = 0
    _check_entry("cuda")
    assert G.launches == 1
    res = E.dryrun_multichip(2, device="cuda", timeout=600)
    assert res["launches"] >= 2
