"""Name parity: the port's public surface against the JAX package's.

Every module of ``lzma_sdk_zliblike_tpu`` (walked with ``pkgutil``) is
held against its counterpart in ``lzma_sdk_zliblike_tpu_torch``: its public
names (by the rule of ``test_torch_sevenzip._public``), the parameter names
of each public function and class (``inspect.signature``) and the public
methods of each class and their parameters.  What the port lacks must
equal ``OMITTED`` for that module exactly, so a new gap fails and so does
an entry that no longer differs.

Keys of ``OMITTED``: ``(module,)`` for a module the port does not have,
``(module, name)`` for a name, ``(module, name, parameter)`` for a
parameter; a method is named ``Class.method``.  Each value is the reason.
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil
import types

import pytest

import lzma_sdk_zliblike_tpu as J

JAX_PKG = "lzma_sdk_zliblike_tpu"
PORT_PKG = "lzma_sdk_zliblike_tpu_torch"

_JAX_SHARDING = ("returns or takes jax.sharding objects and JAX devices; the "
                 "port's mesh is of ranks (RankMesh, make_mesh(world=)) and "
                 "its lane sharding is mesh.lane_shard")
_PROPS_PER_LAUNCH = ("the port's scheduler sends each (lc, lp, pb) to its "
                     "own launch, so a batch shape carries no props")
_INTERPRET = ("Pallas interpret mode; the port's counterpart is "
              "device=\"cpu\", the kernels' plain versions")
_ALWAYS_BUILT = ("the port's host runtime is always built, with no "
                 "fallback, so there is nothing to ask")

OMITTED: dict[tuple, str] = {
    ("ops.pallas_decode",): "the TPU kernel K1; the port's is "
                            "ops/group_decode (csrc/group_decode.cu)",
    ("ops.pallas_encode",): "the TPU kernel K2; the port's is "
                            "ops/range_encode (csrc/range_encode.cu)",
    ("ops.batched_decode",): "the XLA lockstep decoder behind K1's xla "
                             "engine; the port decodes with ops/group_decode",
    ("models.lzma.op_replay",): "the tests' specification of K2's op "
                                "replay; the port's tests hold K2 against "
                                "ops/range_encode's plain version",
    ("streams.window",): "serves only the JAX package's silent Python "
                         "fallbacks, which the port leaves out",
    ("native", "available"): _ALWAYS_BUILT,
    ("native", "group_ops_available"): _ALWAYS_BUILT,
    ("native", "ppmd7_available"): _ALWAYS_BUILT,
    ("native", "sha256_available"): _ALWAYS_BUILT,
    ("native", "stream_dec_available"): _ALWAYS_BUILT,
    ("utils.memory", "DEFAULT_HBM_BUDGET"): "the port reads LZT_HBM_BUDGET "
                                            "at each call (device_budget)",
    ("utils.memory", "DEFAULT_INFLIGHT"): "the port names the depth "
                                          "INFLIGHT",
    ("utils.memory", "shape_for_groups", "lc"): _PROPS_PER_LAUNCH,
    ("utils.memory", "shape_for_groups", "lp"): _PROPS_PER_LAUNCH,
    ("utils.memory", "shape_for_groups", "pb"): _PROPS_PER_LAUNCH,
    ("parallel.scheduler", "BatchShape", "lc"): _PROPS_PER_LAUNCH,
    ("parallel.scheduler", "BatchShape", "lp"): _PROPS_PER_LAUNCH,
    ("parallel.scheduler", "BatchShape", "pb"): _PROPS_PER_LAUNCH,
    ("parallel.scheduler", "BatchedLzma2Decoder", "engine"):
        "names the JAX engines (xla, pallas); the port runs K1 on the card "
        "and its plain version on the CPU, chosen by device=",
    ("parallel.device_encode", "PAGE"): "the TPU's 128-lane word page of "
                                        "K2's output",
    ("parallel.device_encode", "encode_lzma2_device_coded", "interpret"):
        _INTERPRET,
    ("parallel.device_encode", "encode_lzma2_hybrid", "interpret"):
        _INTERPRET,
    ("parallel.mesh", "lane_sharding"): _JAX_SHARDING,
    ("parallel.mesh", "lane_sharding_2d"): _JAX_SHARDING,
    ("parallel.mesh", "replicated"): _JAX_SHARDING,
    ("parallel.mesh", "shard_batch_args"): _JAX_SHARDING,
    ("parallel.mesh", "shard_lane_state"): _JAX_SHARDING,
    ("parallel.mesh", "make_mesh", "n_devices"): _JAX_SHARDING,
    ("parallel.distributed", "global_lane_mesh"): _JAX_SHARDING,
    ("parallel.distributed", "run_local_cluster", "devices_per_proc"):
        "sets XLA's host device count; the port's ranks find their card "
        "by LOCAL_RANK",
}

MODULES = [""] + sorted(m.name[len(JAX_PKG) + 1:] for m in
                        pkgutil.walk_packages(J.__path__, JAX_PKG + "."))


def _full(pkg: str, mod: str) -> str:
    return f"{pkg}.{mod}" if mod else pkg


def _public(mod) -> dict:
    """The public names a module defines (imported modules, classes and
    functions left out), as ``test_torch_sevenzip._public`` has them."""
    out = {}
    for n, v in vars(mod).items():
        if n.startswith("_") or n == "annotations" or \
                isinstance(v, types.ModuleType):
            continue
        if isinstance(v, (type, types.FunctionType)) and \
                v.__module__ != mod.__name__:
            continue
        out[n] = v
    return out


def _params(fn) -> list[str]:
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):     # builtins without a signature
        return []


def _methods(cls) -> dict:
    """The public methods and properties a class defines itself."""
    return {n: v for n, v in vars(cls).items() if not n.startswith("_")
            and isinstance(v, (types.FunctionType, staticmethod,
                               classmethod, property))}


def _gaps(mod: str) -> set[tuple]:
    jax_mod = importlib.import_module(_full(JAX_PKG, mod))
    try:
        port = importlib.import_module(_full(PORT_PKG, mod))
    except ModuleNotFoundError as e:
        if e.name != _full(PORT_PKG, mod):
            raise
        return {(mod,)}
    jn, pn = _public(jax_mod), _public(port)
    gaps = {(mod, n) for n in jn.keys() - pn.keys()}
    for n in jn.keys() & pn.keys():
        a, b = jn[n], pn[n]
        if not (callable(a) and callable(b)):
            continue
        gaps |= {(mod, n, p) for p in _params(a) if p not in _params(b)}
        if isinstance(a, type) and isinstance(b, type):
            for m, v in _methods(a).items():
                if not hasattr(b, m):
                    gaps.add((mod, f"{n}.{m}"))
                elif not isinstance(v, property):
                    gaps |= {(mod, f"{n}.{m}", p)
                             for p in _params(getattr(a, m))
                             if p not in _params(getattr(b, m))}
    return gaps


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m or "package")
def test_port_names_match_jax(mod):
    """What the port lacks of this module is what OMITTED lists for it,
    no more (a new gap) and no less (a stale entry)."""
    assert _gaps(mod) == {k for k in OMITTED if k[0] == mod}


def test_omitted_entries_name_jax_modules_and_give_reasons():
    """Every entry belongs to a module of the JAX package (so the per-module
    test sees it) and carries a reason."""
    assert {k[0] for k in OMITTED} <= set(MODULES)
    assert all(1 <= len(k) <= 3 and isinstance(r, str) and r.strip()
               for k, r in OMITTED.items())


def test_walk_covers_the_package():
    """The walk reaches every subpackage and module, among them the ones
    the earlier name test named and the TPU kernels' modules."""
    assert len(MODULES) == len(set(MODULES)) > 40
    for m in ("containers.sevenzip", "containers.xz", "native",
              "ops.pallas_decode", "ops.pallas_encode", "parallel.mesh",
              "utils.memory", "cli.sevenz", "models.ppmd7.codec"):
        assert m in MODULES
