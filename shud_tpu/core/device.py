"""Device-side mesh: registers MeshData as a JAX pytree and moves arrays.

Static scalars (entity counts) become aux data so they stay Python ints at
trace time; array fields become pytree leaves.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from shud_tpu.core.mesh import MeshData

_STATIC_FIELDS = ("num_ele", "num_riv", "num_seg", "num_lake",
                  "watershed_area", "roll_offsets")
_ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(MeshData) if f.name not in _STATIC_FIELDS
)

jax.tree_util.register_dataclass(
    MeshData, data_fields=list(_ARRAY_FIELDS), meta_fields=list(_STATIC_FIELDS)
)


def device_get_global(tree):
    """``jax.device_get`` that also works under multi-process execution.

    Single process: a plain ``device_get``.  Multi-process
    (``jax.distributed``): globally-sharded arrays are not addressable per
    process, so the tree is first passed through a jitted identity with
    fully-REPLICATED out-shardings (one XLA all-gather across devices and
    hosts — the ``multihost_utils.process_allgather`` pattern), after which
    every process holds complete copies and ``device_get`` is legal.  This is
    the multi-host interval fetch of the sharded production driver (the
    reference has no analogue — its parallel mode is shared-memory OpenMP,
    shud.cpp:56-64)."""
    if jax.process_count() == 1:
        return jax.device_get(tree)
    from jax.sharding import NamedSharding, PartitionSpec

    mesh = None
    for leaf in jax.tree_util.tree_leaves(tree):
        sh = getattr(leaf, "sharding", None)
        if sh is not None and getattr(sh, "mesh", None) is not None:
            mesh = sh.mesh
            break
    if mesh is None:  # host-only tree
        return jax.device_get(tree)
    rep = NamedSharding(mesh, PartitionSpec())
    gathered = jax.jit(lambda tr: tr, out_shardings=rep)(tree)
    return jax.device_get(gathered)


def to_device(md: MeshData, float_dtype=jnp.float64) -> MeshData:
    """Move all array fields to device, casting floats to *float_dtype* and
    index arrays to int32."""
    kwargs = {}
    for name in _STATIC_FIELDS:
        kwargs[name] = getattr(md, name)
    for name in _ARRAY_FIELDS:
        raw = getattr(md, name)
        if raw is None:
            kwargs[name] = None
            continue
        v = np.asarray(raw)
        if np.issubdtype(v.dtype, np.floating):
            kwargs[name] = jnp.asarray(v, dtype=float_dtype)
        else:
            kwargs[name] = jnp.asarray(v, dtype=jnp.int32)
    return MeshData(**kwargs)
