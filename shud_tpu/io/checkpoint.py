"""Full-state binary checkpoint / resume.

The reference's restart file (`.cfg.ic.update`, MD_update.cpp:268-299) is
text, ~6 decimals, and omits solver history and the cryosphere temperature
queues — a resumed run is NOT bit-identical.  This module adds the
full checkpoint (SURVEY §5.4): every leaf of the simulation
state pytree — adaptive-solver state (y, history, step size, order,
counters, quadrature accumulators), land-surface buckets, cryosphere ring
buffers — saved losslessly to one ``.npz``.  Resume restores bit-identical
trajectories (tests/test_checkpoint.py).

The text exporter (`io.output.write_restart`) remains for reference-format
compatibility; this is the production path.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def _path_str(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "name"):
            parts.append(str(p.name))
        elif hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def _state_tree(sim) -> dict:
    return {"bdf": sim.bdf, "buckets": sim.buckets, "cryo": sim.cryo}


def save_checkpoint(path: str, sim) -> None:
    """Write the complete simulation state (device pytrees fetched to host).

    One batched ``jax.device_get`` rather than a device-to-host copy per
    leaf.  Multi-process: the
    fetch is a COLLECTIVE (all ranks replicate the sharded leaves), and
    only process 0 touches the file."""
    from shud_tpu.core.device import device_get_global

    tree = device_get_global(_state_tree(sim))
    if jax.process_count() > 1 and jax.process_index() != 0:
        return
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    payload = {"__t__": np.asarray(float(sim.t))}
    for kp, leaf in leaves:
        payload[_path_str(kp)] = np.asarray(leaf)
    with open(path, "wb") as f:
        np.savez(f, **payload)


def load_checkpoint(path: str, sim) -> None:
    """Restore state saved by :func:`save_checkpoint` into *sim* (created
    for the same project/config, so its pytree structure is the template)."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    tmpl = _state_tree(sim)
    keyed, treedef = jax.tree_util.tree_flatten_with_path(tmpl)
    new_leaves = []
    for kp, leaf in keyed:
        key = _path_str(kp)
        if key not in data:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
        new_leaves.append(jnp.asarray(data[key], dtype=jnp.asarray(leaf).dtype))
    state = jax.tree_util.tree_unflatten(treedef, new_leaves)
    sim.bdf = state["bdf"]
    sim.buckets = state["buckets"]
    sim.cryo = state["cryo"]
    sim.t = float(data["__t__"])
