"""Model checkpointing: save/load parameter pytrees.

The reference has no model state at all (everything was served over HTTP);
this framework owns in-process models, so weights must round-trip.  A flat
``.npz`` format keeps zero extra dependencies; keys are '/'-joined pytree
paths so any params dict (ViT flax params, captioner plain-dict params)
round-trips exactly.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import jax
import ml_dtypes
import numpy as np

# npz can't store bfloat16 natively — bf16 leaves are saved as uint16 bit
# patterns under a prefixed key and viewed back on load (round-trip exact).
_BF16_PREFIX = "__bf16__/"


def _path_key(p) -> str:
    """Stringify one pytree path element: DictKey (.key), SequenceKey
    (.idx), or GetAttrKey (.name — NamedTuple fields, e.g. optax states
    when a whole train state is checkpointed)."""
    for attr in ("key", "idx", "name"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    return str(p)


def _flatten(params: Any) -> Dict[str, np.ndarray]:
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(_path_key(p) for p in path)
        arr = np.asarray(leaf)
        if arr.dtype == ml_dtypes.bfloat16:
            flat[_BF16_PREFIX + key] = arr.view(np.uint16)
        else:
            flat[key] = arr
    return flat


def save_params(params: Any, path: str) -> str:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, **_flatten(params))
    return str(p)


def load_params(template: Any, path: str) -> Any:
    """Load into the structure of ``template`` (shapes must match)."""
    with np.load(path) as data:
        flat = {}
        for k in data.files:
            if k.startswith(_BF16_PREFIX):
                flat[k[len(_BF16_PREFIX):]] = (
                    data[k].view(ml_dtypes.bfloat16))
            else:
                flat[k] = data[k]

    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    new_leaves = []
    for path_elems, leaf in leaves:
        key = "/".join(_path_key(p) for p in path_elems)
        if key not in flat:
            raise KeyError(f"checkpoint missing parameter: {key}")
        arr = flat[key]
        # read shape/dtype as ATTRIBUTES — np.asarray(leaf) on a
        # device-resident template would fetch every weight to host
        lshape = (tuple(leaf.shape) if hasattr(leaf, "shape")
                  else np.asarray(leaf).shape)
        ldtype = (leaf.dtype if hasattr(leaf, "dtype")
                  else np.asarray(leaf).dtype)
        if arr.shape != lshape:
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{arr.shape} vs template {lshape}")
        new_leaves.append(arr.astype(ldtype))
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), new_leaves)
    # Place the loaded tree on device ONCE.  Host-numpy leaves are
    # re-uploaded by jit on EVERY dispatch.  Serving meshes re-shard on
    # top of this placement (device_put to a sharding moves device
    # arrays fine).
    return jax.device_put(tree)
