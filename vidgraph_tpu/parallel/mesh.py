"""Device-mesh construction and sharding helpers.

The reference has no parallelism at all (SURVEY.md §2); this module is the
substrate everything multi-device rides on: a 2-D
``jax.sharding.Mesh`` with ("data", "model") axes.  The vision tower /
captioner are tensor-sharded along "model" (attention heads, MLP hidden) and
batch-sharded along "data"; the embedding memory is row-sharded along "data"
so each chip scans its shard of the store and top-k results are combined with
an all-gather (NVLink between GPUs).  The mesh is shaped for the
algorithm alone: every card reaches every other at the same rate.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _factor(n: int, model_axis: int) -> Tuple[int, int]:
    """Pick (data, model) sizes for n devices."""
    if model_axis <= 0:
        model_axis = 1
    model = math.gcd(n, model_axis) if n % model_axis else model_axis
    if n % model != 0:
        model = 1
    return n // model, model


def build_mesh(devices: Optional[Sequence] = None,
               model_axis: int = 1,
               axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """Build a 2-D (data, model) mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    devices = list(devices)
    n = len(devices)
    data, model = _factor(n, model_axis)
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, axis_names)


def single_device_mesh() -> Mesh:
    return build_mesh(jax.devices()[:1], model_axis=1)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharded(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Shard the leading (batch / row) dimension along the data axis."""
    spec = [DATA_AXIS] + [None] * (ndim - 1)
    return NamedSharding(mesh, P(*spec))


def model_sharded_cols(mesh: Mesh) -> NamedSharding:
    """[in, out] weight with the output dim split along the model axis."""
    return NamedSharding(mesh, P(None, MODEL_AXIS))


def model_sharded_rows(mesh: Mesh) -> NamedSharding:
    """[in, out] weight with the input dim split along the model axis."""
    return NamedSharding(mesh, P(MODEL_AXIS, None))


@contextmanager
def use_mesh(mesh: Mesh):
    with mesh:
        yield mesh


def host_cpu_mesh(n_devices: int = 8) -> Mesh:
    """Mesh over virtual CPU devices — used by tests and the multichip
    dry-run (XLA_FLAGS=--xla_force_host_platform_device_count=N)."""
    devs = [d for d in jax.devices() if d.platform == "cpu"] or jax.devices()
    return build_mesh(devs[:n_devices], model_axis=min(2, n_devices))
