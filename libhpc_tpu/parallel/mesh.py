"""Device meshes (SURVEY.md §7 L0/L4).

The reference is single-node; its closest analogs are OpenMP/TBB thread
teams. Here the 'thread team' is a `jax.sharding.Mesh` over devices. The
cards of one host reach each other all-to-all at one rate, so a mesh's
shape follows the algorithm alone: 1-D for row partitions, 2-D for
block partitions. CPU simulation on virtual devices (force_cpu_devices)
runs the same program and collectives, and is always an explicit choice
(require_devices).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401


def force_cpu_devices(n: int) -> None:
    """Ensure ≥n virtual CPU devices (multi-device simulation on one host).

    Must run before any array is created; clears initialized backends if
    needed.
    """
    try:
        from jax._src import xla_bridge as xb

        if xb.backends_are_initialized():
            from jax.extend.backend import clear_backends

            clear_backends()
    except Exception:
        pass
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", n)
    if len(jax.devices()) < n:
        raise RuntimeError(
            f"could not provision {n} cpu devices (got {len(jax.devices())})"
        )


def require_devices(n: int, cpu_sim: bool = False) -> None:
    """Make n devices available: n virtual CPU devices when cpu_sim is
    asked for, else at least n real devices or an error — never a silent
    switch to the CPU."""
    if cpu_sim:
        force_cpu_devices(n)
    elif len(jax.devices()) < n:
        raise RuntimeError(
            f"needs {n} devices, found {len(jax.devices())} "
            f"({jax.devices()[0].platform}); pass the CPU-simulation "
            "option to run on virtual CPU devices")


def make_mesh_1d(n: int | None = None, axis: str = "x") -> Mesh:
    """1D mesh over the first n devices.

    Axis type AUTO (GSPMD sharding propagation): jax.make_mesh defaults
    to Explicit in current JAX, under which auto-sharded library ops
    (e.g. segment_sum inside a jitted preconditioner) fail with
    'Resource axis ... not found in mesh: ()' — this library drives
    sharding with explicit shard_map / NamedSharding placements and
    leaves the rest to GSPMD."""
    devs = jax.devices()
    if n is None:
        n = len(devs)
    return jax.make_mesh((n,), (axis,), devices=devs[:n],
                         axis_types=(jax.sharding.AxisType.Auto,))


def make_mesh_2d(n_outer: int, n_inner: int, axes=("host", "x")) -> Mesh:
    """2D mesh (n_outer, n_inner) for algorithms that decompose over two
    axes (AUTO axis types, see make_mesh_1d)."""
    return jax.make_mesh((n_outer, n_inner), axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
