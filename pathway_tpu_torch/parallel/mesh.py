"""Device mesh management — own copy of ``pathway_tpu/parallel/mesh.py`` on
torch devices.

A :class:`Mesh` names its axes and holds one ``torch.device`` per shard.
Scaling out means adding mesh shards, not OS processes; the ``data`` axis
carries the key-shard dimension (the analog of the reference's 16-bit key
shards). The mesh holds the devices of this process only; meshes across
processes are the host mesh, not ported ([mesh]).

Where the reference widens a short accelerator mesh to the virtual CPU
device pool, :func:`make_mesh` never changes the device type: ``n`` shards
go round-robin over the cards of ``device``'s type, so ``make_mesh(4)`` on
one H100 is four shards on ``cuda:0``. Without a card, ``device="cuda"``
raises; ``device="cpu"`` gives ``n`` shards on the CPU (what the tests use
in place of ``xla_force_host_platform_device_count``).

The engine mesh (``set_engine_mesh``/``get_engine_mesh``) makes stateful
engine operators shard their keyed state over the mesh
(``engine/sharded.py``). ``PATHWAY_ENGINE_SHARDS=n`` asks for it on the
device ``PATHWAY_MESH_DEVICE`` names (default ``cuda``); a mesh that
cannot be built raises naming the device, so a requested sharding never
turns into an unsharded run.
"""

from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np
import torch

_BACKENDS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}

_default_mesh: Any = None


class Mesh:
    """Named axes over an array of ``torch.device``s, one per shard.

    ``shape`` maps each axis to its size, as ``jax.sharding.Mesh.shape``
    does, so callers index ``mesh.shape[axis]``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"a {devices.ndim}-d device array needs {devices.ndim} axis names, got {axis_names}"
            )
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_of(self, shard: int, axis: str | None = None) -> torch.device:
        """The device of ``shard`` along ``axis`` (default the first axis),
        at index 0 of every other axis."""
        ax = self.axis_names.index(axis) if axis is not None else 0
        return np.moveaxis(self.devices, ax, 0).reshape(self.devices.shape[ax], -1)[shard, 0]

    def shard_devices(self, axis: str | None = None) -> list[torch.device]:
        """One device per shard along ``axis``."""
        n = self.shape[axis if axis is not None else self.axis_names[0]]
        return [self.device_of(s, axis) for s in range(n)]

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices.flat)
        return f"Mesh({self.shape}, devices=[{devs}])"


def _cards(device: str | torch.device) -> list[torch.device]:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"a mesh on {str(device)!r} was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' for CPU shards"
            )
        if dev.index is not None:
            return [dev]
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if dev.type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported mesh device {str(device)!r}")


def make_mesh(
    n_devices: int | None = None,
    axis_names: Sequence[str] = ("data",),
    *,
    device: str | torch.device = "cuda",
    backend: str | None = None,
) -> Mesh:
    """Build a mesh of ``n_devices`` shards (default: one per card of
    ``device``'s type), placed round-robin over those cards. The
    reference's ``backend=`` ("cpu", "gpu") maps onto ``device=``."""
    if backend is not None:
        if backend not in _BACKENDS:
            raise ValueError(f"unsupported backend {backend!r}")
        device = _BACKENDS[backend]
    cards = _cards(device)
    n = len(cards) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"requested {n} devices")
    devices = [cards[i % len(cards)] for i in range(n)]
    dev_array = np.empty(len(devices), dtype=object)
    dev_array[:] = devices
    return Mesh(dev_array.reshape(_factor_shape(n, len(axis_names))), axis_names)


def _factor_shape(n: int, n_axes: int) -> tuple[int, ...]:
    if n_axes == 1:
        return (n,)
    # everything on the first axis by default; callers wanting tp x dp
    # meshes build a Mesh with an explicit device array
    return (n,) + (1,) * (n_axes - 1)


def set_default_mesh(mesh: Any) -> None:
    global _default_mesh
    _default_mesh = mesh


def get_mesh() -> Any:
    return _default_mesh


# --- engine mesh ------------------------------------------------------------

_engine_mesh: Any = None
_engine_mesh_set = False
# the env's request and the mesh resolved for it
_env_mesh: tuple[tuple[str, str], Any] | None = None


def set_engine_mesh(mesh: Any, axis: str = "data") -> None:
    """Enable (or disable with mesh=None) engine-level key sharding; this
    overrides ``PATHWAY_ENGINE_SHARDS`` until ``reset_engine_mesh``."""
    global _engine_mesh, _engine_mesh_set
    _engine_mesh = (mesh, axis) if mesh is not None else None
    _engine_mesh_set = True


def reset_engine_mesh() -> None:
    """Forget an explicit ``set_engine_mesh``: the env decides again."""
    global _engine_mesh, _engine_mesh_set, _env_mesh
    _engine_mesh, _engine_mesh_set, _env_mesh = None, False, None


def get_engine_mesh() -> tuple[Any, str] | None:
    """The engine mesh as ``(mesh, axis)``, or None for an unsharded
    engine: the one ``set_engine_mesh`` set, else the one
    ``PATHWAY_ENGINE_SHARDS`` (> 1) asks for on ``PATHWAY_MESH_DEVICE``
    (default ``cuda``), built once per value of the two."""
    global _env_mesh
    if _engine_mesh_set:
        return _engine_mesh
    n = os.environ.get("PATHWAY_ENGINE_SHARDS", "")
    device = os.environ.get("PATHWAY_MESH_DEVICE", "cuda")
    if not (n.isdigit() and int(n) > 1):
        return None
    key = (n, device)
    if _env_mesh is None or _env_mesh[0] != key:
        try:
            mesh = make_mesh(int(n), device=device)
        except (ValueError, RuntimeError) as exc:
            raise RuntimeError(
                f"PATHWAY_ENGINE_SHARDS={n} asks for a {n}-shard engine mesh on "
                f"PATHWAY_MESH_DEVICE={device!r}, which cannot be built: {exc}"
            ) from exc
        _env_mesh = (key, (mesh, "data"))
    return _env_mesh[1]
