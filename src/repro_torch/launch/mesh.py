"""Device meshes: the port's counterpart of ``repro.launch.mesh``.

A :class:`Mesh` is a numpy array of ``torch.device`` with named axes.
It is not ``torch.distributed.DeviceMesh``, which needs a process group:
its slots are *logical* devices, and several slots may name one physical
device, as JAX's forced host devices put 8 logical devices on one CPU.
The CPU tests pass ``devices=[torch.device("cpu")] * 8``; on one card
``[cuda:0, cuda:0]`` gives the disaggregated serving placement.

``devices`` defaults to every visible CUDA device.  The constructors
validate as JAX's do: too few devices raises a ``RuntimeError`` that
names the deficit and the fix.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _physical(device) -> torch.device:
    """The physical device a slot names: ``cuda`` is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Logical devices laid out on named axes (JAX's ``Mesh``):
    ``devices`` an object array of ``torch.device``, ``axis_names``, and
    ``shape`` a dict of axis name to size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devs = np.asarray(devices, dtype=object)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if devs.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {devs.shape} do not match "
                             f"axes {self.axis_names}")
        self.devices = devs

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def slot_device(self, axis: str, i: int) -> torch.device:
        """The device of slot ``i`` along ``axis`` (index 0 on the other
        axes, over which a spec of ``axis`` alone replicates)."""
        idx = [0] * self.devices.ndim
        idx[self.axis_names.index(axis)] = i
        return self.devices[tuple(idx)]

    def physical_devices(self) -> List[torch.device]:
        """The distinct physical devices the slots name, in slot order."""
        out: List[torch.device] = []
        for d in self.devices.flat:
            p = _physical(d)
            if p not in out:
                out.append(p)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.physical_devices()})"


def _devices(devices) -> List[torch.device]:
    if devices is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def _take(devices, n: int, what: str) -> np.ndarray:
    devs = _devices(devices)
    if len(devs) < n:
        raise RuntimeError(
            f"need {n} devices for {what}, have {len(devs)}; pass "
            f"devices= with at least {n} (slots may repeat one physical "
            f"device, e.g. [torch.device('cpu')] * {n})")
    out = np.empty(n, dtype=object)
    out[:] = devs[:n]
    return out


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    return Mesh(_take(devices, n, f"mesh {shape}").reshape(shape), axes)


def make_debug_mesh(shape=(2, 4), axes=("data", "model"),
                    devices=None) -> Mesh:
    """Small mesh for unit tests (e.g. 8 logical CPU devices)."""
    n = int(np.prod(shape))
    return Mesh(_take(devices, n, f"mesh {tuple(shape)}").reshape(shape),
                axes)


@dataclasses.dataclass(frozen=True)
class ServeMeshes:
    """Device placement of the sharded serving pipeline.

    ``prefill``/``decode`` are the Access and Execute engines' meshes;
    ``union`` covers both and carries the cross-engine
    :class:`~repro_torch.channels.mesh.MeshChannel` rings.  When
    ``disaggregated`` the two engine meshes are disjoint halves (the
    union gains a leading ``role`` axis of size 2: row 0 prefill, row 1
    decode) joined only by channels; otherwise all three are one mesh
    and the channels ride its ``data`` axis.
    """

    union: Mesh
    prefill: Mesh
    decode: Mesh
    disaggregated: bool
    axis: str = "data"
    role_axis: str = "role"


def make_serve_meshes(n: Optional[int] = None, *,
                      disaggregate: Optional[bool] = None,
                      devices=None) -> ServeMeshes:
    """Carve the first ``n`` of ``devices`` into serving meshes.

    ``disaggregate`` defaults to splitting whenever an even n >= 2 is
    available; ``n`` defaults to every device given.  n=1 is always one
    mesh shared by both engines (the bit-parity configuration).
    """
    devs = _devices(devices)
    if n is None:
        n = max(1, len(devs))
    if n < 1:
        raise ValueError(f"need n >= 1 serving devices, got {n}")
    devs = _take(devs, n, "serving meshes")
    if disaggregate is None:
        disaggregate = n >= 2 and n % 2 == 0
    if disaggregate and (n < 2 or n % 2):
        raise ValueError(
            f"disaggregated serving splits devices in half, got n={n}")
    if not disaggregate:
        mesh = Mesh(devs, ("data",))
        return ServeMeshes(mesh, mesh, mesh, False)
    half = n // 2
    union = Mesh(devs.reshape(2, half), ("role", "data"))
    prefill = Mesh(devs[:half], ("data",))
    decode = Mesh(devs[half:], ("data",))
    return ServeMeshes(union, prefill, decode, True)
