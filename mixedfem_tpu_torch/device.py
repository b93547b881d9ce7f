"""Device selection for the port's entry points, and moving their objects
between devices."""

from __future__ import annotations

import dataclasses

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises if a CUDA device is asked for and
    none is present (the CPU is used only when the caller passes "cpu")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU"
        )
    return dev


def to_device(obj, device):
    """A copy of `obj` (a tensor, or dataclasses, tuples and lists holding
    tensors, such as MeshData, SimState, CoarseSpace or a banded plan) with
    every tensor on `device`; other values are shared."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init
        })
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(o, device) for o in obj)
    return obj
