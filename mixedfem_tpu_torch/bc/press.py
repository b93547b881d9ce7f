"""MechanicalPress: a force controller that targets a marker vertex's
velocity (port of mixedfem_tpu/bc/press.py).

A scalar force f along `axis` acts on a vertex group. After each Newton
solve it is scaled by clamp(target_velocity / rate, 1.0, 1.1) (1.1 when the
marker moves the wrong way), clamped to max_force, and zeroed once the
marker has moved max_displacement, so the adjusted force acts from the
next step on. The controller's state is three host scalars; the force
field it yields is a tensor on the mesh's device.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PressSpec:
    forced: torch.Tensor  # (nv,) mask of forced vertices
    axis: int
    marker: int
    target_velocity: float
    max_force: float
    max_displacement: float


@dataclasses.dataclass(frozen=True)
class PressState:
    f: float            # current force magnitude
    marker_pos: float   # marker coordinate along axis
    marker_pos0: float  # initial marker coordinate


def press_init(spec: PressSpec, V: torch.Tensor, f0: float) -> PressState:
    m = float(V[spec.marker, spec.axis])
    return PressState(f=float(f0), marker_pos=m, marker_pos0=m)


def press_force(spec: PressSpec, st: PressState, nv: int, dim: int):
    """(nv, d) per-vertex force."""
    out = spec.forced.new_zeros((nv, dim))
    out[:, spec.axis] = spec.forced * st.f
    return out


def press_step(spec: PressSpec, st: PressState, V: torch.Tensor, dt: float):
    """Advance the controller from the post-solve positions."""
    new_pos = float(V[spec.marker, spec.axis])
    rate = (new_pos - st.marker_pos) / dt
    ratio = spec.target_velocity / (rate if abs(rate) > 1e-30 else 1e-30)
    factor = 1.1 if ratio < 0 else min(max(ratio, 1.0), 1.1)
    f = st.f * factor if (factor >= 1.0 or abs(st.f) > 0.01) else st.f
    f = min(max(f, -spec.max_force), spec.max_force)
    if abs(new_pos - st.marker_pos0) > spec.max_displacement:
        f = 0.0
    return PressState(f=f, marker_pos=new_pos, marker_pos0=st.marker_pos0)
