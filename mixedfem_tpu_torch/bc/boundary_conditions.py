"""Scripted Dirichlet boundary conditions (port of
mixedfem_tpu/bc/boundary_conditions.py).

Each BC pins vertex groups (bottom/top `ratio` slabs along `axis` of the
object's initial bounding box) and may move them every timestep. A BC is a
static BCSpec (global-vertex masks and small vectors on the device) plus a
BCState of host scalars: nothing on the device reads the state, so the
translate script's clock and flags stay Python values. `bc_step` returns the
moved positions and the next state.

Registered names: null, scale, randomize, onepoint, hang, hangends, bend,
stretch, twist, translate, twist-and-stretch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from mixedfem_tpu_torch.device import resolve_device

BC_NAMES = (
    "null",
    "scale",
    "randomize",
    "onepoint",
    "hang",
    "hangends",
    "bend",
    "stretch",
    "twist",
    "translate",
    "twist-and-stretch",
)


@dataclasses.dataclass(frozen=True)
class BCConfig:
    type: str = "null"
    ratio: float = 0.1
    axis: int = 0
    velocity: float = 0.1
    duration: float = 1.0
    flip: bool = False


@dataclasses.dataclass
class BCSpec:
    """Static per-object BC data (masks are global-vertex-sized)."""

    group0: torch.Tensor   # (nv,) mask: bottom slab
    group1: torch.Tensor   # (nv,) mask: top slab
    fixed: torch.Tensor    # (nv,) mask: pinned vertices of this BC
    center: torch.Tensor   # (d,) rotation center (twist)
    center0: torch.Tensor  # (d,) group-0 rotation center (bend)
    center1: torch.Tensor  # (d,) group-1 rotation center (bend)
    vel_vec: torch.Tensor  # (d,) translation velocity vector
    type: str
    velocity: float
    duration: float
    flip: bool


@dataclasses.dataclass(frozen=True)
class BCState:
    elapsed: float = 0.0
    reversed: bool = False
    done: bool = False


def boundary_groups(V: np.ndarray, ratio: float, axis: int):
    """Bottom/top `ratio` slabs along `axis`."""
    lo = V.min(axis=0)
    hi = V.max(axis=0)
    rng = hi - lo
    g0 = V[:, axis] < lo[axis] + rng[axis] * ratio
    g1 = V[:, axis] > hi[axis] - rng[axis] * ratio
    return g0, g1


def build_bc(
    V_obj: np.ndarray,
    cfg: BCConfig,
    nv_total: int,
    offset: int,
    dtype=torch.float64,
    device="cuda",
    rng: Optional[np.random.Generator] = None,
):
    """(BCSpec, BCState, is_fixed (nv_obj,), V_obj') for one object;
    V_obj' is the position array after the BC's initialisation (scale,
    randomize)."""
    dev = resolve_device(device)
    nvo, d = V_obj.shape
    g0, g1 = boundary_groups(V_obj, cfg.ratio, cfg.axis)
    t = cfg.type
    is_fixed = np.zeros(nvo, dtype=bool)
    V_out = V_obj.copy()

    if t == "null":
        pass
    elif t == "scale":
        off = 0.5 * (V_obj.min(axis=0) + V_obj.max(axis=0))
        V_out = (V_obj - off) * 1.5 + off
    elif t == "randomize":
        rng = rng or np.random.default_rng(0)
        off = 0.5 * (V_obj.min(axis=0) + V_obj.max(axis=0))
        off[1] += (V_obj[:, 1].max() - V_obj[:, 1].min()) * 0.5
        V_out = rng.uniform(-0.5, 0.5, size=V_obj.shape)
        V_out = V_out + (off - V_out[0])
    elif t == "onepoint":
        is_fixed[0] = True
    elif t == "hang":
        for g in (g0, g1):
            idx = np.nonzero(g)[0]
            if len(idx):
                is_fixed[idx[-1]] = True
    elif t == "hangends":
        is_fixed[g1] = True
    elif t in ("bend", "stretch", "twist", "translate", "twist-and-stretch"):
        if t != "translate":  # translate pins group 1 only
            is_fixed[g0] = True
        is_fixed[g1] = True
    else:
        raise KeyError(f"unknown boundary condition '{t}' (have {BC_NAMES})")

    center = 0.5 * (V_out.min(axis=0) + V_out.max(axis=0))
    idx0 = np.nonzero(g0)[0]
    idx1 = np.nonzero(g1)[0]
    center0 = V_out[idx0[-1]] if len(idx0) else np.zeros(d)
    center1 = V_out[idx1[-1]] if len(idx1) else np.zeros(d)
    vel_vec = np.zeros(d)
    vel_vec[cfg.axis] = cfg.velocity

    def vec(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype, device=dev)

    def gmask(g):
        m = np.zeros(nv_total)
        m[offset : offset + nvo] = g.astype(np.float64)
        return vec(m)

    spec = BCSpec(
        group0=gmask(g0), group1=gmask(g1), fixed=gmask(is_fixed),
        center=vec(center), center0=vec(center0), center1=vec(center1),
        vel_vec=vec(vel_vec), type=t, velocity=cfg.velocity,
        duration=cfg.duration, flip=cfg.flip,
    )
    return spec, BCState(), is_fixed, V_out


def _rot_about(V, center, angle: float, axis_3d: str):
    """Positions rotated about `center` by `angle`: in the plane in 2D, about
    the x or z axis in 3D."""
    c, s = math.cos(angle), math.sin(angle)
    P = V - center
    if V.shape[1] == 2:
        Q = torch.stack([c * P[:, 0] - s * P[:, 1], s * P[:, 0] + c * P[:, 1]],
                        dim=-1)
    elif axis_3d == "x":
        y = c * P[:, 1] - s * P[:, 2]
        z = s * P[:, 1] + c * P[:, 2]
        Q = torch.stack([P[:, 0], y, z], dim=-1)
    else:  # "z"
        x = c * P[:, 0] - s * P[:, 1]
        y = s * P[:, 0] + c * P[:, 1]
        Q = torch.stack([x, y, P[:, 2]], dim=-1)
    return Q + center


def _two_group_motion(spec: BCSpec, V, V0r, V1r):
    return V + (spec.group0[:, None] * (V0r - V)
                + spec.group1[:, None] * (V1r - V))


def bc_step(spec: BCSpec, st: BCState, V: torch.Tensor, dt: float):
    """Advance a scripted BC one timestep: (V', st'). Static types return
    their input."""
    t = spec.type
    if t in ("null", "scale", "randomize", "onepoint", "hang", "hangends"):
        return V, st

    if t == "stretch":
        # group 0 moves at +velocity along the axis, group 1 at -velocity
        dV = (spec.group0[:, None] * spec.vel_vec
              - spec.group1[:, None] * spec.vel_vec) * dt
        return V + dV, st

    if t == "translate":
        # group 1 moves at -velocity for `duration`, then back if `flip`
        vel = spec.vel_vec if st.reversed else -spec.vel_vec
        active = 0.0 if st.done else 1.0
        dV = spec.group1[:, None] * vel * (dt * active)
        elapsed = st.elapsed + dt * active
        expire = elapsed > spec.duration
        reversed_, done = st.reversed, st.done
        if spec.flip:
            newly_rev = expire and not st.reversed
            done = st.done or (expire and st.reversed)
            if newly_rev:
                elapsed = 0.0
            reversed_ = st.reversed or newly_rev
        else:
            done = st.done or expire
        return V + dV, BCState(elapsed=elapsed, reversed=reversed_, done=done)

    a = spec.velocity * math.pi * dt
    if t == "twist":
        # the groups rotate about the x axis (in the plane in 2D) at
        # +-velocity*pi rad/s about the object's bounding-box center
        return _two_group_motion(
            spec, V, _rot_about(V, spec.center, a, "x"),
            _rot_about(V, spec.center, -a, "x"),
        ), st

    if t == "bend":
        # like twist, about the z axis and per-group centers
        return _two_group_motion(
            spec, V, _rot_about(V, spec.center0, a, "z"),
            _rot_about(V, spec.center1, -a, "z"),
        ), st

    if t == "twist-and-stretch":
        # twist, plus a translation of -+0.05 along the axis
        axis_vel = spec.vel_vec / max(abs(spec.velocity), 1e-30)
        trans = -0.05 * axis_vel * dt
        return _two_group_motion(
            spec, V, _rot_about(V, spec.center, a, "x") + trans,
            _rot_about(V, spec.center, -a, "x") - trans,
        ), st

    raise KeyError(f"unknown boundary condition '{t}'")
