"""External (Neumann / body) forces (port of
mixedfem_tpu/bc/external_force.py, host numpy).

Per-vertex accelerations added to the inertia target as dt^2 * f. 'area'
applies the force to every vertex (a body force, gravity by default) or
to boundary group 1; 'stretch' applies +force to group 0 and -force to
group 1. 'press' is the dynamic controller of bc/press.py and adds nothing
here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from mixedfem_tpu_torch.bc.boundary_conditions import boundary_groups

EXT_NAMES = ("area", "stretch", "press")


@dataclasses.dataclass(frozen=True)
class ExtConfig:
    type: str = "area"
    is_body_force: bool = True
    force: Tuple[float, float, float] = (0.0, -9.8, 0.0)
    axis: int = 0
    ratio: float = 0.1
    # mechanical press parameters
    max_force: float = 100.0
    target_velocity: float = 0.1
    max_displacement: float = 0.3
    flip: bool = False


def build_external_force(V_obj: np.ndarray, cfg: ExtConfig) -> np.ndarray:
    """(nv_obj, d) static per-vertex force of one object."""
    nvo, d = V_obj.shape
    f = np.asarray(cfg.force[:d], dtype=np.float64)
    out = np.zeros((nvo, d))
    g0, g1 = boundary_groups(V_obj, cfg.ratio, cfg.axis)
    if cfg.type == "area":
        if cfg.is_body_force:
            out[:] = f
        else:
            out[g1] = f
    elif cfg.type == "stretch":
        out[g0] = f
        out[g1] = -f
    elif cfg.type != "press":
        raise KeyError(f"unknown external force '{cfg.type}' (have {EXT_NAMES})")
    return out
