"""Simulation configuration (port of mixedfem_tpu/config.py).

Same fields and defaults as the JAX package's SimConfig, without the TPU-only
``matvec_scheme`` (the bf16 hi/lo split of the brick matvec). Fields that
select paths this port does not cover yet are kept so that a configuration
carries across unchanged; ``optimizer.newton.newton_step`` raises
NotImplementedError for them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def enu_to_lame(ym: float, pr: float) -> Tuple[float, float]:
    """Young's modulus / Poisson ratio -> (lambda, mu)."""
    la = (ym * pr) / ((1.0 + pr) * (1.0 - 2.0 * pr))
    mu = ym / (2.0 * (1.0 + pr))
    return la, mu


@dataclasses.dataclass(frozen=True)
class MaterialConfig:
    """Per-object material parameters."""

    model: str = "stable-neohookean"  # a name of materials.models.MATERIAL_NAMES
    ym: float = 1e6
    pr: float = 0.45
    density: float = 1000.0
    thickness: float = 1e-3  # shells only

    @property
    def la(self) -> float:
        return enu_to_lame(self.ym, self.pr)[0]

    @property
    def mu(self) -> float:
        return enu_to_lame(self.ym, self.pr)[1]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Global simulation parameters; see mixedfem_tpu/config.py for the
    meaning of each field."""

    h: float = 0.034
    body_force: Tuple[float, float, float] = (0.0, -9.8, 0.0)
    timesteps: int = 300
    outer_steps: int = 5
    ls_iters: int = 20
    newton_tol: float = 1e-10
    inertia_blend_factor: float = 1.0

    contact_mu: float = 0.5
    espv: float = 1e-3
    kappa: float = 10.0
    enable_ccd: bool = False
    dhat: float = 1e-2
    max_contact_frames: int = 0
    ee_mollifier: bool = False

    solver: str = "pcg"
    coarse_refresh_every: int = 1
    coarse_inverse_method: str = "newton-schulz"
    max_iterative_solver_iters: int = 500
    itr_tol: float = 1e-4

    integrator: str = "BDF1"
    optimizer: str = "newton"

    mixed_variables: Tuple[str, ...] = ("mixed-stretch", "mixed-collision")
    variables: Tuple[str, ...] = ()

    dtype: str = "float64"
    rhs_precision: str = "native"
    ls_strict: bool = False
    rotation_warm_start: bool = False
    lap_cheby_degree: int = 16
    da_iters: int = 10
    admm_rho_scale: float = 3.0
    admm_inner_iters: int = 30
    admm_precond_sweeps: int = 2

    show_data: bool = True
    show_timing: bool = True
    save_substeps: bool = False

    record_vanilla_gradient: bool = False
