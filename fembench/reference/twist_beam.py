"""The judge of a twisted stable neo-Hookean tet solid (one object, a
`twist` BC, mixed stretch): what the comparison keeps of each step, the
three numbers it reads, the test of a failed step, and the reference's own
episode that the control puts in the program's place.

For step j of an episode (x_j, s_j the program's answer, x_0 the rest
positions), the reference works out again the inertia target from the
answers before it (x_tilde = x_{j-1} + (x_{j-1} - x_{j-2}), at rest for
j = 1), the pinned vertices and the twist's positions, and reads:

- residual: the x-row of the mixed system at the solve's answer (x_j, s_j;
  the multipliers at their stationary value h^2 dpsi/dS(s_j); the answer's
  pinned rows are the start's, as the BC moves them after the solve),
  over |dE/dx| at the solve's start x_{j-1} (free vertices): how far the
  step solved its system. (|dE/dx| at x_j itself would read mostly the
  float32 rounding of x_j: an ulp of a coordinate near 4 strains an
  element of 0.05 by 1e-5, a few % of the step's forces at 800k tets.
  The mixed row takes the stress from s_j, whose ulp near 1 is 6e-8);
- stretch_gap: |s_j - S(F(x_j))| over |S(F(x_j)) - I| (Frobenius over all
  elements): how far the stretch the update left is from the
  deformation's own;
- bc_gap: the largest distance of a pinned vertex of x_j from the twist's
  position after j increments, over the largest distance the twist moved
  one.

Each is the largest over the episode's steps. A configuration names this
module by its `reference` key (fembench/check.py)."""

from __future__ import annotations

import numpy as np
import torch

from fembench.reference import fem

NUMBERS = ("residual", "stretch_gap", "bc_gap")
# fields of each step's state the comparison keeps, and whose rows they are
# ("element" rows are handed over in the file's element order)
KEEP = {"x": "vertex", "s": "element"}


class Scene:
    """The reference's scene: the body, its two pinned end slabs and the
    twist's velocity."""

    def __init__(self, body: fem.Body, groups, velocity: float):
        self.body, self.groups, self.velocity = body, groups, velocity
        self.gmask = [torch.as_tensor(g, device=body.device) for g in groups]
        self.pinned = self.gmask[0] | self.gmask[1]


def prepare(config: dict, traffic: dict, meshes, device,
            dtype=torch.float64) -> Scene:
    """The reference scene of the configuration's one object, from its own
    numbers (meshes: per object (V, T) in the file's order)."""
    if len(meshes) != 1:
        raise ValueError("twist_beam judges one-object scenes")
    (V0, T), obj = meshes[0], config["objects"][0]
    scene = dict(config["scene"], **traffic.get("scene", {}))
    mat = scene["material_models"][0]
    bc = obj["scene"]["boundary_condition"]
    if bc["type"] != "twist" or mat["energy"] != "Stable-Neohookean" \
            or T.shape[1] != 4:
        raise ValueError("twist_beam judges a twisted SNH tet solid")
    groups = fem.end_slabs(V0, bc.get("ratio", 0.1), bc.get("axis", 0))
    body = fem.Body(V0, T, youngs=mat["youngs_modulus"],
                    poisson=mat["poissons_ratio"], density=mat["density"],
                    gravity=scene.get("body_force", (0.0, -9.8, 0.0)),
                    h=scene["dt"], pinned=groups[0] | groups[1], dtype=dtype,
                    device=device)
    return Scene(body, groups, bc.get("velocity", 0.1))


def failed(state, T: torch.Tensor) -> torch.Tensor:
    """On the device, without a sync: 1 if the step's positions have a
    non-finite value or turn an element of T (file order) inside out."""
    xe = state.x[T]
    vol6 = fem.det3(xe[:, 1:] - xe[:, :1])
    return (~torch.isfinite(state.x).all() | (vol6 <= 0).any()).to(
        torch.int32)


def readings(ref: Scene, steps: list[dict]) -> dict:
    """The three numbers of one episode from rest: steps[j] holds "x" (nv,
    3) and "s" (E, 6), the elements in the file's order, after step j + 1."""
    body = ref.body
    V0 = body.V0
    w = body.tensor(fem.SYM_WEIGHTS)
    eye = body.tensor([1, 1, 1, 0, 0, 0])
    out = {k: 0.0 for k in NUMBERS}
    hist = [V0, V0]  # x_{j-1}, x_{j-2}
    for j, step in enumerate(steps, start=1):
        x, s = body.tensor(step["x"]), body.tensor(step["s"])
        x_prev, x_prev2 = hist
        x_tilde = x_prev + (x_prev - x_prev2)
        x_star = torch.where(ref.pinned[:, None], x_prev, x)
        g0 = torch.linalg.vector_norm(body.gradient(x_prev, x_tilde))
        g1 = torch.linalg.vector_norm(body.mixed_gradient(x_star, s, x_tilde))
        S = body.stretch(x_star)
        gap = torch.sqrt(torch.sum(w * (s - S) ** 2))
        strain = torch.sqrt(torch.sum(w * (S - eye) ** 2))
        twist = fem.twist_positions(V0, ref.gmask, j, body.h, ref.velocity)
        moved = torch.linalg.vector_norm(twist - V0, dim=1)[ref.pinned].amax()
        miss = torch.linalg.vector_norm(x - twist, dim=1)[ref.pinned].amax()
        reading = {"residual": g1 / g0, "stretch_gap": gap / strain,
                   "bc_gap": miss / moved}
        for k, v in reading.items():
            v = float(v)
            out[k] = max(out[k], v) if np.isfinite(v) else float("inf")
        hist = [x, x_prev]
    return out


def control_episode(ref: Scene, steps: int) -> list[dict]:
    """The reference's own steps from rest, in the scene's dtype (the
    elements in the file's order): its Newton step in the program's
    place, then the twist."""
    body = ref.body
    pinned = ref.pinned[:, None]
    x, v = body.V0.clone(), torch.zeros_like(body.V0)
    out = []
    for j in range(1, steps + 1):
        x_solve = body.newton_step(x, v)
        # the stretch of the solve's answer (torch's SVD has no bfloat16:
        # that of bfloat16 positions in float32, rounded back)
        F = body.def_grad(x_solve)
        s = fem.polar_stretch(F.float() if body.dtype == torch.bfloat16
                              else F).to(body.dtype)
        # the twist moves the end slabs after the solve
        twist = fem.twist_positions(body.V0, ref.gmask, j, body.h,
                                    ref.velocity)
        x_new = torch.where(pinned, twist, x_solve)
        v = (x_new - x) / body.h
        x = x_new
        out.append({"x": x, "s": s})
    return out
