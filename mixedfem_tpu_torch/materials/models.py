"""Material models in S-space (the mixed stretch) and F-space (the vanilla
stretch) (port of mixedfem_tpu/materials/models.py).

Each of the six models is a scalar energy density psi(s, mu, la) of the
sym-vec stretch s = [S00,S11,S22,S01,S02,S12] (3D) or [S00,S11,S01] (2D),
and psi(F, mu, la) of a (d, d) deformation gradient; gradients and
Hessians come from torch.func (grad / hessian under vmap). S-space energy
forms, d the dimension:
  ARAP   : mu/2 |S - I|_F^2
  Corot  : la/2 (trS - d)^2 + mu |S - I|_F^2
  FixedCorot: la/2 (det S - 1)^2 + mu |S - I|_F^2
  SNH    : mu (1 - det S) + la/2 (1 - det S)^2 + mu/2 (|S|^2 - d)
  Neohookean: -mu log(det S) + la/2 log^2(det S) + mu/2 (|S|^2 - d)
  Fung (c=4): mu/2 (e^{c(|S|^2-d)/2} - 1) + mu/2 (|S|^2 - d)
              + la/2 ((mu + c mu)/la + 1 - det S)^2
The log guard uses the double-where pattern so derivatives stay finite;
infeasible states (det <= 0) get a large finite energy.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.func import grad, hessian, vmap

from mixedfem_tpu_torch.ops import rotation

MATERIAL_NAMES: Tuple[str, ...] = (
    "ARAP",
    "Corot",
    "FixedCorot",
    "Fung",
    "Neohookean",
    "Stable-Neohookean",
)

_FUNG_C = 4.0
_BIG = 1e12


def model_index(name: str) -> int:
    for i, n in enumerate(MATERIAL_NAMES):
        if n.lower() == name.lower():
            return i
    raise KeyError(f"unknown material model '{name}' (have {MATERIAL_NAMES})")


def _invariants_s(s):
    """(tr, |S|^2, det, d) of a sym-vec s of length 6 (3D) or 3 (2D)."""
    if s.shape[-1] == 3:
        return (s[0] + s[1], s[0] ** 2 + s[1] ** 2 + 2.0 * s[2] ** 2,
                s[0] * s[1] - s[2] ** 2, 2.0)
    tr = s[0] + s[1] + s[2]
    n2 = s[0] ** 2 + s[1] ** 2 + s[2] ** 2 + 2.0 * (
        s[3] ** 2 + s[4] ** 2 + s[5] ** 2
    )
    det = (
        s[0] * s[1] * s[2]
        + 2.0 * s[3] * s[4] * s[5]
        - s[0] * s[5] ** 2
        - s[1] * s[4] ** 2
        - s[2] * s[3] ** 2
    )
    return tr, n2, det, 3.0


def _norm_smi2(s):
    """|S - I|_F^2 in sym-vec form."""
    if s.shape[-1] == 3:
        return (s[0] - 1.0) ** 2 + (s[1] - 1.0) ** 2 + 2.0 * s[2] ** 2
    return (s[0] - 1.0) ** 2 + (s[1] - 1.0) ** 2 + (s[2] - 1.0) ** 2 + 2.0 * (
        s[3] ** 2 + s[4] ** 2 + s[5] ** 2
    )


def _safe_log(det):
    ok = det > 0
    return torch.where(ok, torch.log(torch.where(ok, det, 1.0)), 0.0), ok


def _psi_arap(s, mu, la):
    return 0.5 * mu * _norm_smi2(s)


def _psi_corot(s, mu, la):
    tr, _, _, d = _invariants_s(s)
    return 0.5 * la * (tr - d) ** 2 + mu * _norm_smi2(s)


def _psi_fcr(s, mu, la):
    _, _, det, _ = _invariants_s(s)
    return 0.5 * la * (det - 1.0) ** 2 + mu * _norm_smi2(s)


def _psi_snh(s, mu, la):
    _, n2, det, d = _invariants_s(s)
    return mu * (1.0 - det) + 0.5 * la * (1.0 - det) ** 2 + 0.5 * mu * (n2 - d)


def _psi_nh(s, mu, la):
    _, n2, det, d = _invariants_s(s)
    logd, ok = _safe_log(det)
    e = -mu * logd + 0.5 * la * logd**2 + 0.5 * mu * (n2 - d)
    return torch.where(ok, e, _BIG)


def _psi_fung(s, mu, la):
    _, n2, det, d = _invariants_s(s)
    c = _FUNG_C
    return (
        0.5 * mu * (torch.exp(0.5 * c * (n2 - d)) - 1.0)
        + 0.5 * mu * (n2 - d)
        + 0.5 * la * ((mu + c * mu) / la + 1.0 - det) ** 2
    )


_PSI_S = (_psi_arap, _psi_corot, _psi_fcr, _psi_fung, _psi_nh, _psi_snh)
# order matches MATERIAL_NAMES


def psi_s(name: str):
    return _PSI_S[model_index(name)]


def _dispatch(transform, models, s, mu, la, model_id, table=_PSI_S):
    """Per-element evaluation under (possibly) mixed models: one model is a
    straight vmap; with several, each model evaluates the whole batch and
    the results are selected by mask. `table` holds the densities in
    MATERIAL_NAMES order."""
    if len(models) == 1:
        return transform(table[model_index(models[0])])(s, mu, la)
    out = None
    for i, name in enumerate(models):
        val = transform(table[model_index(name)])(s, mu, la)
        mask = (model_id == i).to(val.dtype)
        mask = mask.reshape(mask.shape + (1,) * (val.ndim - 1))
        out = val * mask if out is None else out + val * mask
    return out


def psi_s_all(s, mu, la, model_id, models):
    """(E, N) stretches -> (E,) energy densities."""
    return _dispatch(vmap, models, s, mu, la, model_id)


def grad_s_all(s, mu, la, model_id, models):
    """(E, N) -> (E, N) gradients dpsi/ds."""
    return _dispatch(lambda f: vmap(grad(f)), models, s, mu, la, model_id)


def hess_s_all(s, mu, la, model_id, models):
    """(E, N) -> (E, N, N) Hessians d2psi/ds2."""
    return _dispatch(lambda f: vmap(hessian(f)), models, s, mu, la, model_id)


# ---------------------------------------------------------------------------
# F-space densities psi(F, mu, la) of the vanilla stretch variable, F a
# (d, d) matrix. ARAP, Corot and FixedCorot differentiate through the
# branch-free polar decomposition (ops/rotation.py: 8 Jacobi sweeps in 3D,
# the closed form in 2D). FixedCorot keeps its volume term in the energy;
# Fung, which has no F-space form in the reference, gets the natural
# extension of its S-space form.
# ---------------------------------------------------------------------------

def _rotation_of(F):
    if F.shape[-1] == 3:
        R, _ = rotation.polar33(F[None], sweeps=8)
    else:
        R, _ = rotation.polar22(F[None])
    return R[0]


def _det(F):
    if F.shape[-1] == 3:
        return rotation.det3(F)
    return F[0, 0] * F[1, 1] - F[0, 1] * F[1, 0]


def _psiF_arap(F, mu, la):
    R = _rotation_of(F)
    return 0.5 * mu * torch.sum((F - R) ** 2)


def _psiF_corot(F, mu, la):
    R = _rotation_of(F)
    S = R.T @ F
    d = F.shape[-1]
    tr = torch.trace(S)
    eye = torch.eye(d, dtype=F.dtype, device=F.device)
    return 0.5 * la * (tr - d) ** 2 + mu * torch.sum((S - eye) ** 2)


def _psiF_fcr(F, mu, la):
    R = _rotation_of(F)
    J = _det(F)
    return 0.5 * mu * torch.sum((F - R) ** 2) + 0.5 * la * (J - 1.0) ** 2


def _psiF_snh(F, mu, la):
    d = F.shape[-1]
    J = _det(F)
    return (mu * (1.0 - J) + 0.5 * la * (1.0 - J) ** 2
            + 0.5 * mu * (torch.sum(F ** 2) - d))


def _psiF_nh(F, mu, la):
    d = F.shape[-1]
    logJ, ok = _safe_log(_det(F))
    e = -mu * logJ + 0.5 * la * logJ ** 2 + 0.5 * mu * (torch.sum(F ** 2) - d)
    return torch.where(ok, e, _BIG)


def _psiF_fung(F, mu, la):
    d = F.shape[-1]
    J = _det(F)
    n2 = torch.sum(F ** 2)
    c = _FUNG_C
    return (
        0.5 * mu * (torch.exp(0.5 * c * (n2 - d)) - 1.0)
        + 0.5 * mu * (n2 - d)
        + 0.5 * la * ((mu + c * mu) / la + 1.0 - J) ** 2
    )


_PSI_F = (_psiF_arap, _psiF_corot, _psiF_fcr, _psiF_fung, _psiF_nh, _psiF_snh)


def psi_F(name: str):
    return _PSI_F[model_index(name)]


def psi_F_all(F, mu, la, model_id, models):
    """(E, d, d) deformation gradients -> (E,) energy densities."""
    return _dispatch(vmap, models, F, mu, la, model_id, _PSI_F)


def grad_F_all(F, mu, la, model_id, models):
    """(E, d, d) -> (E, d, d) gradients dpsi/dF."""
    return _dispatch(lambda f: vmap(grad(f)), models, F, mu, la, model_id,
                     _PSI_F)


def hess_F_all(F, mu, la, model_id, models):
    """(E, d, d) -> (E, d*d, d*d) Hessians in row-major flattened F order."""
    d = F.shape[-1]

    def flat_hess(psi):
        def f(Fv, mu, la):
            return psi(Fv.reshape(d, d), mu, la)

        return vmap(hessian(f))

    return _dispatch(flat_hess, models, F.reshape(F.shape[0], d * d), mu, la,
                     model_id, _PSI_F)
