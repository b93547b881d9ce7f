"""S-space material models (port of the S-space part of
mixedfem_tpu/materials/models.py).

Each of the six models is a scalar energy density psi(s, mu, la) of the
sym-vec stretch s = [S00,S11,S22,S01,S02,S12] (3D) or [S00,S11,S01] (2D);
gradients and Hessians come from torch.func (grad / hessian under vmap).
Energy forms, d the dimension:
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


def _dispatch(transform, models, s, mu, la, model_id):
    """Per-element evaluation under (possibly) mixed models: one model is a
    straight vmap; with several, each model evaluates the whole batch and
    the results are selected by mask."""
    if len(models) == 1:
        return transform(psi_s(models[0]))(s, mu, la)
    out = None
    for i, name in enumerate(models):
        val = transform(psi_s(name))(s, mu, la)
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
