"""IPC barrier function and derivatives (port of
mixedfem_tpu/collision/barrier.py).

On the SQUARED distance t with threshold t_hat:

  b(t, t_hat) = -(t - t_hat)^2 ln(t / t_hat)   for 0 < t < t_hat, else 0

The mixed-collision energy is kappa b(d^2, dhat^2); its derivatives w.r.t.
the unsquared mixed distance d follow by the chain rule:
  dpsi/dd   = kappa 2 d b'(d^2)
  d2psi/dd2 = kappa (4 d^2 b''(d^2) + 2 b'(d^2)), clamped >= 1e-8.
"""

from __future__ import annotations

import torch


def barrier(t, t_hat):
    """b(t, t_hat); zero for t >= t_hat (the caller guards t <= 0)."""
    ok = (t > 0) & (t < t_hat)
    ts = torch.where(ok, t, t_hat)
    return torch.where(ok, -((ts - t_hat) ** 2) * torch.log(ts / t_hat), 0.0)


def barrier_gradient(t, t_hat):
    """db/dt, with t clamped to >= 1e-8 t_hat inside the 1/t terms: below
    that t*t underflows float32 and the derivative overflows to inf, which
    would poison masked frames through inf * 0 = NaN."""
    ok = (t > 0) & (t < t_hat)
    ts = torch.where(ok, torch.clamp(t, min=1e-8 * t_hat), t_hat)
    val = -2.0 * (ts - t_hat) * torch.log(ts / t_hat) - (ts - t_hat) ** 2 / ts
    return torch.where(ok, val, 0.0)


def barrier_hessian(t, t_hat):
    """d2b/dt2 (the same relative clamp as barrier_gradient)."""
    ok = (t > 0) & (t < t_hat)
    ts = torch.where(ok, torch.clamp(t, min=1e-8 * t_hat), t_hat)
    val = (
        -2.0 * torch.log(ts / t_hat)
        - 4.0 * (ts - t_hat) / ts
        + (ts - t_hat) ** 2 / (ts * ts)
    )
    return torch.where(ok, val, 0.0)


def mixed_barrier_grad_hess(d, dhat, kappa):
    """(dpsi/dd, d2psi/dd2) of psi(d) = kappa b(d^2, dhat^2), the Hessian
    clamped to >= 1e-8."""
    d2 = d * d
    dh2 = dhat * dhat
    g = barrier_gradient(d2, dh2)
    grad = kappa * (2.0 * d * g)
    hess = kappa * (4.0 * d2 * barrier_hessian(d2, dh2) + 2.0 * g)
    return grad, torch.clamp(hess, min=1e-8)
