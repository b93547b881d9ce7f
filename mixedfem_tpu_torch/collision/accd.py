"""Additive CCD: conservative step-size limiting for contact (port of
mixedfem_tpu/collision/accd.py).

Per candidate frame, time advances by conservative increments
t_l = 0.9 d / l_p until the distance drops below 0.1 d0; the step limit is
the minimum over the real frames (scaled by 0.9 by the caller). The JAX
package runs one while-loop per frame under vmap, capped at 256
iterations, where a finished frame stops changing. Here all frames advance
together in one batched loop that freezes the frames that are done, and
the host reads whether any frame is still running once every 16
iterations; each frame's t is the JAX package's.
"""

from __future__ import annotations

import torch

from mixedfem_tpu_torch.collision import distances as dist

_S = 0.1            # scaling factor (the reference's additive_ccd.cpp:27)
_MAX_ITERS = 256
_CHECK_EVERY = 16   # iterations between host reads of "all done"


def accd_t(verts0, pverts, ftype):
    """Per-frame CCD time in (0, 1]: verts0 (C, 4, d) positions, pverts
    (C, 4, d) motion. At every host check the frames still running are
    gathered into a smaller working set; that changes no frame's
    arithmetic."""
    # subtract the mean motion; bound the relative motion by 2 x the
    # largest vertex motion (conservative for every frame type)
    p = pverts - pverts.mean(dim=1, keepdim=True)
    l_p = torch.sqrt(torch.sum(p * p, dim=-1)).amax(dim=-1) * 2.0
    l_safe = torch.clamp(l_p, min=1e-30)
    d0 = dist.frame_distance(verts0, ftype)

    t_all = torch.zeros_like(d0)
    state = dict(t=torch.zeros_like(d0), t_l=(1.0 - _S) * d0 / l_safe, v=verts0, p=p,
                 g=_S * d0, l=l_safe, ftype=ftype, done=l_p <= 1e-12)
    rows = torch.arange(d0.shape[0], device=d0.device)
    for it in range(_MAX_ITERS):
        if it % _CHECK_EVERY == 0:
            t_all[rows] = state["t"]
            run = torch.nonzero(~state["done"]).squeeze(1)
            if run.numel() == 0:
                break
            rows = rows[run]
            state = {k: a[run] for k, a in state.items()}
        t, t_l, v, done = state["t"], state["t_l"], state["v"], state["done"]
        v_new = v + t_l[:, None, None] * state["p"]
        dcur = dist.frame_distance(v_new, state["ftype"])
        hit = (t > 0.0) & (dcur < state["g"])
        t_new = torch.where(hit, t, t + t_l)
        over = t_new > 1.0
        run = ~done
        state["t"] = torch.where(run, torch.where(over, 1.0, t_new), t)
        state["t_l"] = torch.where(run, 0.9 * dcur / state["l"], t_l)
        state["v"] = torch.where(run[:, None, None], v_new, v)
        state["done"] = done | hit | over
    t_all[rows] = state["t"]
    # tiny motion -> unconstrained
    return torch.where(l_p <= 1e-12, 1.0, torch.clamp(t_all, max=1.0))


def accd_alpha(frames, ftype, fmask, x, p_full):
    """Min CCD step over the real candidate frames (fmask > 0): frames
    (C, 4) int32, x and p_full (nv, d). A scalar tensor in (0, 1]."""
    real = torch.nonzero(fmask > 0).squeeze(1)
    if real.numel() == 0:
        return x.new_ones(())
    idx = frames[real].long()
    return accd_t(x[idx], p_full[idx], ftype[real]).amin()
