"""Closed-form primitive distances (point-point/edge/triangle, edge-edge)
and the padded contact-frame dispatch (port of
mixedfem_tpu/collision/distances.py).

Each function computes the true clamped distance branch-free
(torch.where), so autodiff through it gives the distance gradient
everywhere. All functions take stacked vertex arguments (..., d) and return
UNSQUARED distances. The clamps to [0, 1] are max/min pairs, whose gradient
splits evenly at a tie, as the JAX package's jnp.clip does.
"""

from __future__ import annotations

import torch

_EPS = 1e-12

# frame types: 0 = point-triangle (p, t0, t1, t2); 1 = edge-edge
# (p0, p1, q0, q1); 2 = point-edge (p, e0, e1, -); 3 = point-point (p, q, -, -)
PT, EE, PE, PP = 0, 1, 2, 3


def _safe_div(a, b):
    ok = b.abs() > _EPS
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def _safe_norm(v):
    """NaN-free Euclidean norm with a finite gradient (0) at v = 0. Padded
    contact frames gather coincident vertices, and autodiff of sqrt at 0
    would otherwise poison masked arithmetic (0 * nan = nan)."""
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-30)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _clip01(t):
    return torch.minimum(torch.maximum(t.new_zeros(()), t), t.new_ones(()))


def point_point(p0, p1):
    return _safe_norm(p0 - p1)


def _pe_param(p, e0, e1):
    d = e1 - e0
    return _clip01(_safe_div(_dot(p - e0, d), _dot(d, d)))


def point_edge(p, e0, e1):
    """Distance from point p to segment [e0, e1]."""
    t = _pe_param(p, e0, e1)
    return _safe_norm(p - (e0 + t[..., None] * (e1 - e0)))


def _pt_regions(p, t0, t1, t2):
    """Ericson's region tests (Real-Time Collision Detection, 5.1.5): the
    interior barycentrics (v, w), the vertex and edge region masks, and
    the edge parameters."""
    ab = t1 - t0
    ac = t2 - t0
    ap = p - t0
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - t1
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - t2
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    r = dict(
        v=_safe_div(vb, denom),
        w=_safe_div(vc, denom),
        in_a=(d1 <= 0) & (d2 <= 0),
        in_b=(d3 >= 0) & (d4 <= d3),
        in_c=(d6 >= 0) & (d5 <= d6),
        on_ab=(vc <= 0) & (d1 >= 0) & (d3 <= 0),
        on_ac=(vb <= 0) & (d2 >= 0) & (d6 <= 0),
        on_bc=(va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0),
        t_ab=_safe_div(d1, d1 - d3),
        t_ac=_safe_div(d2, d2 - d6),
        t_bc=_safe_div(d4 - d3, (d4 - d3) + (d5 - d6)),
    )
    return r


def point_triangle(p, t0, t1, t2):
    """Distance from point p to triangle (t0, t1, t2) in 3D."""
    r = _pt_regions(p, t0, t1, t2)
    ab = t1 - t0
    ac = t2 - t0
    c = t0 + r["v"][..., None] * ab + r["w"][..., None] * ac
    c = torch.where(r["on_bc"][..., None], t1 + r["t_bc"][..., None] * (t2 - t1), c)
    c = torch.where(r["on_ac"][..., None], t0 + r["t_ac"][..., None] * ac, c)
    c = torch.where(r["on_ab"][..., None], t0 + r["t_ab"][..., None] * ab, c)
    c = torch.where(r["in_c"][..., None], t2, c)
    c = torch.where(r["in_b"][..., None], t1, c)
    c = torch.where(r["in_a"][..., None], t0, c)
    return _safe_norm(p - c)


def _ee_params(p0, p1, q0, q1):
    """Lumelsky's clamped closest-point parameters (s, t) of two segments."""
    d1 = p1 - p0
    d2 = q1 - q0
    r = p0 - q0
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b
    s = _clip01(_safe_div(b * f - c * e, denom))
    # recompute t given s, then clamp and recompute s
    t = _safe_div(b * s + f, e)
    t_cl = _clip01(t)
    s2 = _clip01(_safe_div(b * t_cl - c, a))
    s = torch.where((t < 0) | (t > 1), s2, s)
    return s, t_cl


def edge_edge(p0, p1, q0, q1):
    """Distance between segments [p0, p1] and [q0, q1] in 3D."""
    s, t = _ee_params(p0, p1, q0, q1)
    cp = p0 + s[..., None] * (p1 - p0)
    cq = q0 + t[..., None] * (q1 - q0)
    return _safe_norm(cp - cq)


def frame_distance(verts, ftype):
    """verts (..., 4, d) gathered frame vertices, ftype (...,) int32: the
    UNSQUARED distance per frame, every type evaluated and selected (2D:
    point-edge and point-point)."""
    v0, v1, v2, v3 = (verts[..., i, :] for i in range(4))
    if verts.shape[-1] == 2:
        return torch.where(ftype == PE, point_edge(v0, v1, v2),
                           point_point(v0, v1))
    d_pt = point_triangle(v0, v1, v2, v3)
    d_ee = edge_edge(v0, v1, v2, v3)
    d_pe = point_edge(v0, v1, v2)
    d_pp = point_point(v0, v1)
    out = torch.where(ftype == PT, d_pt, d_pp)
    out = torch.where(ftype == EE, d_ee, out)
    return torch.where(ftype == PE, d_pe, out)


def frame_distance_grad(verts, ftype):
    """(C, 4, d) gradient of each frame's distance w.r.t. its 4 vertices.
    Frames are independent, so the gradient of the summed distances is the
    per-frame gradient (the JAX package's vmap(grad))."""
    return torch.func.grad(lambda v: frame_distance(v, ftype).sum())(verts)


def _pt_bary(p, t0, t1, t2):
    """Clamped barycentric coordinates of the closest point on the
    triangle."""
    r = _pt_regions(p, t0, t1, t2)
    v, w = r["v"], r["w"]
    u = 1.0 - v - w
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    bary = torch.stack([u, v, w], dim=-1)
    t_bc, t_ac, t_ab = r["t_bc"], r["t_ac"], r["t_ab"]
    bary = torch.where(r["on_bc"][..., None],
                       torch.stack([zero, 1 - t_bc, t_bc], dim=-1), bary)
    bary = torch.where(r["on_ac"][..., None],
                       torch.stack([1 - t_ac, zero, t_ac], dim=-1), bary)
    bary = torch.where(r["on_ab"][..., None],
                       torch.stack([1 - t_ab, t_ab, zero], dim=-1), bary)
    bary = torch.where(r["in_c"][..., None], torch.stack([zero, zero, one], -1), bary)
    bary = torch.where(r["in_b"][..., None], torch.stack([zero, one, zero], -1), bary)
    return torch.where(r["in_a"][..., None], torch.stack([one, zero, zero], -1), bary)


def frame_contact_weights(verts, ftype):
    """(..., 4) relative-displacement weights at the closest point:
    u_rel = sum_k w_k U[v_k]."""
    v0, v1, v2, v3 = (verts[..., i, :] for i in range(4))
    one = verts.new_ones(verts.shape[:-2])
    zero = torch.zeros_like(one)
    if verts.shape[-1] == 2:
        t = _pe_param(v0, v1, v2)
        w_pe = torch.stack([one, -(1 - t), -t, zero], dim=-1)
        w_pp = torch.stack([one, -one, zero, zero], dim=-1)
        return torch.where((ftype == PE)[..., None], w_pe, w_pp)
    w_pt = torch.cat([one[..., None], -_pt_bary(v0, v1, v2, v3)], dim=-1)
    s, t = _ee_params(v0, v1, v2, v3)
    w_ee = torch.stack([1 - s, s, -(1 - t), -t], dim=-1)
    tpe = _pe_param(v0, v1, v2)
    w_pe = torch.stack([one, -(1 - tpe), -tpe, zero], dim=-1)
    w_pp = torch.stack([one, -one, zero, zero], dim=-1)
    out = torch.where((ftype == PT)[..., None], w_pt, w_pp)
    out = torch.where((ftype == EE)[..., None], w_ee, out)
    return torch.where((ftype == PE)[..., None], w_pe, out)


def frame_normal(verts, ftype):
    """Unit vector from the second primitive's closest point toward the
    first's, n = u / ||u|| with u = sum_k w_k verts_k."""
    w = frame_contact_weights(verts, ftype)
    u = torch.sum(w[..., :, None] * verts, dim=-2)
    n = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    ok = n > _EPS
    return torch.where(ok, u / torch.where(ok, n, 1.0), torch.zeros_like(u))
