"""The plain reference's pieces: the cofactor and the density's stretch
gradient against autograd, the mixed x-row against the gradient of the
incremental potential where s = S(F(x)), the twist composed step by step,
and the program's element rows put in the file's order through its own
element table, whatever order it keeps them in."""

import math

import numpy as np
import pytest
import torch

from fembench import check, scenes
from fembench.meshes import box_tets
from fembench.reference import fem, twist_beam


@pytest.fixture
def body():
    V, T = box_tets.box_tet_mesh(4, 3, 3, size=(4.0, 1.0, 1.0))
    g0, g1 = fem.end_slabs(V, 0.1, 0)
    return fem.Body(V, T, youngs=1e6, poisson=0.45, density=1000.0,
                    gravity=(0.0, -9.8, 0.0), h=0.02, pinned=g0 | g1), (g0, g1)


def test_cofactor_and_density_gradient(body):
    b, _ = body
    g = torch.Generator().manual_seed(0)
    A = torch.randn(8, 3, 3, generator=g, dtype=torch.float64)
    assert torch.allclose(fem.cofactor(A), torch.linalg.det(A)[:, None, None]
                          * torch.linalg.inv(A).transpose(1, 2), atol=1e-12)
    S = A + A.transpose(1, 2) + 4 * torch.eye(3, dtype=torch.float64)
    S.requires_grad_(True)
    J = fem.det3(S)
    psi = (b.mu * (1 - J) + 0.5 * b.la * (1 - J) ** 2
           + 0.5 * b.mu * ((S * S).sum((1, 2)) - 3)).sum()
    (dS,) = torch.autograd.grad(psi, S)
    assert torch.allclose(dS, b.dpsi_dS(S.detach()), rtol=1e-12, atol=1e-6)


def test_mixed_row_is_the_gradient_at_consistent_stretch(body):
    b, _ = body
    g = torch.Generator().manual_seed(1)
    x = b.V0 + 0.03 * torch.randn(b.V0.shape, generator=g, dtype=torch.float64)
    x_tilde = b.V0 + 0.01
    gv = b.gradient(x, x_tilde)
    gm = b.mixed_gradient(x, b.stretch(x), x_tilde)
    assert float((gv - gm).norm() / gv.norm()) < 1e-12
    # a stretch off S(F) moves the row
    gm2 = b.mixed_gradient(x, b.stretch(x) * 1.01, x_tilde)
    assert float((gv - gm2).norm() / gv.norm()) > 1e-3


def test_twist_composes(body):
    b, groups = body
    gm = [torch.as_tensor(m) for m in groups]
    once = b.V0
    for j in range(1, 4):
        once = fem.twist_positions(once, gm, 1, b.h, 0.1) if j else once
    thrice = fem.twist_positions(b.V0, gm, 3, b.h, 0.1)
    assert torch.allclose(once, thrice, atol=1e-13)
    a = 3 * 0.1 * math.pi * b.h
    p = b.V0[gm[0]][0] - 0.5 * (b.V0.min(0).values + b.V0.max(0).values)
    q = thrice[gm[0]][0] - 0.5 * (b.V0.min(0).values + b.V0.max(0).values)
    assert float(q[1]) == pytest.approx(math.cos(a) * p[1] - math.sin(a) * p[2])


def test_readings_follow_the_element_table(body):
    """An answer whose elements the program keeps in another order, with
    its corners rotated, reads as the answer in the file's order."""
    b, groups = body
    ref = twist_beam.Scene(b, groups, 0.1)
    g = torch.Generator().manual_seed(2)
    xs = [b.V0 + 1e-3 * torch.randn(b.V0.shape, generator=g,
                                    dtype=torch.float64) * b.free
          for _ in range(2)]
    plain = [{"x": x, "s": b.stretch(x)} for x in xs]
    rng = np.random.default_rng(0)
    order = rng.permutation(b.ne)
    T = b.T.numpy()
    T_prog = np.roll(T[order], 1, axis=1)
    perm = check.file_rows(T_prog, T)
    assert np.array_equal(perm, np.argsort(order))
    prog = [{"x": st["x"], "s": st["s"][torch.as_tensor(order)]}
            for st in plain]
    back = check.in_file_order(prog, twist_beam.KEEP, perm)
    want, got = (twist_beam.readings(ref, st) for st in (plain, back))
    for k in twist_beam.NUMBERS:
        assert got[k] == want[k]


def test_file_rows_of_the_loaders_order():
    """The loader's banded order on the card is one the comparison reads;
    a table that is not the file's elements gives no rows."""
    from mixedfem_tpu_torch.solvers.operator import sort_elements_banded

    T = scenes.permute(*box_tets.box_tet_mesh(5, 4, 3),
                       np.random.default_rng(3))[1]
    order = sort_elements_banded(T)
    assert np.array_equal(check.file_rows(T[order], T), np.argsort(order))
    bad = T[order].copy()
    bad[0, 0] = bad[1, 0] if bad[1, 0] not in bad[0] else bad[2, 0]
    assert check.file_rows(bad, T) is None
    assert check.file_rows(T[order][1:], T) is None
