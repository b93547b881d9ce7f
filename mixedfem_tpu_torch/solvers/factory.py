"""Linear-solver names: the reference's scene vocabulary resolved to solve
paths (port of mixedfem_tpu/solvers/factory.py).

Scenes name a solver with the "linear_solver" key. Every name the JAX
package knows resolves to the same internal path name here, and the port
runs all thirteen. The ten on-device paths of optimizer/newton.py:

  pcg                condensed PCG; two-level rigid-body coarse
                     preconditioner when the caller gives a coarse space,
                     else block-Jacobi
  pcg-block-jacobi   condensed PCG, per-vertex (d, d) block-Jacobi
  pcg-diag           condensed PCG, scalar diagonal (Jacobi)
  pcg-laplacian      condensed PCG, Chebyshev (M + kL)^{-1}
                     (solvers/laplacian.py)
  pcg-dualascent     the same, wrapped in the dual-ascent contact loop
  gauss-seidel       multicolor block Gauss-Seidel sweeps as the solver
                     (solvers/gauss_seidel.py)
  minres-kkt         MINRES on the full KKT system, block-diagonal
                     preconditioner (solvers/minres.py)
  minres-kkt-admm    MINRES with ADMM sweeps as preconditioner
                     (solvers/admm.py)
  dual-cg            CG on the Schur complement onto the multipliers
                     (solvers/dual.py)
  admm               ADMM on the full KKT system

and the three host paths of optimizer/newton_direct.py, which
io/scene.py's Simulation.step routes there (newton_step refuses them with
ValueError, as in the JAX package):

  direct             exact sparse solve of the assembled condensed system
                     (scipy; solvers/direct.py)
  pcg-ic             CG with its incomplete Cholesky factor (native C++)
  amgcl              CG on the assembled dual system with smoothed-
                     aggregation AMG (solvers/amg.py)

An unknown name raises ValueError, as in the JAX package.
"""

from __future__ import annotations

INTERNAL_SOLVERS = (
    "pcg",
    "pcg-block-jacobi",
    "pcg-diag",
    "pcg-laplacian",
    "pcg-dualascent",
    "gauss-seidel",
    "direct",
    "pcg-ic",
    "amgcl",
    "minres-kkt",
    "minres-kkt-admm",
    "dual-cg",
    "admm",
)

REFERENCE_SOLVER_MAP = {
    "eigen-llt": "direct",
    "eigen-ldlt": "direct",
    "eigen-lu": "direct",
    "cholmod": "direct",
    "eigen-pcg-diag": "pcg-diag",
    "eigen-pcg-IC": "pcg-ic",
    "eigen-pcg-laplacian": "pcg-laplacian",
    "eigen-pcg-dualascent": "pcg-dualascent",
    "eigen-pcg-block_jacobi": "pcg-block-jacobi",
    "admm-solver": "admm",
    "minres-indefinite-block": "minres-kkt",
    "minres-indefinite-admm": "minres-kkt-admm",
    "subspace-CG": "dual-cg",
    "subspace-amgcl": "amgcl",
    "subspace-gauss_seidel": "gauss-seidel",
    # registered nowhere in the reference (its registration is commented
    # out) but named by one scene; the JAX package routes it to pcg
    "affine-pcg": "pcg",
}


def resolve_solver(name: str) -> str:
    """Reference or internal solver name -> one of INTERNAL_SOLVERS."""
    if name in INTERNAL_SOLVERS:
        return name
    if name in REFERENCE_SOLVER_MAP:
        return REFERENCE_SOLVER_MAP[name]
    raise ValueError(
        f"unknown linear_solver '{name}'; known: "
        f"{sorted(REFERENCE_SOLVER_MAP) + list(INTERNAL_SOLVERS)}"
    )
