"""Linear-solver names: the reference's scene vocabulary resolved to solve
paths (port of mixedfem_tpu/solvers/factory.py).

Scenes name a solver with the "linear_solver" key. Every name the JAX
package knows resolves to the same internal path name here. This port runs
two of them, both the condensed matrix-free PCG of optimizer/newton.py:

  pcg                two-level rigid-body coarse preconditioner when the
                     caller gives a coarse space, else block-Jacobi
  pcg-block-jacobi   per-vertex (d, d) block-Jacobi only

Every other known name raises NotImplementedError; an unknown name raises
ValueError, as in the JAX package.
"""

from __future__ import annotations

PORTED_SOLVERS = ("pcg", "pcg-block-jacobi")

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
    """Reference or internal solver name -> 'pcg' or 'pcg-block-jacobi'."""
    if name in INTERNAL_SOLVERS:
        path = name
    elif name in REFERENCE_SOLVER_MAP:
        path = REFERENCE_SOLVER_MAP[name]
    else:
        raise ValueError(
            f"unknown linear_solver '{name}'; known: "
            f"{sorted(REFERENCE_SOLVER_MAP) + list(INTERNAL_SOLVERS)}"
        )
    if path not in PORTED_SOLVERS:
        raise NotImplementedError(
            f"linear_solver '{name}' (path '{path}'): this port runs "
            f"{PORTED_SOLVERS}"
        )
    return path
