"""Host-side mesh and matrix file IO in numpy (port of
mixedfem_tpu/io/mesh_io.py, its pure-Python parsers).

- .mesh: MEDIT ascii (MeshVersionFormatted / Dimension / Vertices /
  Tetrahedra / Triangles sections), 1-based indices.
- .obj: Wavefront (v / f lines; polygon faces fan-triangulated).
- .dmat: libigl dense matrix, ascii (header "ncols nrows", then the values
  column-major) or binary (header "0 0", then "ncols nrows" and doubles).
"""

from __future__ import annotations

import numpy as np


def read_mesh(path: str):
    """Read a MEDIT .mesh file -> (V (nv,3) f64, T (nt,4) i32, F (nf,3) i32)."""
    with open(path, "r") as f:
        # some .mesh files carry comment lines
        lines = [ln for ln in f if not ln.lstrip().startswith("#")]
    tokens = " ".join(lines).split()
    i = 0
    V = np.zeros((0, 3))
    T = np.zeros((0, 4), dtype=np.int32)
    F = np.zeros((0, 3), dtype=np.int32)
    n = len(tokens)
    while i < n:
        tok = tokens[i].lower()
        if tok in ("meshversionformatted", "dimension"):
            i += 2
        elif tok == "vertices":
            cnt = int(tokens[i + 1])
            i += 2
            data = np.array(tokens[i : i + 4 * cnt], dtype=np.float64)
            V = data.reshape(cnt, 4)[:, :3]
            i += 4 * cnt
        elif tok == "tetrahedra":
            cnt = int(tokens[i + 1])
            i += 2
            data = np.array(tokens[i : i + 5 * cnt], dtype=np.int64)
            T = (data.reshape(cnt, 5)[:, :4] - 1).astype(np.int32)
            i += 5 * cnt
        elif tok == "triangles":
            cnt = int(tokens[i + 1])
            i += 2
            data = np.array(tokens[i : i + 4 * cnt], dtype=np.int64)
            F = (data.reshape(cnt, 4)[:, :3] - 1).astype(np.int32)
            i += 4 * cnt
        elif tok == "edges":
            cnt = int(tokens[i + 1])
            i += 2 + 3 * cnt
        elif tok == "end":
            break
        else:
            i += 1
    return V, T, F


def write_mesh(path: str, V: np.ndarray, T: np.ndarray, F=None):
    """Write a MEDIT .mesh file (1-based indices)."""
    with open(path, "w") as f:
        f.write("MeshVersionFormatted 1\nDimension 3\nVertices\n")
        f.write(f"{len(V)}\n")
        for v in V:
            f.write(f"{v[0]} {v[1]} {v[2]} 0\n")
        if F is not None and len(F):
            f.write(f"Triangles\n{len(F)}\n")
            for t in F:
                f.write(f"{t[0]+1} {t[1]+1} {t[2]+1} 0\n")
        f.write(f"Tetrahedra\n{len(T)}\n")
        for t in T:
            f.write(f"{t[0]+1} {t[1]+1} {t[2]+1} {t[3]+1} 0\n")
        f.write("End\n")


def read_obj(path: str):
    """Read a Wavefront .obj -> (V (nv,3) f64, F (nf,3) i32). Polygon faces
    are fan-triangulated; negative indices count from the end."""
    verts = []
    faces = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for p in line.split()[1:]:
                    k = int(p.split("/")[0])
                    idx.append(k - 1 if k > 0 else len(verts) + k)
                for j in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[j], idx[j + 1]])
    return (np.asarray(verts, dtype=np.float64),
            np.asarray(faces, dtype=np.int32))


def write_obj(path: str, V: np.ndarray, F: np.ndarray):
    with open(path, "w") as f:
        for v in V:
            if len(v) == 2:
                f.write(f"v {v[0]} {v[1]} 0\n")
            else:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in F:
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")


def remove_unreferenced(V: np.ndarray, F: np.ndarray):
    """Drop vertices no face references, remapping the face indices
    (igl::remove_unreferenced)."""
    used = np.unique(F.reshape(-1))
    remap = -np.ones(len(V), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return V[used], remap[F].astype(F.dtype)


def read_dmat(path: str) -> np.ndarray:
    """Read a libigl .dmat (ascii or binary) -> (rows, cols) f64 array."""
    with open(path, "rb") as f:
        header = f.readline().split()
        ncols, nrows = int(header[0]), int(header[1])
        if ncols == 0 and nrows == 0:
            header2 = f.readline().split()
            ncols, nrows = int(header2[0]), int(header2[1])
            data = np.frombuffer(f.read(8 * nrows * ncols), dtype="<f8")
        else:
            data = np.array(f.read().split(), dtype=np.float64)
    return data.reshape(ncols, nrows).T.copy()


def write_dmat(path: str, M: np.ndarray):
    """Write an ascii libigl .dmat (column-major)."""
    M = np.atleast_2d(np.asarray(M, dtype=np.float64))
    with open(path, "w") as f:
        f.write(f"{M.shape[1]} {M.shape[0]}\n")
        for j in range(M.shape[1]):
            for i in range(M.shape[0]):
                f.write(f"{M[i, j]:.17g}\n")
