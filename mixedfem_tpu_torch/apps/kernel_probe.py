"""Quick card check of K1 (element_apply), K3 (contract_G_Gw) and K7
(contract_Gw) at every element shape, for a kernels.cu edit before a
whole chip_smoke.py run.

    python -m mixedfem_tpu_torch.apps.kernel_probe [--against OTHER.cu]

Builds csrc/kernels.cu (and prints ptxas's register report of each
kernel), holds every instance of K1 (tets: k=4, d=3, N=6; triangles:
k=3, d=2, N=3; shells: k=3, d=3, N=6; rods: k=2, d=3, N=6), K3's (tets
and triangles) and K7's (shells and rods) to their plain versions in float32 (1e-5 of
scale) and float64 (1e-12) at E = 1, 31, 33, 103 and 100,000 random
elements, and, with --against, compares the tet instances of K1 and K3
bit for bit with the same entry points built from another kernels.cu
(the parent commit's, say). At E = 100,000 it prints each kernel's time over 20
back-to-back launches on the same inputs: that loop is bound by the
host's enqueue, not the card (chip_smoke.py's device_ms times the
kernels). Last, two float64 steps of a 2D cantilever, card against CPU.
Exits non-zero on any disagreement and when no card is present.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile

import numpy as np
import torch


def _old_launcher(so_path):
    lib = ctypes.CDLL(so_path)
    vp, i32 = ctypes.c_void_p, ctypes.c_int

    def launch(name, sfx, *args):
        fn = getattr(lib, f"mf_{name}_{sfx}")
        fn.argtypes = [vp] * 6 + [i32, vp]
        fn.restype = i32
        if fn(*args, torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError(f"{name} of the other build failed")

    return launch


def _hot_us(fn, *args, reps=20):
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def check_kernels(other) -> bool:
    from mixedfem_tpu_torch import cuda
    from mixedfem_tpu_torch.ops import smallops
    from mixedfem_tpu_torch.solvers import operator as top

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dt):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float64).to(dt)

    ok = True
    for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        sfx = "f32" if dt == torch.float32 else "f64"
        for (k, d), shape in cuda.SHAPES.items():
            N = shape.N
            for E in (1, 31, 33, 103, 100000):
                nv = max(E, 4)
                T = torch.randint(0, nv, (E, k), generator=g, device=dev,
                                  dtype=torch.int32)
                Gw, mass = rnd((E, N, k, d), dt), rnd((E, k, k), dt)
                fm = (torch.rand(nv, generator=g, device=dev) > 0.1).to(dt)
                p = rnd((nv, d), dt)
                D, dphi, Hs = rnd((E, N, d, d), dt), rnd((E, k, d), dt), rnd((E, N, N), dt)
                vols = rnd((E,), dt).abs() + 0.1
                G7 = rnd((E, N, k, d), dt)
                outs = [cuda.element_apply(T, Gw, mass, fm, p)]
                ref = [top.element_apply_plain(T, Gw, mass, fm, p)]
                if shape.k3 is not None:
                    outs += cuda.contract_G_Gw(D, dphi, Hs, vols)
                    ref += smallops.contract_G_Gw_plain(D, dphi, Hs, vols)
                else:
                    outs.append(cuda.contract_Gw(Hs, G7, vols))
                    ref.append(smallops.contract_Gw_plain(Hs, G7, vols))
                torch.cuda.synchronize()
                errs = [((a - b).abs().max() / b.abs().max()).item()
                        for a, b in zip(outs, ref)]
                good = all(e <= tol for e in errs)
                line = (f"{sfx} k{k}d{d} E {E}: rel err K1 {errs[0]:.2e} "
                        + (f"K3 G {errs[1]:.2e} Gw {errs[2]:.2e}"
                           if shape.k3 is not None else f"K7 {errs[1]:.2e}")
                        + f" {'ok' if good else 'FAIL'}")
                y = outs[0]
                if shape.k3 is not None:
                    G, Gw2 = outs[1], outs[2]
                if other is not None and k == 4:
                    o1, o2, o3 = (torch.empty_like(t) for t in (y, G, Gw2))
                    other("element_apply", sfx, T.data_ptr(), Gw.data_ptr(),
                          mass.data_ptr(), fm.data_ptr(), p.data_ptr(),
                          o1.data_ptr(), E)
                    other("contract_G_Gw", sfx, D.data_ptr(), dphi.data_ptr(),
                          Hs.data_ptr(), vols.data_ptr(), o2.data_ptr(),
                          o3.data_ptr(), E)
                    torch.cuda.synchronize()
                    same = (torch.equal(o1, y) and torch.equal(o2, G)
                            and torch.equal(o3, Gw2))
                    good = good and same
                    line += f", bits equal to the other build: {same}"
                print(line, flush=True)
                ok = ok and good
                if E == 100000:
                    other_us = (
                        f"K3 {_hot_us(cuda.contract_G_Gw, D, dphi, Hs, vols):.2f}"
                        if shape.k3 is not None else
                        f"K7 {_hot_us(cuda.contract_Gw, Hs, G7, vols):.2f}")
                    print(f"   K1 {_hot_us(cuda.element_apply, T, Gw, mass, fm, p):.2f} us, "
                          f"{other_us} us (20 launches back to back: host enqueue)",
                          flush=True)
    return ok


def check_2d_step() -> bool:
    from mixedfem_tpu_torch import cuda
    from mixedfem_tpu_torch.config import SimConfig, enu_to_lame
    from mixedfem_tpu_torch.mesh import generators
    from mixedfem_tpu_torch.mesh import mesh as meshmod
    from mixedfem_tpu_torch.optimizer import newton
    from mixedfem_tpu_torch.solvers import coarse as coarsemod

    V, T = generators.grid_tri_mesh(40, 10, size=(4.0, 1.0))
    la, mu = enu_to_lame(1e6, 0.45)
    out = {}
    for dev in ("cuda", "cpu"):
        mesh = meshmod.build_mesh_data(
            V, T, density=np.full(len(T), 1000.0), mu=np.full(len(T), mu),
            lam=np.full(len(T), la), model_id=np.zeros(len(T), int),
            models=("Stable-Neohookean",), is_fixed=V[:, 0] < 1e-9,
            ext_force=np.tile([0.0, -9.8], (len(V), 1)), dtype=torch.float64,
            device=dev)
        cs = coarsemod.build_coarse_space(V, T, V[:, 0] < 1e-9, target_size=16,
                                          dtype=torch.float64, device=dev)
        cfg = SimConfig(h=0.02, outer_steps=3, newton_tol=0.0, itr_tol=1e-4,
                        coarse_refresh_every=1, dtype="float64")
        x0 = torch.tensor(V, dtype=torch.float64, device=dev)
        st = newton.init_state(mesh, cfg, (), x0, torch.zeros_like(x0))
        cuda.LAUNCHES.clear()
        for _ in range(2):
            st = newton.newton_step(mesh, cfg, (), st, cs)
        out[dev] = (st, dict(cuda.LAUNCHES))
    err = (out["cuda"][0].x.cpu() - out["cpu"][0].x).abs().max().item()
    cg = [out[d][0].stats.solver_iters.tolist() for d in ("cuda", "cpu")]
    print(f"2D step card vs cpu {err:.3e}, CG {cg[0]} / {cg[1]}, launches "
          f"{out['cuda'][1]}", flush=True)
    return err < 1e-12 and cg[0] == cg[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="OTHER.cu", default=None,
                    help="another kernels.cu whose tet instances to compare "
                         "bit for bit")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    from mixedfem_tpu_torch import cuda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print("built", cuda.build(), flush=True)
    nvcc = cuda._nvcc()
    with tempfile.TemporaryDirectory() as d:
        r = subprocess.run([nvcc, *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                            f"{d}/report.so", str(cuda.SOURCE)],
                           capture_output=True, text=True)
        for line in r.stderr.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(line[:200])
        other = None
        if args.against:
            subprocess.run([nvcc, *cuda.NVCC_FLAGS, "-o", f"{d}/other.so",
                            args.against], check=True)
            other = _old_launcher(f"{d}/other.so")
        ok = check_kernels(other)
    ok = check_2d_step() and ok
    print("PROBE", "OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
