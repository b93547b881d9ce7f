"""The comparison that decides `correct` fails what it must: a run whose
timed path is broken underneath (the harness's look for a card skipped,
the rest of the run driven as it is) comes out not correct, and so does
the control, the plain reference put in the program's place in bfloat16;
the same reference in float64 comes out correct."""

import dataclasses

import pytest
import torch

from conftest import small_copy

from fembench import check, control, harness
from mixedfem_tpu_torch.io import scene as scenemod

SEED = 2**31 + 23
CELL = "beam-twist-800k"
_one_step = scenemod.Simulation._one_step


def unchanged(self):
    """A step that returns its state unchanged."""
    return self.state


def half_left_out(self):
    """Half of the elements left out (every other one), the rest counted
    twice: the mean taken over the rest."""
    mesh = self.mesh
    keep = (torch.arange(mesh.nelem, device=mesh.device) % 2 == 0)
    self.mesh = dataclasses.replace(mesh, vols=mesh.vols * keep * 2.0)
    try:
        return _one_step(self)
    finally:
        self.mesh = mesh


def answer_altered(self):
    """One free vertex of the answer moved by a tenth of the mesh's
    spacing where the step produces it."""
    st = _one_step(self)
    x = st.x.clone()
    i = int(torch.nonzero(self.mesh.free_mask)[0])
    x[i, 1] += 0.1 * float(self.mesh.vols.mean()) ** (1 / 3)
    return dataclasses.replace(st, x=x)


@pytest.mark.parametrize("fault", [unchanged, half_left_out, answer_altered],
                         ids=lambda f: f.__name__)
def test_a_broken_step_is_not_correct(small, monkeypatch, fault):
    cell = harness.Cell.find(small, CELL)
    monkeypatch.setattr(scenemod.Simulation, "_one_step", fault)
    out = harness.run_cell(cell, SEED, 0.0, False, device="cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("dtype,correct", [(torch.bfloat16, False),
                                           (torch.float64, True)])
def test_the_reference_in_the_programs_place(tmp_path, dtype, correct):
    root = small_copy(str(tmp_path), cells=(8, 4, 4))
    cell = harness.Cell.find(root, CELL)
    readings = control.control_readings(cell, SEED, dtype,
                                        torch.device("cpu"))
    ok, shown = check.judge([readings], cell.limits,
                            check.judge_of(root, cell.config).NUMBERS)
    assert ok == correct, shown
