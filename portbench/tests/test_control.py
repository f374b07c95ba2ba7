"""The control and the faults come out as not correct.

On the CPU at a small size: the training cell's control (the reference in
scaled float8) fails one of the numbers compared while the program
passes; a run with the timed path broken underneath (a step that leaves
the state unchanged; half of the batch left out, the loss its mean over
the rest; one answer's label altered where it is produced; the meshes
and labelmap shifted by two cells of the surface grid) reads
`correct` false. TF32 exists only on a card, so the serving cells'
controls (the whole reference, and its point model alone in the
program's place) run there (`cuda` marker)."""
from __future__ import annotations

import pytest
import torch

from portbench import control
from portbench.loops import serve as serve_loop
from portbench.loops import train as train_loop
from portbench.run import execute

from .conftest import small_cell

CPU = torch.device("cpu")


def _fails(numbers: dict, limits: dict) -> bool:
    return any(not numbers[k] <= v for k, v in limits.items())


def test_training_control_fails_and_program_passes():
    out = control.readings(small_cell("dgcnn_k40.train"), 77, CPU, False)
    assert not _fails(out["program"], train_loop.LIMITS)
    assert _fails(out["reference_float8"], train_loop.LIMITS)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_run_with_a_fault_is_not_correct(fault):
    with control.planted(fault):
        result, _, _ = execute(small_cell("dgcnn_k40.train"), 77, 0.5,
                               False, CPU)
    assert result["correct"] is False


@pytest.mark.parametrize("fault", ["altered_answer", "surface_shifted"])
@pytest.mark.parametrize("workload", ["mobilenet_aspp.serve_one",
                                      "mobilenet_aspp.serve_stream"])
def test_serving_run_with_an_altered_answer_is_not_correct(workload, fault):
    cell = small_cell(workload)
    cell.traffic["judge_share"] = 1.0      # judge every case in full
    clean, _, _ = execute(cell, 5, 0.5, False, CPU)
    assert clean["correct"] is True
    with control.planted(fault):
        result, _, _ = execute(cell, 5, 0.5, False, CPU)
    assert result["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mobilenet_aspp.serve_one",
                                      "mobilenet_aspp.serve_stream"])
def test_serving_control_fails_on_the_card(card, workload):
    """The reference with TF32 on in the program's place, at a reduced
    CT: its answers read above the limit while the program's do not."""
    cell = small_cell(workload)
    cell.config["ct_shape"] = [128, 128, 128]
    cell.config["serving"].update(max_kpts=8192, sample_points=2048,
                                  n_runs_min=10, subset_batch=5)
    cell.traffic.update(run_cases=16, judge_share=0.1)
    out = control.readings(cell, 2 ** 31 + 3, card, False)
    assert out["program"]["correct"]
    assert not _fails(out["program"], serve_loop.LIMITS)
    assert _fails(out["control_tf32"], serve_loop.LIMITS)
    assert not out["ensemble_tf32"]["correct"]
