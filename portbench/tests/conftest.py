"""Small copies of the cells for the CPU: the same loops, references and
checks at sizes a test run holds (the port's plain versions stand in for
its CUDA kernels there)."""
from __future__ import annotations

import copy

import pytest
import torch

from portbench import common


def small_cell(name: str) -> common.Cell:
    """The cell `name` with its configuration cut to a CPU's size."""
    cell = copy.deepcopy(common.resolve(name))
    cfg = cell.config
    if cfg["name"] == "dgcnn_k40":
        cfg.update(store_cases=8, points_per_case=300, batch=4,
                   sample_points=64, k=8)
    else:
        cfg.update(ct_shape=[32, 32, 32], ct_pool=2)
        cfg["serving"].update(max_kpts=256, sample_points=64, n_runs_min=4,
                              subset_batch=2, grid_res=[16, 16, 16])
        cfg["point_model"].update(k=8)
        cell.traffic.update(judge_share=0.5, warm_cases=1, run_cases=4)
        if cell.traffic["mode"] == "stream":
            cell.traffic.update(chunk=2)
    return cell


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")
