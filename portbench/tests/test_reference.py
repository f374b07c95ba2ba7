"""The plain references against the port at tiny sizes on the CPU (the
port's plain versions stand in for its kernels there): float32 on both
sides, so they agree to float32 rounding."""
from __future__ import annotations

import copy

import numpy as np
import torch

from portbench.gen.weights import ClassBias, seeded_state, shapes_of
from portbench.loops import serve as serve_loop
from portbench.loops import train as train_loop
from portbench.reference import dgcnn, mobilenet_aspp
from portbench.reference import serving as ref_serving
from portbench.reference import surface
from portbench.reference import train as ref_train

from .conftest import small_cell

CPU = torch.device("cpu")


def test_dgcnn_eval_forward_equals_the_port():
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    cfg = small_cell("mobilenet_aspp.serve_one").config["point_model"]
    net = DGCNNSeg(k=cfg["k"], in_features=3, num_classes=4, dynamic=False)
    state = seeded_state(shapes_of(net), 5, CPU)
    net.load_state_dict(state)
    x = torch.rand((2, 96, 3), generator=torch.Generator().manual_seed(1))
    x = x * 2 - 1
    with torch.no_grad():
        got = net.eval()(x)
        want = dgcnn.forward(state, x, cfg, train=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_train_steps_equal_the_port_in_float32():
    """The port's first steps in float32 against the reference's: the
    numbers compared read at float32 rounding."""
    cell = small_cell("dgcnn_k40.train")
    cfg = dict(cell.config, compute_dtype="float32")
    trainer, state, store, weights, out_dir = train_loop.build(cfg, 11, CPU)
    names = [n for n, _ in trainer.model.named_parameters()]
    _, step = train_loop.step_calls(trainer, store, cfg, 11, CPU)
    got = train_loop.first_steps(trainer, state, 3, step)
    want = train_loop.reference_readings(cfg, cell.traffic, 11, state,
                                         store, weights, names, CPU)
    numbers = ref_train.compare(got, want, names)
    assert numbers["loss1_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["grad_gap_median"] < 1e-5


def test_batch_draw_equals_the_ports_sampler():
    from fissure_segmentation_tpu_torch.data.store import (PointCloudStore,
                                                           sample_batch)
    cfg = small_cell("dgcnn_k40.train").config
    coords, labels, valid = train_loop.make_store(3, 6, 300, CPU)
    store = PointCloudStore(coords, coords.new_zeros((6, coords.shape[1], 0)),
                            labels, valid)
    g1 = torch.Generator().manual_seed(9)
    g2 = torch.Generator().manual_seed(9)
    idx = torch.randperm(6, generator=g1)[:cfg["batch"]]
    x, y = sample_batch(store, idx, cfg["sample_points"], g1)
    xr, yr = ref_train.draw_batch(g2, (coords, labels, valid), cfg)
    torch.testing.assert_close(x, xr, rtol=1e-6, atol=1e-6)
    assert torch.equal(y, yr)


def test_cnn_softmax_equals_the_port():
    from fissure_segmentation_tpu_torch.models import (MobileNetASPP,
                                                       predict_full_volume)
    cfg = small_cell("mobilenet_aspp.serve_one").config
    cnn = MobileNetASPP(num_classes=4)
    state = seeded_state(shapes_of(cnn), 4, CPU)
    cnn.load_state_dict(state)
    vol = torch.randn((18, 21, 16), generator=torch.Generator().manual_seed(2))
    got = predict_full_volume(cnn.eval(), vol)
    with torch.no_grad():
        want = mobilenet_aspp.softmax_volume(state, vol, cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_case_answer_equals_the_port():
    """A served case's keypoints and labels, worked out by the reference
    from the same inputs and the case's generator, equal the port's."""
    from fissure_segmentation_tpu_torch.serving import segment_case
    cell = small_cell("mobilenet_aspp.serve_one")
    cfg = cell.config
    cnn, model, cnn_state, point_state, pool, bands = serve_loop.build(
        cfg, 8, CPU)
    vol, mask, _ = pool[0]
    s = cfg["serving"]
    res = segment_case(vol.numpy(), mask.numpy(), model,
                       serve_loop.case_generator(8, 0), device="cpu",
                       kp_mode="cnn", cnn_model=cnn, max_kpts=s["max_kpts"],
                       sample_points=s["sample_points"],
                       n_runs_min=s["n_runs_min"],
                       subset_batch=s["subset_batch"],
                       grid_res=tuple(s["grid_res"]))
    kp, labels = ref_serving.answer(cnn_state, point_state, vol, mask,
                                    serve_loop.case_generator(8, 0), cfg,
                                    bands)
    assert torch.equal(torch.from_numpy(res.kpts).long(), kp)
    assert torch.equal(torch.from_numpy(res.labels).long(), labels)
    assert isinstance(model, ClassBias)


def test_judge_reads_zero_for_the_reference_and_more_for_a_wrong_answer():
    cell = small_cell("mobilenet_aspp.serve_one")
    cfg = cell.config
    _, _, cnn_state, point_state, pool, bands = serve_loop.build(cfg, 8, CPU)
    vol, mask, _ = pool[0]
    kp, labels = ref_serving.answer(cnn_state, point_state, vol, mask,
                                    serve_loop.case_generator(8, 0), cfg,
                                    bands)
    soft = mobilenet_aspp.softmax_volume(cnn_state, vol, cfg)
    right = ref_serving.judge(kp, labels, vol, mask, soft,
                              serve_loop.case_generator(8, 0), cfg,
                              point_state, bands)
    assert right["kp_gap"] == 0 and right["label_gap"] == 0
    assert right["outside_mask"] == 0
    wrong = copy.deepcopy(labels)
    wrong[:] = (labels + 1) % 4
    bad = ref_serving.judge(kp, wrong, vol, mask, soft,
                            serve_loop.case_generator(8, 0), cfg,
                            point_state, bands)
    assert bad["label_gap"] > 1e-2


def test_surface_reference_agrees_with_the_port():
    """A served case's meshes and labelmap read a surface gap near 0
    against the reference's Poisson fit of its labelled keypoints, and 1
    with a class's labelmap emptied."""
    from fissure_segmentation_tpu_torch.serving import segment_case
    cell = small_cell("mobilenet_aspp.serve_one")
    cfg = cell.config
    cnn, model, _, _, pool, _ = serve_loop.build(cfg, 8, CPU)
    vol, mask, _ = pool[0]
    res = segment_case(vol.numpy(), mask.numpy(), model,
                       serve_loop.case_generator(8, 0),
                       **serve_loop.serving_kwargs(cfg, cnn, CPU))
    got = surface.judge_surfaces(res.kpts, res.labels, res.meshes,
                                 res.labelmap, cfg["serving"])
    assert got["surface_gap"] <= 0.02
    cls = int(res.labelmap.max())
    assert cls > 0
    emptied = np.where(res.labelmap == cls, 0, res.labelmap)
    bad = surface.judge_surfaces(res.kpts, res.labels, res.meshes, emptied,
                                 cfg["serving"])
    assert bad["surface_gap"] == 1.0
