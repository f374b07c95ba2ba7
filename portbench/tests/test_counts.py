"""The operation, byte and FLOP counts of the roofline and MFU metrics
against hand counts at one small shape."""
from __future__ import annotations

import copy
import os

import pytest
import torch

from portbench import common, peaks

from .conftest import small_cell


def _metric(name):
    return common.load_file_module(
        os.path.join(common.HERE, "metrics", name + ".py"),
        "count_" + name.replace(".", "_"))


TINY = {"k": 2, "in_features": 3, "num_classes": 4,
        "edge_widths": [[4, 4], [4], [4]], "global_width": 8,
        "head_widths": [6, 5, 4], "batch": 2, "sample_points": 5,
        "compute_dtype": "bfloat16"}


def test_dgcnn_forward_flops_by_hand():
    m = _metric("train_mfu")
    # edges 5 * 2 = 10: EdgeConv_0 6->4, 4->4; EdgeConv_1 and _2 8->4
    edge = 2 * 10 * (6 * 4 + 4 * 4 + 8 * 4 + 8 * 4)
    # points 5: global 12->8, head 20->6->5->4->4
    point = 2 * 5 * (12 * 8 + 20 * 6 + 6 * 5 + 5 * 4 + 4 * 4)
    assert m.dgcnn_forward_flops(TINY, 5) == edge + point
    assert m.step_flops(TINY) == 3 * 2 * (edge + point)
    run = common.Run(TINY, {}, window_s=2.0, steps=10)
    assert m.read(run) == pytest.approx(
        100 * 10 * 3 * 2 * (edge + point) / (2.0 * peaks.BF16_FLOPS))


def test_edgeconv_least_time_by_hand():
    m = _metric("edgeconv_roofline.train")
    got = m.least_by_kernel(TINY)
    b, n, k, c, e = 2, 5, 2, 4, 2
    hbm = peaks.HBM_BYTES_PER_S
    assert got["knn_kernel"] == (max((b * n * 3 * 4 + b * n * 3 * 4) / hbm,
                                     8 * b * n * n / peaks.F32_FLOPS), 1)
    assert got["transpose_"] == ((2 * b * n * k * 4 + b * (n + 1) * 4) / hbm,
                                 1)
    act, graph = b * n * c * e, b * n * k * 4
    assert got["gather_reduce_"] == ((2 * act + graph) / hbm, 2)
    assert got["scatter_routed_"] == ((2 * act + graph) / hbm, 2)
    assert got["count_"] == ((b * (n + 1) * 4 + b * n * 4) / hbm, 2)
    assert got["scatter_rows_kernel"] == ((b * n * k * c * e + act) / hbm, 1)
    trace = common.TraceSummary(1.0, 1.0, {"void knn_kernel<3>": 1e-3,
                                           "other": 5.0}, {})
    run = common.Run(TINY, {}, 1.0, trace_steps=4, trace=trace)
    assert m.read(run) == pytest.approx(100 * 4 * got["knn_kernel"][0]
                                        / 1e-3)


def test_k6_least_time_by_hand():
    m = _metric("k6_roofline.stream")
    cfg = {"ct_shape": [14, 16, 16],
           "blocks": [[2, 1, 1, True], [3, 2, 2, False]]}
    # padded to 16^3, the stem halves it: 8^3 = 512 voxels; stride 2: 64
    assert m.depthwise_layers(cfg) == [(512, 512, 2), (512, 64, 3)]
    want = (peaks.least_s((512 + 512) * 2 * 4 + 27 * 2 * 4,
                          2 * 27 * 512 * 2)
            + peaks.least_s((512 + 64) * 3 * 4 + 27 * 3 * 4, 2 * 27 * 64 * 3))
    assert m.case_least_s(cfg) == pytest.approx(want)


def test_cnn_flops_equal_a_count_by_hooks():
    """The CNN's FLOPs from the configuration's shapes equal a count over
    the port's MobileNetASPP's convolutions by their output shapes
    (chip_smoke.py's `_cnn_flops`), at a small volume."""
    from fissure_segmentation_tpu_torch.models import (MobileNetASPP,
                                                       predict_full_volume)
    from fissure_segmentation_tpu_torch.models.seg_cnn import (
        Conv, DepthwiseConv3)
    m = _metric("serve_mfu.stream")
    cfg = copy.deepcopy(small_cell("mobilenet_aspp.serve_one").config)
    cfg["ct_shape"] = [16, 16, 16]
    cnn = MobileNetASPP(num_classes=4)
    total = [0]

    def hook(mod, _, out):
        taps = 27 if isinstance(mod, DepthwiseConv3) else mod.weight[0].numel()
        total[0] += 2 * taps * out.numel()
    hs = [mod.register_forward_hook(hook) for mod in cnn.modules()
          if isinstance(mod, (Conv, DepthwiseConv3))]
    try:
        predict_full_volume(cnn, torch.zeros(16, 16, 16))
    finally:
        for h in hs:
            h.remove()
    assert m.cnn_flops(cfg) == total[0]


def test_case_flops_count_the_ensemble():
    m = _metric("serve_mfu.stream")
    cfg = copy.deepcopy(small_cell("mobilenet_aspp.serve_one").config)
    s = cfg["serving"]
    runs = -(-max(s["n_runs_min"], -(-s["max_kpts"] // s["sample_points"]))
             // s["subset_batch"]) * s["subset_batch"]
    pm = cfg["point_model"]
    assert m.case_flops(cfg) == m.cnn_flops(cfg) + runs * (
        _metric("train_mfu").dgcnn_forward_flops(pm, s["sample_points"]))
