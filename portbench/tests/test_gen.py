"""The generators: each is deterministic for its seed, and a CT they make
yields keypoints of all three fissure classes through the port's plain
path."""
from __future__ import annotations

import torch

from portbench.gen import ct, points, weights
from portbench.loops import serve as serve_loop

from .conftest import small_cell

CPU = torch.device("cpu")


def test_point_store_is_deterministic():
    a = points.make_store(2 ** 33 + 7, 4, 500, CPU)
    b = points.make_store(2 ** 33 + 7, 4, 500, CPU)
    c = points.make_store(2 ** 33 + 8, 4, 500, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    coords, labels, valid = a
    assert coords.shape == (4, 512, 3) and int(valid.sum()) == 4 * 500
    assert set(labels[valid].unique().tolist()) == {0, 1, 2, 3}
    assert float(coords[valid].abs().max()) < 1.0


def test_ct_is_deterministic():
    a = ct.make_ct(5, (24, 24, 24), CPU)
    b = ct.make_ct(5, (24, 24, 24), CPU)
    c = ct.make_ct(6, (24, 24, 24), CPU)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    img, mask, _ = a
    assert mask.any() and float(img[mask].mean()) < -0.3


def test_weights_are_deterministic():
    shapes = {"a.weight": (8, 4), "b.kernel": (3, 3, 3, 6),
              "c.weight": (6, 1, 3, 3, 3), "bn.scale": (6,), "bn.bias": (6,),
              "bn.mean": (6,), "bn.var": (6,), "d.bias": (3,)}
    a = weights.seeded_state(shapes, 1, CPU)
    b = weights.seeded_state(shapes, 1, CPU)
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert torch.equal(a["bn.scale"], torch.ones(6))
    assert torch.equal(a["bn.var"], torch.ones(6))
    assert not a["bn.mean"].any() and not a["d.bias"].any()
    offs = a["bn.bias"].abs()
    assert bool(((offs >= 0.05) & (offs <= 0.1)).all())


def test_a_ct_yields_all_three_fissure_classes():
    """segment_case in the cnn mode, on the CPU with the port's plain
    versions, at a reduced size: keypoints of classes 1, 2 and 3."""
    from fissure_segmentation_tpu_torch.serving import segment_case
    cfg = small_cell("mobilenet_aspp.serve_one").config
    cfg["ct_shape"] = [48, 48, 48]
    cfg["serving"].update(max_kpts=1024, sample_points=256)
    cnn, model, _, _, pool, _ = serve_loop.build(cfg, 2, CPU)
    vol, mask, _ = pool[0]
    s = cfg["serving"]
    res = segment_case(vol.numpy(), mask.numpy(), model,
                       serve_loop.case_generator(2, 0), device="cpu",
                       kp_mode="cnn", cnn_model=cnn, max_kpts=s["max_kpts"],
                       sample_points=s["sample_points"],
                       n_runs_min=s["n_runs_min"],
                       subset_batch=s["subset_batch"],
                       grid_res=tuple(s["grid_res"]))
    assert len(res.kpts) == s["max_kpts"]
    assert {1, 2, 3} <= set(res.labels.tolist())
