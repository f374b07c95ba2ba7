"""Port parity for the whole serving slice, and the port's independence
from jax.

The slice test runs the JAX package's segment_case and the port's on the
same CT at tests/test_serving.py's size, with the same weights and the JAX
draw of ensemble subsets injected into the port (jax.random cannot be
replayed in torch). Untrained weights would put every keypoint in one class
and fit a surface to detector clutter, so — like bench.py — a coordinate
keyed logit bias is added after the full forward: keypoints in a band
around the bright sheet go to class 1/2/3 by x third, the rest to class 0.
The bias thresholds sit half a lattice step away from every keypoint, so
float rounding cannot move a keypoint across one.

Meshes are compared functionally: the PSR normals kNN sees exact lattice
distance ties, which the JAX package's XLA kNN (|x|^2 - 2x.y + |y|^2) and
the port's K1 formula break differently, so — exactly as between two JAX
compilations (tests/test_serving.py tier 2) — triangle counts and
positions agree within tolerance, not bit for bit.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.models import DGCNNSeg as JDGCNNSeg
from fissure_segmentation_tpu.models.ensemble import build_subsets
from fissure_segmentation_tpu.serving import segment_case as jsegment_case
from fissure_segmentation_tpu_torch.models import DGCNNSeg, load_jax_variables
from fissure_segmentation_tpu_torch.serving import segment_case

SHAPE = (48, 48, 48)
CFG = dict(max_kpts=2000, sample_points=128, n_runs_min=4, subset_batch=2,
           grid_res=(24, 24, 24), max_tris=24000)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case():
    rng = np.random.default_rng(0)
    img = rng.normal(-700, 80, SHAPE).astype(np.float32)
    zz, yy, _ = np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij")
    img[np.abs(zz - (20 + 0.2 * yy)) < 1.0] = -300.0
    return img, np.ones(SHAPE, bool)


def _band_class(g, lib):
    """Class of grid-coord points (..., 3) xyz: 1/2/3 by x third inside the
    band |z - (20 + 0.2 y)| < 3.1 voxels, else 0."""
    w = (g / (47 / 48) + 1) / 2 * 47                    # voxel xyz
    band = lib.abs(w[..., 2] - (20 + 0.2 * w[..., 1])) < 3.1
    third = 1 + 1 * (w[..., 0] >= 15.5) + 1 * (w[..., 0] >= 31.5)
    return lib.where(band, third, 0)


def test_segment_case_slice_matches_jax():
    img, mask = _case()
    jm = JDGCNNSeg(k=8, in_features=3, num_classes=4, dynamic=False)
    variables = jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 128, 3), jnp.float32), train=False)

    def japply(v, x, train=False):
        return jm.apply(v, x, train=train) + 50.0 * jax.nn.one_hot(
            _band_class(x, jnp), 4)

    tm = load_jax_variables(DGCNNSeg(k=8, in_features=3, num_classes=4,
                                     dynamic=False),
                            jax.tree_util.tree_map(np.asarray, variables))
    tm.eval()

    def tapply(x):
        return tm(x) + 50.0 * torch.nn.functional.one_hot(
            _band_class(x, torch), 4)

    key = jax.random.PRNGKey(7)
    with jax.default_matmul_precision("float32"):
        rj = jsegment_case(img, mask, japply, variables, key,
                           center_x=SHAPE[2] / 2, **CFG)
    subsets = np.array(build_subsets(key, CFG["max_kpts"],
                                     CFG["sample_points"], CFG["n_runs_min"]))
    rt = segment_case(img, mask, tapply, subsets=torch.from_numpy(subsets),
                      center_x=SHAPE[2] / 2, device="cpu", **CFG)

    np.testing.assert_array_equal(rt.kpts, rj.kpts)
    np.testing.assert_array_equal(rt.labels, rj.labels)
    assert set(np.unique(rj.labels)) == {0, 1, 2, 3}
    for c, ((t1, v1), (t2, v2)) in enumerate(zip(rj.meshes, rt.meshes), 1):
        n1, n2 = int(v1.sum()), int(v2.sum())
        assert n1 > 0 and abs(n1 - n2) <= max(8, 0.05 * max(n1, n2)), (c, n1, n2)
        c1, c2 = t1[v1].mean(1), t2[v2].mean(1)
        d = np.linalg.norm(c1[:, None] - c2[None], axis=-1)
        assert max(np.median(d.min(1)), np.median(d.min(0))) < 0.3, c
        a, b = rj.labelmap == c, rt.labelmap == c
        assert 2 * (a & b).sum() / (a.sum() + b.sum()) >= 0.9, c


def _port_modules():
    """Every module of the port, by dotted name."""
    root = os.path.join(REPO, "fissure_segmentation_tpu_torch")
    names = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), REPO)[:-3]
                names.append(rel.replace(os.sep, ".").replace(".__init__",
                                                               ""))
    return sorted(names)


def test_port_runs_without_jax():
    """The port imports nothing of JAX or the JAX package: a fresh
    interpreter imports every module of the port and chip_smoke (without
    running it), runs the CPU path of the whole serving slice in each
    keypoint mode, and then
    neither jax, flax nor fissure_segmentation_tpu (or any of its modules)
    is loaded. The modules include the kernel wrappers and the probe entry
    point."""
    for name in ("kernels.gather_reduce", "kernels.stream", "prof.probes",
                 "kernels.scatter", "kernels.depthwise", "metrics",
                 "train.evaluation", "utils.nifti", "utils.objio",
                 "utils.mesh_viewer", "utils.visualization",
                 "losses.chamfer", "losses.mesh", "data.mesh_dataset",
                 "models.folding_net", "models.io", "models.dseg_ae",
                 "train_pc_ae", "dseg_ae_regularization",
                 "train.canonical_cv", "models.lraspp_3d",
                 "data.image_dataset", "train.image_trainer",
                 "train_seg_cnn", "utils.image_ops", "utils.profiling",
                 "utils.detached_run", "keypoints.features",
                 "models.dpsr_net", "models.dgcnn_cls", "models.dg_ssm",
                 "losses.dpsr", "losses.dgssm", "shape_model.ssm",
                 "shape_model.lssm", "utils.device", "train_dpsr_net",
                 "train_dgcnn_ssm", "preprocess.labels",
                 "preprocess.pipeline", "postprocess.random_walk",
                 "postprocess.surface_fitting", "utils.sampling",
                 "keypoints.extraction", "keypoints.enhancement_eval",
                 "preprocess_dataset", "models.pointnet", "models.affine",
                 "affine_experiments", "ops.approx_topk",
                 "kernels.approx_topk", "time_keypoint_extraction",
                 "train.fast_variant_eval"):
        assert f"fissure_segmentation_tpu_torch.{name}" in _port_modules()
    code = textwrap.dedent(f"""
        import importlib
        import sys
        import numpy as np
        import torch
        for name in {_port_modules()!r} + ["chip_smoke"]:
            importlib.import_module(name)
        from fissure_segmentation_tpu_torch.models import DGCNNSeg
        from fissure_segmentation_tpu_torch.serving import segment_case
        rng = np.random.default_rng(0)
        img = rng.normal(-700, 80, (24, 24, 24)).astype(np.float32)
        img[10:12] = -300.0
        model = DGCNNSeg(k=4, in_features=3, num_classes=4, dynamic=False,
                         generator=torch.Generator().manual_seed(0)).eval()
        res = segment_case(img, np.ones(img.shape, bool), model,
                           torch.Generator().manual_seed(1), max_kpts=300,
                           sample_points=64, n_runs_min=3, subset_batch=2,
                           grid_res=(12, 12, 12), k_normals=8, device="cpu")
        assert len(res.kpts) > 0 and res.labelmap.shape == img.shape
        from fissure_segmentation_tpu_torch.models import MobileNetASPP
        cnn = MobileNetASPP(num_classes=4,
                            generator=torch.Generator().manual_seed(2))
        for kw in (dict(kp_mode="cnn", cnn_model=cnn),
                   dict(kp_mode="cnn", cnn_model=cnn,
                        cnn_dtype=torch.bfloat16, approx_top_k=True),
                   dict(kp_mode="enhancement")):
            res = segment_case(img, np.ones(img.shape, bool), model,
                               torch.Generator().manual_seed(1), max_kpts=300,
                               sample_points=64, n_runs_min=3, subset_batch=2,
                               grid_res=(12, 12, 12), k_normals=8,
                               device="cpu", **kw)
            assert len(res.kpts) > 0, kw
        from fissure_segmentation_tpu_torch.serving import segment_cases
        res = segment_cases([img, img], [np.ones(img.shape, bool)] * 2,
                            model, approx_top_k=True, max_kpts=300,
                            sample_points=64, n_runs_min=3, subset_batch=2,
                            grid_res=(12, 12, 12), k_normals=8, device="cpu")
        assert len(res) == 2 and len(res[1].kpts) > 0
        bad = [m for m in sys.modules
               if m in ("jax", "flax") or m.startswith(("jax.", "flax."))
               or m == "fissure_segmentation_tpu"
               or m.startswith("fissure_segmentation_tpu.")]
        assert not bad, bad
        print("OK")
        """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr
    assert len(_port_modules()) > 40
