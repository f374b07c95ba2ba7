"""Port parity for the dataset front end: preprocess/labels.py,
preprocess/pipeline.py and the preprocess_dataset entry, each against the
JAX package on the same numpy-seeded inputs at 32^3 (the morphology at
20^3), with JAX's random draws injected where a step draws.

Tolerances, each where it is used:
  * morphology, the cross-dilated one-hot, fissures, lung masks, the
    left/right lung halves, z-ranges, the crops, the components and the
    lobes (the random-walk fill on the binary weights): equal;
  * lobe meshes (marching on the same smoothed indicator): equal validity,
    vertices within 1e-5 voxel;
  * process_case: the image file equal, the same file names and npz keys,
    the regularized fissures equal on at least 0.998 of the voxels (the
    Poisson fit moves by the normals' kNN ties, tests/test_torch_random_
    walk.py), the lobes on at least 0.99, and the keypoints and their
    labels equal, features within FEAT_TOL of the largest entry
    (tests/test_torch_keypoint_features.py says why 5e-4).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.data import dataset as jdataset
from fissure_segmentation_tpu.preprocess import labels as jlabels
from fissure_segmentation_tpu.preprocess import pipeline as jpipeline
from fissure_segmentation_tpu_torch import preprocess_dataset, train_point_seg
from fissure_segmentation_tpu_torch.cli import get_point_segmentation_parser
from fissure_segmentation_tpu_torch.data import dataset, synthetic
from fissure_segmentation_tpu_torch.preprocess import labels, pipeline

# the JAX package's entry, preprocess_dataset.py, lies at the root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SHAPE = (32, 32, 32)
FEAT_TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def case():
    return synthetic.make_synthetic_image_case(0, shape=SHAPE)


# ---- labels.py --------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dilate", "erode", "open", "close"])
@pytest.mark.parametrize("radius", [1, 2])
def test_binary_morphology_matches_jax_at_the_border(mode, radius):
    """Masks that touch the volume's border: both pad by replication, so
    neither erodes nor dilates from outside."""
    rng = np.random.default_rng(radius)
    m = rng.random((20, 20, 20)) < 0.55
    m[:4] = True                 # a slab on the z = 0 face
    m[:, -3:, :5] = True         # a block on two faces
    m[9, 9, 9] = False
    got = labels.binary_morphology(_t(m), radius, mode).numpy()
    want = np.asarray(jlabels.binary_morphology(jnp.asarray(m), radius, mode))
    np.testing.assert_array_equal(got, want)
    if mode == "erode":
        assert got[0, 10, 10] or not m[:radius + 1, 9:12, 9:12].all()


def test_fissures_and_lung_mask_match_jax(case):
    lobes = case["lobes"]
    got = labels.find_fissures(_t(lobes)).numpy()
    want = np.asarray(jlabels.find_fissures(jnp.asarray(lobes)))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0, 1, 2, 3}
    np.testing.assert_array_equal(
        labels._cross_dilate_one_hot(_t(lobes), 5).numpy(),
        np.asarray(jlabels._cross_dilate_one_hot(jnp.asarray(lobes), 5)))
    np.testing.assert_array_equal(
        labels.generate_lung_mask(_t(lobes)).numpy(),
        np.asarray(jlabels.generate_lung_mask(jnp.asarray(lobes))))
    # 4 lobes (no RHF): the same
    four = np.where(lobes == 5, 2, lobes)
    np.testing.assert_array_equal(
        labels.find_fissures(_t(four)).numpy(),
        np.asarray(jlabels.find_fissures(jnp.asarray(four))))


@pytest.mark.parametrize("n_lobes", [2, 3])
def test_find_fissures_with_few_lobes(case, n_lobes):
    """F13: with fewer than 4 lobes JAX's static channel index 4 clamps to
    the last channel, so its left oblique fissure covers the whole
    dilated last lobe; the port reads only channels that exist."""
    lobes = np.minimum(case["lobes"], n_lobes)
    got = labels.find_fissures(_t(lobes)).numpy()
    want = np.asarray(jlabels.find_fissures(jnp.asarray(lobes)))
    last = labels._cross_dilate_one_hot(_t(lobes), n_lobes)[n_lobes].numpy()
    assert (want[last] != 0).all() and (want[last & (want != 2)] == 1).all()
    assert not (got == 1).any()
    np.testing.assert_array_equal(got == 2, want == 2)


@pytest.mark.parametrize("sizes,want", [([], False), ([5], False),
                                        ([3, 40], False), ([40, 4], True),
                                        ([10, 1, 100], True)])
def test_left_right_plausibility_matches_jax(sizes, want):
    assert labels.check_left_right_lung_plausible(sizes) == want == \
        jlabels.check_left_right_lung_plausible(sizes)


@pytest.mark.parametrize("merged", [False, True])
def test_binary_lung_mask_to_left_right_matches_jax(case, merged):
    """The two lungs apart (components alone) and joined by a bridge (the
    opening loop, radius 3 then 5, and the distance-transform refill)."""
    mask = case["lung_mask"].copy()
    if merged:    # a 3 x 3 bridge across the 2-voxel gap between lungs
        mask[14:17, 14:17, 13:19] = True
    got = labels.binary_lung_mask_to_left_right(mask, device="cpu")
    want = jlabels.binary_lung_mask_to_left_right(mask)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0, 1, 2}
    np.testing.assert_array_equal(got > 0, mask)


@pytest.mark.parametrize("open_radius", [0, 2])
def test_find_non_zero_range_matches_jax(open_radius):
    m = np.zeros((32, 16, 16), np.int32)
    m[10:20, 2:14, 2:14] = 1
    m[2, 8, 8] = 1                         # a speck the opening removes
    got = labels.find_non_zero_range(m, axis=0, open_radius=open_radius,
                                     device="cpu")
    assert got == jlabels.find_non_zero_range(m, axis=0,
                                              open_radius=open_radius)
    assert got[0] == (2 if open_radius == 0 else 10)


def test_label_to_mesh_matches_jax(case):
    got_t, got_v = labels.label_to_mesh(case["lobes"], 4, device="cpu")
    want_t, want_v = jlabels.label_to_mesh(case["lobes"], 4)
    np.testing.assert_array_equal(got_v, np.asarray(want_v))
    assert got_v.sum() > 100 and got_t.shape == (200_000, 3, 3)
    np.testing.assert_allclose(got_t[got_v], np.asarray(want_t)[got_v],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("fill", [False, True])
def test_find_lobes_matches_jax(case, fill):
    """GT fissures + lung mask -> lobes: morphology, components and the
    anatomical relabelling; with `fill`, the random walk over the mask."""
    fis = np.asarray(jlabels.find_fissures(jnp.asarray(case["lobes"])))
    kw = dict(exclude_rhf=True, fill=fill, cg_iters=200)
    got, ok = labels.find_lobes(fis, case["lung_mask"], device="cpu",
                                stages=(stages := {}), **kw)
    want, ok_j = jlabels.find_lobes(jnp.asarray(fis),
                                    jnp.asarray(case["lung_mask"]), **kw)
    assert ok and ok_j
    np.testing.assert_array_equal(got, np.asarray(want))
    assert set(np.unique(got)) == {0, 1, 2, 3, 4}
    assert {"find_lobes:morphology", "find_lobes:components"} <= set(stages)
    assert ("find_lobes:random_walk" in stages) == fill


# ---- pipeline.py ------------------------------------------------------------

@pytest.mark.parametrize("legacy_v1", [False, True])
def test_preprocess_totalsegmentator_case_matches_jax(case, legacy_v1):
    img = case["image"] * 2500 - 1000
    img[np.unravel_index(np.argmax(case["lobes"]), SHAPE)] = 2000.0
    lobes = np.pad(case["lobes"], ((6, 30), (0, 0), (0, 0)))
    img = np.pad(img, ((6, 30), (0, 0), (0, 0)), constant_values=-1000.0)
    got = pipeline.preprocess_totalsegmentator_case(
        img, lobes, legacy_v1=legacy_v1, device="cpu")
    want = jpipeline.preprocess_totalsegmentator_case(
        img, lobes, legacy_v1=legacy_v1)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    assert (got["image"].max() > 1500) == legacy_v1


def _process_draws(img, lobes, max_kpts=20000):
    """The draws of JAX's process_case in noisy mode: compute_keypoints
    with PRNGKey(0) on the cropped case, split into the subset's uniforms
    and the jitter's normals."""
    crop = pipeline.preprocess_totalsegmentator_case(img, lobes,
                                                     device="cpu")
    n = int(np.prod(crop["image"].shape))
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    return {"scores": _t(jax.random.uniform(r1, (n,))),
            "noise": _t(jax.random.normal(r2, (max_kpts, 3)))}


@pytest.fixture(scope="module")
def processed(case, tmp_path_factory):
    """Both packages' process_case on one synthetic case in noisy mode
    with MIND-SSC features, JAX's draws injected into the port. The
    port's Poisson step runs and is recorded, but hands JAX's result on,
    so that the later steps are compared on equal inputs (the Poisson
    step moves by kNN ties: test_label_pipeline_matches_jax holds its
    share, and the noisy jitter is drawn by slot, so one voxel more or
    less would shift every later keypoint)."""
    import preprocess_dataset as jentry
    out = tmp_path_factory.mktemp("processed")
    for pkg in ("jax", "torch"):
        os.makedirs(out / pkg)
    img = case["image"] * 1000.0
    kw = dict(kp_mode="noisy", feature_mode="mind_ssc")
    rec = {}
    jpoisson, tpoisson = jpipeline.poisson_reconstruction, \
        pipeline.poisson_reconstruction

    def jrecord(*a, **k):
        rec["jax"] = jpoisson(*a, **k)
        return rec["jax"]

    def thand_on(*a, **k):
        rec["torch"] = tpoisson(*a, **k)
        lab, meshes = rec["jax"]
        return np.asarray(lab), [(np.asarray(t), np.asarray(v))
                                 for t, v in meshes]
    jpipeline.poisson_reconstruction = jrecord
    pipeline.poisson_reconstruction = thand_on
    try:
        with jax.default_matmul_precision("float32"):
            want = jentry.process_case(img, case["lobes"], (1.0, 1.0, 1.0),
                                       str(out / "jax"), "c0", **kw)
        stages = {}
        got = preprocess_dataset.process_case(
            img, case["lobes"], (1.0, 1.0, 1.0), str(out / "torch"), "c0",
            device="cpu", stages=stages,
            draws=_process_draws(img, case["lobes"]), **kw)
    finally:
        jpipeline.poisson_reconstruction = jpoisson
        pipeline.poisson_reconstruction = tpoisson
    return out, got, want, stages, rec


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_process_case_writes_what_jax_writes(processed):
    out, got, want, stages, _ = processed
    assert _files(out / "torch") == _files(out / "jax")
    assert "c0_points_fixed.npz" in _files(out / "torch")
    with np.load(out / "torch" / "c0_img_fixed.npz") as zt, \
            np.load(out / "jax" / "c0_img_fixed.npz") as zj:
        assert zt.files == zj.files
        for k in zt.files:
            assert zt[k].dtype == zj[k].dtype, k
            np.testing.assert_array_equal(zt[k], zj[k], k)
    with np.load(out / "torch" / "c0_points_fixed.npz") as zt, \
            np.load(out / "jax" / "c0_points_fixed.npz") as zj:
        assert zt.files == zj.files
        assert str(zt["__meta__"]) == str(zj["__meta__"])
    assert {"crop_gt", "mask_lr", "poisson:labelmap", "masking",
            "find_lobes:morphology", "find_lobes:components",
            "find_lobes:random_walk", "lobe_meshes", "keypoints", "features",
            "write"} | {f"poisson:label{f}" for f in (1, 2, 3)} == set(stages)


def test_label_pipeline_matches_jax(processed):
    """The four steps' artifacts: the port's own regularized fissures
    against JAX's; from JAX's, the masking, lobes, lobe meshes and the
    point case."""
    _, got, want, _, rec = processed
    reg_t, reg_j = rec["torch"][0], np.asarray(rec["jax"][0])
    assert (reg_t == reg_j).mean() >= 0.998
    assert set(np.unique(reg_t)) == {0, 1, 2, 3}
    assert got["lobes_success"] and want["lobes_success"]
    np.testing.assert_array_equal(got["fissures_regularized"],
                                  want["fissures_regularized"])
    np.testing.assert_array_equal(got["lobes"], want["lobes"])
    assert len(got["fissure_meshes"]) == 3 and len(got["lobe_meshes"]) == 4
    for (tt, vt), (tj, vj) in zip(got["lobe_meshes"], want["lobe_meshes"]):
        np.testing.assert_array_equal(vt, np.asarray(vj))
        np.testing.assert_allclose(tt[vt], np.asarray(tj)[vt], atol=1e-5)
    pt, pj = got["points"], want["points"]
    assert len(pt["coords"]) > 2048
    for key in ("coords", "labels", "lobes"):
        np.testing.assert_array_equal(pt[key], np.asarray(pj[key]), key)
    f_t, f_j = pt["features"], np.asarray(pj["features"])
    assert f_t.shape == f_j.shape == (len(pt["coords"]), 12)
    assert np.abs(f_t - f_j).max() <= FEAT_TOL * np.abs(f_j).max()


def test_create_case_meshes_matches_jax(case):
    fis = np.asarray(jlabels.find_fissures(jnp.asarray(case["lobes"])))
    kw = dict(grid_res=(32, 32, 32))
    fm_t, lm_t = pipeline.create_case_meshes(fis, case["lobes"],
                                             case["lung_mask"], device="cpu",
                                             **kw)
    with jax.default_matmul_precision("float32"):
        fm_j, lm_j = jpipeline.create_case_meshes(fis, case["lobes"],
                                                  case["lung_mask"], **kw)
    assert len(fm_t) == len(fm_j) == 3 and len(lm_t) == len(lm_j) == 5
    for (tt, vt), (tj, vj) in zip(lm_t, lm_j):
        np.testing.assert_array_equal(vt, np.asarray(vj))
        np.testing.assert_allclose(tt[vt], np.asarray(tj)[vt], atol=1e-5)
    for (tt, vt), (tj, vj) in zip(fm_t, fm_j):
        assert abs(int(vt.sum()) - int(np.asarray(vj).sum())) <= \
            0.02 * int(np.asarray(vj).sum())


# ---- the entry --------------------------------------------------------------

@pytest.fixture
def small_cases(monkeypatch):
    make = synthetic.make_synthetic_image_case
    monkeypatch.setattr(synthetic, "make_synthetic_image_case",
                        lambda seed: make(seed, shape=SHAPE))


def test_entry_writes_files_the_trainers_read(small_cases, tmp_path):
    """`main --synthetic 1` on the CPU (at 32^3 the second synthetic case
    finds too few lobes): the case's three artifacts, read back by both
    packages' point datasets and by the port's train_point_seg (--data
    fissures and --data lobes); the enhancement evaluation over the
    folder."""
    out = tmp_path / "out"
    argv = ["--synthetic", "1", "--output", str(out), "--kp_mode", "noisy",
            "--feature", "mind"]
    assert preprocess_dataset.main(argv, device="cpu") == 0
    for cid in ("synthimg0000",):
        for f in (f"{cid}_img_fixed.npz", f"{cid}_points_fixed.npz",
                  f"{cid}_mesh_fixed/{cid}_fissure1_fixed.obj",
                  f"{cid}_mesh_fixed/{cid}_lobe4_fixed.obj"):
            assert (out / f).is_file(), f
    ours = dataset.PointDataset.from_folder(str(out))
    theirs = jdataset.PointDataset.from_folder(str(out))
    assert ours.ids == theirs.ids and ours.n_features == theirs.n_features == 9
    for data in ("fissures", "lobes"):
        args = get_point_segmentation_parser().parse_args(
            ["--data_dir", str(out), "--data", data, "--pts", "256"])
        ds = train_point_seg.build_dataset(args)
        assert len(ds) == 1 and ds.n_features == 9
        assert ds.num_classes == (4 if data == "fissures" else 5)
    assert preprocess_dataset.main(["--output", str(out),
                                    "--evaluate_enhancement"],
                                   device="cpu") == 0
    with open(out / "enhancement_eval" / "enhancement_eval.csv") as f:
        rows = [r.strip().split(",") for r in f]
    assert len(rows) == 2 and np.isfinite(float(rows[1][1]))


def test_entry_needs_a_card_or_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        preprocess_dataset.main(["--synthetic", "1", "--output", str(out)])
    assert not out.exists()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        preprocess_dataset.process_case(np.zeros(SHAPE), np.ones(SHAPE),
                                        (1.0, 1.0, 1.0), str(tmp_path), "c")


def test_cnn_mode_from_an_fst(small_cases, tmp_path):
    """--kp_mode cnn with a seg-CNN written as .fst by the port's writer:
    the bfloat16 softmax's keypoints carry the 5^3 patches of every
    class."""
    from fissure_segmentation_tpu_torch.models import MobileNetASPP
    from fissure_segmentation_tpu_torch.models.io import save_fst
    fst = tmp_path / "model.fst"
    save_fst(MobileNetASPP(num_classes=4,
                           generator=torch.Generator().manual_seed(0)),
             str(fst))
    case = synthetic.make_synthetic_image_case(0)
    got = preprocess_dataset.process_case(
        case["image"] * 1000.0, case["lobes"], (1.0, 1.0, 1.0),
        str(tmp_path), "cnn0", kp_mode="cnn", cnn_model_path=str(fst),
        device="cpu", stages=(stages := {}))
    pts = got["points"]
    assert len(pts["coords"]) > 0 and pts["feature_mode"] == "cnn"
    assert pts["features"].shape == (len(pts["coords"]), 125 * 4)
    assert np.isfinite(pts["features"]).all() and "cnn" in stages
