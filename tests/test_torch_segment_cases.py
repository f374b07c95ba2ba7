"""The rest of serving on the CPU: the pipelined `segment_cases` against a
loop of `segment_case`, the approximate keypoint selections against the
JAX package's (exact on the CPU) where every bin holds one score, the
bf16 CNN against JAX's bf16 CNN, and the keypoint timing entry's files
against JAX's.

The volumes are 64^3 sheets in noise (tests/test_torch_serving.py's
kind) and the point model a narrow DGCNNSeg (k = 8) with a class bias
keyed on the sheet, so every case has keypoints of three classes and three
meshes.
"""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import time_keypoint_extraction as jtime
from fissure_segmentation_tpu.keypoints import extraction as jext
from fissure_segmentation_tpu.keypoints.foerstner import \
    foerstner_keypoints as jfoerstner
from fissure_segmentation_tpu.models import seg_cnn as jseg
from fissure_segmentation_tpu_torch import time_keypoint_extraction
from fissure_segmentation_tpu_torch.keypoints import extraction
from fissure_segmentation_tpu_torch.keypoints.foerstner import \
    foerstner_keypoints
from fissure_segmentation_tpu_torch.models import (DGCNNSeg, MobileNetASPP,
                                                   load_jax_variables,
                                                   predict_all_patches,
                                                   predict_full_volume)
from fissure_segmentation_tpu_torch.ops.approx_topk import \
    reduction_output_size
from fissure_segmentation_tpu_torch.serving import (case_generator,
                                                    segment_case,
                                                    segment_cases)

SHAPE = (64, 64, 64)
CFG = dict(max_kpts=2000, sample_points=128, n_runs_min=4, subset_batch=2,
           grid_res=(24, 24, 24), center_x=SHAPE[2] / 2, device="cpu")
# max_kpts at which a 64^3 volume's bins hold one score each (r = 0)
SINGLE = 8000
KEY = jax.random.PRNGKey(3)
# bf16 CNN, port against JAX: within twice JAX's own bf16 error (its bf16
# softmax against its f32 one); readings below the assertions
BF16_FACTOR = 2.0
# ... and the port's bf16 softmax at least this share of that error away
# from its own f32 one, so a CNN that ran in float32 would fail
BF16_MIN_SHARE = 0.25


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Two intra-op threads: with a thread a core, the suite's workers
    spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _volume(seed, tilt):
    rng = np.random.default_rng(seed)
    img = rng.normal(-700, 80, SHAPE).astype(np.float32)
    zz, yy, _ = np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij")
    img[np.abs(zz - (28 + tilt * yy)) < 1.0] = -300.0
    mask = np.ones(SHAPE, bool)
    mask[..., -4:] = False
    return img, mask


def _band_class(g, tilt):
    """1/2/3 by x third inside a band of 3.1 voxels around the sheet."""
    w = (g / (63 / 64) + 1) / 2 * 63
    band = torch.abs(w[..., 2] - (28 + tilt * w[..., 1])) < 3.1
    third = 1 + 1 * (w[..., 0] >= 21.5) + 1 * (w[..., 0] >= 42.5)
    return torch.where(band, third, 0)


@pytest.fixture(scope="module")
def served():
    """Three cases (two volumes, the first twice) and their loop of
    segment_case with the per-case generators of seed 5."""
    model = DGCNNSeg(k=8, in_features=3, num_classes=4, dynamic=False,
                     generator=torch.Generator().manual_seed(0)).eval()

    def apply(x):
        return model(x) + 50.0 * torch.nn.functional.one_hot(
            _band_class(x, 0.2), 4)
    vols = [_volume(0, 0.2), _volume(1, 0.2), _volume(0, 0.2)]
    loop = [segment_case(v, m, apply, case_generator(5, i), **CFG)
            for i, (v, m) in enumerate(vols)]
    return apply, vols, loop


def _assert_equal_results(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.kpts, b.kpts)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.labelmap, b.labelmap)
        for (ta, va), (tb, vb) in zip(a.meshes, b.meshes):
            np.testing.assert_array_equal(ta, tb)
            np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("threads", [True, False], ids=["threaded", "main"])
@pytest.mark.parametrize("window", [1, 2, 3])
def test_segment_cases_equals_a_loop(served, threads, window):
    """Bit for bit: keypoints, labels, every triangle and its validity,
    the labelmap; with the stage timings a case (the dispatch's stages
    within it)."""
    apply, vols, loop = served
    assert {1, 2, 3} <= set(np.unique(loop[0].labels))
    assert all(int(v.sum()) > 0 for _, v in loop[0].meshes)
    timings = []
    got = segment_cases([v for v, _ in vols], [m for _, m in vols], apply,
                        seed=5, window=window, timings=timings,
                        pipeline_threads=threads, **CFG)
    _assert_equal_results(got, loop)
    stages = {"upload_s", "keypoints_s", "ensemble_s", "surface_s",
              "copy_out_s"}
    keys = {"dispatch_s", "fetch_s", "host_s"} if threads else \
        {"dispatch_s", "finish_s"}
    assert [set(t) for t in timings] == [keys | stages] * 3
    assert all(v >= 0 for t in timings for v in t.values())
    assert all(sum(t[k] for k in stages) <= t["dispatch_s"] for t in timings)


def test_segment_cases_per_case_draws(served):
    """Given generators and subsets replace the seeded ones, case by case;
    a list of the wrong length raises."""
    apply, vols, loop = served
    gens = [case_generator(5, i) for i in range(3)]
    got = segment_cases([v for v, _ in vols], [m for _, m in vols], apply,
                        generators=gens, **CFG)
    _assert_equal_results(got, loop)
    subsets = torch.randint(0, CFG["max_kpts"], (4, CFG["sample_points"]),
                            generator=torch.Generator().manual_seed(1))
    one = segment_case(*vols[1], apply, subsets=subsets, **CFG)
    two = segment_cases([vols[1][0]], [vols[1][1]], apply, subsets=[subsets],
                        **CFG)
    _assert_equal_results(two, [one])
    with pytest.raises(ValueError, match="generators"):
        segment_cases([v for v, _ in vols], [m for _, m in vols], apply,
                      generators=gens[:2], **CFG)


# ---- approx_top_k ------------------------------------------------------------

def test_approx_foerstner_matches_jax_where_bins_are_single():
    """At max_kpts = 8000 on 64^3 every bin holds one score: the port's
    approximate detector equals JAX's approximate one (exact on the CPU) and
    its own exact one; at 2000 (r = 2) it finds at least 0.95 of the exact
    top-k, every keypoint a detection (reading 0.991: all 1626 detections
    are in the exact top-k, and a bin of 4 voxels keeps one of two)."""
    img, mask = _volume(0, 0.2)
    assert reduction_output_size(64 ** 3, 1, SINGLE, 0.95)[1] == 0
    kw = dict(sigma=0.5, d=5, thresh=1e-8)
    kj, vj, _ = jfoerstner(jnp.asarray(img), jnp.asarray(mask),
                           max_kpts=SINGLE, approx_top_k=True, **kw)
    kt, vt, _ = foerstner_keypoints(torch.from_numpy(img),
                                    torch.from_numpy(mask), max_kpts=SINGLE,
                                    approx_top_k=True, **kw)
    vj = np.asarray(vj)
    assert vj.sum() > 100
    np.testing.assert_array_equal(vt.numpy(), vj)
    np.testing.assert_array_equal(kt.numpy()[vj], np.asarray(kj)[vj])
    assert reduction_output_size(64 ** 3, 1, 2000, 0.95)[1] == 2
    ka, va, _ = foerstner_keypoints(torch.from_numpy(img),
                                    torch.from_numpy(mask), max_kpts=2000,
                                    approx_top_k=True, **kw)
    ke, ve, _ = foerstner_keypoints(torch.from_numpy(img),
                                    torch.from_numpy(mask), max_kpts=2000,
                                    **kw)
    found = {tuple(r) for r in ka[va].tolist()}
    exact = {tuple(r) for r in ke[ve].tolist()}
    assert found <= {tuple(r) for r in kt[vt].tolist()}
    assert len(found & exact) >= 0.95 * len(exact)


def test_approx_cnn_keypoints_match_jax_where_bins_are_single():
    """The cnn mode's random subset with the approximate top-k, JAX's draw
    injected: equal to JAX's (exact on the CPU) at 8000 keypoints; at 2000
    (r = 2) every keypoint is a foreground voxel and all 2000 slots are
    filled (the foreground holds far more)."""
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 1, (*SHAPE, 4)).astype(np.float32)
    logits[..., 0] += 1.0
    soft = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mask = np.ones(SHAPE, bool)
    mask[:, :8] = False
    draw = torch.from_numpy(np.array(jax.random.uniform(KEY, (64 ** 3,))))
    kj, vj, _ = jext.get_cnn_keypoints(jnp.asarray(soft), jnp.asarray(mask),
                                       max_kpts=SINGLE, rng=KEY,
                                       want_features=False,
                                       approx_top_k=True)
    kt, vt, _ = extraction.get_cnn_keypoints(
        torch.from_numpy(soft), torch.from_numpy(mask), max_kpts=SINGLE,
        scores=draw, approx_top_k=True)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    ka, va, _ = extraction.get_cnn_keypoints(
        torch.from_numpy(soft), torch.from_numpy(mask), max_kpts=2000,
        scores=draw, approx_top_k=True)
    fg = (soft.argmax(-1) != 0) & mask
    assert int(va.sum()) == 2000
    assert fg[tuple(ka.numpy().T)].all()


def test_segment_case_approx_equals_exact_where_bins_are_single(served):
    """approx_top_k reaches the detector: at 8000 keypoints (one score a
    bin) the served case equals the exact one (the surface fit capped at
    1024 points a class on both sides, which keeps the normals' kNN
    small)."""
    apply, vols, _ = served
    cfg = dict(CFG, max_kpts=SINGLE, class_cap=1024)
    a = segment_case(*vols[0], apply, case_generator(0, 0),
                     approx_top_k=True, **cfg)
    b = segment_case(*vols[0], apply, case_generator(0, 0), **cfg)
    _assert_equal_results([a], [b])


# ---- the bf16 CNN ------------------------------------------------------------

@pytest.fixture(scope="module")
def cnns():
    cm = jseg.MobileNetASPP(num_classes=4)
    cvars = jax.tree_util.tree_map(np.asarray, dict(jax.jit(
        lambda k, x: cm.init(k, x, train=False))(
            jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 16, 1)))))
    tcnn = load_jax_variables(MobileNetASPP(num_classes=4), cvars).eval()

    def capply(v, x, train=False):
        return cm.apply(v, x, train=train)
    return capply, cvars, tcnn


def _softmax_pair(fj, ft):
    """(port bf16, JAX bf16, JAX f32, port f32) softmax volumes."""
    with jax.default_matmul_precision("float32"):
        jb = np.asarray(fj(jnp.bfloat16))
        jf = np.asarray(fj(None))
    return ft(torch.bfloat16).numpy(), jb, jf, ft(None).numpy()


@pytest.mark.parametrize("protocol", ["full_volume", "all_patches"])
def test_bf16_cnn_matches_jax_bf16(cnns, protocol):
    """The bf16 CNN's softmax, whole volume and sliding window (32^3
    patches), against JAX's bf16 softmax: within BF16_FACTOR x JAX's own
    bf16 error (readings: 1.2e-4 against 1.4e-4 whole volume, 2.8e-5
    against 3.7e-5 sliding window; f32 port against f32 JAX 6e-8), argmax
    equal on at least 0.999 of the voxels (readings 0.9998, 0.9999), and
    at least BF16_MIN_SHARE x JAX's bf16 error away from the port's own
    f32 softmax, so that it ran in bf16 (readings 1.17e-4, 2.9e-5)."""
    capply, cvars, tcnn = cnns
    vol = np.random.default_rng(0).normal(0, 1, (32, 32, 48)).astype(
        np.float32)
    if protocol == "full_volume":
        vol = vol[..., :32]
        got, jb, jf, tf = _softmax_pair(
            lambda d: jseg.predict_full_volume(capply, cvars,
                                               jnp.asarray(vol), dtype=d),
            lambda d: predict_full_volume(tcnn, torch.from_numpy(vol),
                                          dtype=d))
    else:
        got, jb, jf, tf = _softmax_pair(
            lambda d: jseg.predict_all_patches(
                capply, cvars, jnp.asarray(vol), 4,
                patch_size=(32, 32, 32), dtype=d),
            lambda d: predict_all_patches(tcnn, torch.from_numpy(vol), 4,
                                          patch_size=(32, 32, 32), dtype=d))
    own = np.abs(jb - jf).max()
    assert own > 0 and got.dtype == np.float32 and got.shape == jb.shape
    assert np.abs(got - jb).max() <= BF16_FACTOR * own
    assert (got.argmax(-1) == jb.argmax(-1)).mean() >= 0.999
    assert np.abs(got - tf).max() >= BF16_MIN_SHARE * own


def test_bf16_cnn_mode_keypoints_match_jax_bf16(cnns):
    """cnn-mode keypoints from the bf16 softmax with JAX's draw injected:
    every keypoint JAX keeps from its bf16 softmax is kept but for the
    voxels whose argmax flipped between the two (reading: 0 flipped, the
    sets equal)."""
    capply, cvars, tcnn = cnns
    vol = np.random.default_rng(1).normal(0, 1, (32, 32, 32)).astype(
        np.float32)
    mask = np.ones(vol.shape, bool)
    got, jb, _, _ = _softmax_pair(
        lambda d: jseg.predict_full_volume(capply, cvars, jnp.asarray(vol),
                                           dtype=d),
        lambda d: predict_full_volume(tcnn, torch.from_numpy(vol), dtype=d))
    draw = np.array(jax.random.uniform(KEY, (vol.size,)))
    kj, vj, _ = jext.get_cnn_keypoints(jnp.asarray(jb), jnp.asarray(mask),
                                       max_kpts=3000, rng=KEY,
                                       want_features=False)
    kt, vt, _ = extraction.get_cnn_keypoints(
        torch.from_numpy(got), torch.from_numpy(mask), max_kpts=3000,
        scores=torch.from_numpy(draw))
    a = {tuple(r) for r in np.asarray(kj)[np.asarray(vj)].tolist()}
    b = {tuple(r) for r in kt[vt].tolist()}
    flipped = int(((got.argmax(-1) != 0) != (jb.argmax(-1) != 0)).sum())
    assert len(a) > 100 and len(a ^ b) <= 2 * flipped


# ---- time_keypoint_extraction ------------------------------------------------

def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_time_keypoint_extraction_writes_jax_files(tmp_path):
    """--synthetic 2 --shape 32: the port's entry writes the JAX entry's
    files with its columns (JAX run without its cnn mode, whose CNN
    compile alone takes half a minute here; the cnn file's columns are
    write_times' without points), one timed case each (the first call of a
    shape is thrown away)."""
    argv = ["--synthetic", "2", "--shape", "32"]
    assert time_keypoint_extraction.main(
        argv + ["--output", str(tmp_path / "port")], device="cpu") == 0
    jtime.main(argv + ["--output", str(tmp_path / "jax"), "--modes",
                       "foerstner", "enhancement", "mind", "ssc", "patch"])
    port = sorted(os.listdir(tmp_path / "port"))
    jax_files = sorted(os.listdir(tmp_path / "jax"))
    assert port == sorted(jax_files + ["cnn_kpts.csv"])
    for name in jax_files:
        a, b = _read(tmp_path / "port" / name), _read(tmp_path / "jax" / name)
        assert a[0] == b[0] and len(a) == len(b) == 2, name
        assert all(np.isfinite(float(v)) for v in a[1]), name
    cnn = _read(tmp_path / "port" / "cnn_kpts.csv")
    assert cnn[0] == ["Inference", "Inference_std"]
    assert float(cnn[1][1]) == 0.0          # one timed case: std 0
