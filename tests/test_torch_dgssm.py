"""Port parity for DG-SSM: the shape models, the similarity-transform
algebra, DGCNNCls / MultiHeadDGCNN / DGSSM from a JAX `init`, the DG-SSM
loss, CorrespondingPointDataset, dgssm_ensemble_predict and the
train_dgcnn_ssm entry, against the JAX package on the CPU (matmuls at
float32 precision), at 64 points, k = 6.

Tolerances:
  * the fits (numpy float64 in both, stored float32): equal arrays; the
    projection and decoding (float32 matrix products): TOL = rtol 1e-5,
    atol 1e-5; ssm.npz read and written by either package: equal arrays;
  * the transform algebra: TOL; so3_log_map near angle 0 (1e-7 .. 1e-5,
    where both take the skew vector) and near pi (the cosine clipped at
    -1 + 1e-7): TOL;
  * the models, float32, dyadic inputs (the static coordinate graph is
    exact): outputs within MODEL_TOL = 2e-4; the loss within rtol 2e-5
    and every gradient leaf within MODEL_GRAD_TOL = 2e-4 of its largest
    entry (readings up to 4e-5), on an input where both packages take the
    same LeakyReLU branches (as tests/test_torch_dpsr_net.py), its clouds
    at 4 scales (SPREAD: the heads' BatchNorms normalize over the 4
    clouds; on 4 alike clouds the batch variance is so small that float32
    rounding moved head gradients by 1 %); a Dense bias that a train-mode
    BatchNorm follows has a true gradient of 0 and is held at the whole
    gradient's scale; an inactive head's gradient is exactly 0 in both;
  * the dataset's targets and batches with JAX's draws injected, the
    ensemble with JAX's subsets injected, the loss: TOL;
  * the entry: the files the JAX entry writes (model.pt where JAX writes
    model.fst), `--test_only` reading them back to the same
    corr_point_distance.csv.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.data import augmentation as jaug
from fissure_segmentation_tpu.data import mesh_dataset as jmesh_dataset
from fissure_segmentation_tpu.data.store import build_store as jbuild_store
from fissure_segmentation_tpu.losses import dgssm as jdgssm_loss
from fissure_segmentation_tpu.models import dg_ssm as jdg_ssm
from fissure_segmentation_tpu.models import dgcnn_cls as jdgcnn_cls
from fissure_segmentation_tpu.shape_model import lssm as jlssm
from fissure_segmentation_tpu.shape_model import ssm as jssm
from fissure_segmentation_tpu_torch import train_dgcnn_ssm
from fissure_segmentation_tpu_torch.data import augmentation as aug
from fissure_segmentation_tpu_torch.data import synthetic
from fissure_segmentation_tpu_torch.data.mesh_dataset import \
    CorrespondingPointDataset
from fissure_segmentation_tpu_torch.losses import get_loss_fn
from fissure_segmentation_tpu_torch.losses.dgssm import \
    corresponding_point_distance
from fissure_segmentation_tpu_torch.models import (DGCNNCls, DGSSM,
                                                   dgssm_ensemble_predict,
                                                   export_jax_variables,
                                                   load_jax_variables)
from fissure_segmentation_tpu_torch.models.blocks import BatchNorm
from fissure_segmentation_tpu_torch.shape_model import (fit_lssm, fit_ssm,
                                                        load_ssm, save_ssm,
                                                        ssm_decode,
                                                        ssm_project,
                                                        ssm_random_samples)

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = 2e-4
MODEL_GRAD_TOL = 2e-4
HEADS = ("main", "translation", "rotation", "scaling")
# the clouds of a batch at scales 1/4 .. 1 (still dyadic), so the heads'
# train-mode BatchNorms, over 4 samples, see spread global features
SPREAD = np.asarray([0.25, 0.5, 0.75, 1.0], np.float32)[:, None, None]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_to_max(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _shapes(rng, n=10, p=30):
    base = rng.normal(size=(p, 3))
    modes = rng.normal(size=(3, p, 3))
    w = rng.normal(size=(n, 3)) * np.asarray([1.0, 0.5, 0.2])
    return (base + np.einsum("nm,mpc->npc", w, modes)
            + rng.normal(0, 0.01, (n, p, 3)))


# ---- shape models -----------------------------------------------------------

@pytest.mark.parametrize("lssm", [False, True])
def test_shape_model_matches_jax(lssm, tmp_path):
    rng = np.random.default_rng(0)
    shapes = _shapes(rng)
    if lssm:
        ours = fit_lssm(shapes, num_levels=3, target_variance=0.9)
        theirs = jlssm.fit_lssm(shapes, num_levels=3, target_variance=0.9)
    else:
        ours, theirs = fit_ssm(shapes, 3.0, 0.95), jssm.fit_ssm(shapes, 3.0,
                                                                0.95)
    for a, b in zip(ours[:3], theirs[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ours.num_modes == theirs.num_modes and ours[3:] == theirs[3:]
    x = rng.normal(size=(4, 30, 3)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        wj = np.asarray(jssm.ssm_project(theirs, jnp.asarray(x)))
        dj = np.asarray(jssm.ssm_decode(theirs, jnp.asarray(wj)))
    wt = ssm_project(ours, _t(x))
    np.testing.assert_allclose(wt.numpy(), wj, **TOL)
    np.testing.assert_allclose(ssm_decode(ours, _t(wj)).numpy(), dj, **TOL)
    u = jax.random.uniform(jax.random.PRNGKey(1), (5, ours.num_modes))
    np.testing.assert_allclose(
        ssm_random_samples(ours, 5, draws=_t(u)).numpy(),
        np.asarray(jssm.ssm_random_samples(theirs, jax.random.PRNGKey(1),
                                           5)), **TOL)
    # ssm.npz both ways
    save_ssm(ours, str(tmp_path / "port.npz"))
    jssm.save_ssm(theirs, str(tmp_path / "jax.npz"))
    for a, b in ((load_ssm(str(tmp_path / "jax.npz")),
                  jssm.load_ssm(str(tmp_path / "port.npz"))),
                 (load_ssm(str(tmp_path / "port.npz")), theirs)):
        for x_, y_ in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x_.numpy(), np.asarray(y_))
        assert a[3:] == tuple(b[3:])


# ---- transform algebra ------------------------------------------------------

def _rotations(rng):
    """Random rotations, angles near 0, and angles near pi."""
    axes = rng.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = np.concatenate([rng.uniform(0.1, 3.0, 4),
                             [1e-7, 3e-7, 1e-6, 1e-5],
                             np.pi - np.asarray([1e-3, 1e-4, 3e-4, 2e-3])])
    return (axes * angles[:, None]).astype(np.float32)


def test_so3_log_map_matches_jax():
    log_r = _rotations(np.random.default_rng(1))
    r = np.asarray(jaug.so3_exp_map(jnp.asarray(log_r)))
    np.testing.assert_allclose(aug.so3_exp_map(_t(log_r)).numpy(), r,
                               **TOL)
    np.testing.assert_allclose(aug.so3_log_map(_t(r)).numpy(),
                               np.asarray(jaug.so3_log_map(jnp.asarray(r))),
                               **TOL)


def test_transform_algebra_matches_jax():
    rng = np.random.default_rng(2)
    log_r = _rotations(rng)
    n = len(log_r)
    a = (log_r, rng.normal(size=(n, 3)).astype(np.float32),
         rng.uniform(0.5, 2, (n, 1)).astype(np.float32))
    b = (log_r[::-1].copy(), rng.normal(size=(n, 3)).astype(np.float32),
         rng.uniform(0.5, 2, (n, 1)).astype(np.float32))
    ja = jaug.compose_transform(*(jnp.asarray(v) for v in a))
    jb = jaug.compose_transform(*(jnp.asarray(v) for v in b))
    ta = aug.compose_transform(*(_t(v) for v in a))
    tb = aug.compose_transform(*(_t(v) for v in b))

    def same(got, want):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    same(aug.invert_transform(ta), jaug.invert_transform(ja))
    same(aug.chain_transforms(ta, tb), jaug.chain_transforms(ja, jb))
    same(aug.decompose_similarity_transform(aug.chain_transforms(ta, tb)),
         jaug.decompose_similarity_transform(jaug.chain_transforms(ja, jb)))
    np.testing.assert_allclose(aug.transform_matrix(ta).numpy(),
                               np.asarray(jaug.transform_matrix(ja)), **TOL)
    aniso = ja._replace(scaling=jnp.asarray(rng.uniform(
        0.5, 2, (n, 3)).astype(np.float32)))
    np.testing.assert_allclose(
        aug.transform_matrix(ta._replace(
            scaling=_t(aniso.scaling))).numpy(),
        np.asarray(jaug.transform_matrix(aniso)), **TOL)
    # inverse o transform is the identity on points
    p = _t(rng.normal(size=(n, 5, 3)).astype(np.float32))
    back = aug.transform_points(aug.transform_points(p, ta),
                                aug.invert_transform(ta))
    np.testing.assert_allclose(back.numpy(), p.numpy(), atol=1e-4)


# ---- models -----------------------------------------------------------------

def _randomize_bn(rng, variables):
    def randomize(path, leaf):
        name = jax.tree_util.keystr(path)
        if "BatchNorm" not in name:
            return leaf
        if "var" in name:
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.3, leaf.shape).astype(np.float32) + \
            (1.0 if "scale" in name else 0.0)
    return jax.tree_util.tree_map_with_path(
        randomize, jax.tree_util.tree_map(np.asarray, variables))


def _dyadic(rng, shape):
    return (rng.integers(-14, 15, shape) / 16.0).astype(np.float32)


@pytest.mark.parametrize("static", [True])
def test_dgcnn_cls_eval_matches_jax(static):
    """Eval outputs and the global feature on the static graph. The
    dynamic graph runs the PC-AE encoder's code (models/folding_net.py:
    DGCNNClsEncoder), held to JAX in tests/test_torch_pc_ae.py; here its
    feature graphs meet near-ties that float32 breaks either way."""
    rng = np.random.default_rng(3)
    jm = jdgcnn_cls.DGCNNCls(k=6, output_channels=5, static=static)
    x = _dyadic(rng, (2, 64, 3))
    variables = _randomize_bn(rng, jm.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x)))
    tm = load_jax_variables(DGCNNCls(k=6, output_channels=5, static=static),
                            variables).eval()
    with jax.default_matmul_precision("float32"):
        yj, gj = jax.jit(lambda v, x_: jm.apply(v, x_))(variables,
                                                       jnp.asarray(x))
    with torch.no_grad():
        yt, gt = tm(_t(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=MODEL_TOL,
                               atol=MODEL_TOL)


def _same_branches(apply_bn, tm, run) -> bool:
    """Whether every BatchNorm output of a train-mode forward has the same
    sign in both packages (JAX's from `apply_bn`, the port's hooked while
    `run` runs)."""
    want = {"/".join(str(p.key) for p in path[:-2]): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                apply_bn())[0]}
    got = {}
    hooks = [m.register_forward_hook(
        lambda m_, i, o, n=n: got.__setitem__(n.replace(".", "/"),
                                              o.detach().numpy()))
        for n, m in tm.named_modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        run()
    for h in hooks:
        h.remove()
    assert len(got.keys() & want.keys()) >= 10
    return all(np.array_equal(got[n] >= 0, want[n] >= 0)
               for n in got.keys() & want.keys())


def _jax_model_and_ssm(rng, **kw):
    ssm_j = jssm.fit_ssm(_shapes(rng, 12, 40) * 0.3, 3.0, 0.95)
    jm = jdg_ssm.DGSSM(k=6, in_features=3, ssm_modes=ssm_j.num_modes,
                       dynamic=False, **kw)
    variables = _randomize_bn(rng, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 3)), ssm_j, train=False))
    return jm, variables, ssm_j


def _port_ssm(ssm_j):
    from fissure_segmentation_tpu_torch.shape_model import SSMParams
    return SSMParams(*(_t(a) for a in ssm_j[:3]), *ssm_j[3:])


@pytest.mark.parametrize("heads,affine", [
    (HEADS, True), (("main", "translation"), True), (HEADS, False)])
def test_dgssm_forward_and_step_match_jax(heads, affine):
    rng = np.random.default_rng(4)
    jm, variables, ssm_j = _jax_model_and_ssm(
        rng, predict_affine_params=affine, active_heads=heads)
    ssm_t = _port_ssm(ssm_j)
    tm = load_jax_variables(DGSSM(k=6, in_features=3,
                                  ssm_modes=ssm_j.num_modes, dynamic=False,
                                  predict_affine_params=affine,
                                  active_heads=heads), variables)
    assert list(variables["params"]) == ["MultiHeadDGCNN_0"]
    import flax.linen as fnn

    def jax_bn(x):
        def f():
            _, state = jax.jit(lambda v, x_: jm.apply(
                v, x_, ssm_j, train=True,
                mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda m, _: isinstance(
                    m, fnn.BatchNorm)))(variables, jnp.asarray(x))
            return state["intermediates"]
        return f
    with jax.default_matmul_precision("float32"):
        for _ in range(10):
            x = _dyadic(rng, (4, 64, 3)) * SPREAD
            if _same_branches(jax_bn(x), tm,
                              lambda: tm.train()(_t(x), ssm_t)):
                break
        else:
            pytest.fail("no input on which both take the same branches")
    tm = load_jax_variables(tm, variables)
    t_corr = rng.normal(0, 0.3, (4, 40, 3)).astype(np.float32)
    t_params = np.concatenate([_rotations(rng)[:4] * 0.3,
                               rng.normal(0, 0.1, (4, 3)),
                               np.full((4, 3), 0.9)], -1).astype(np.float32)

    with jax.default_matmul_precision("float32"):
        ej = jax.jit(lambda v, x_: jm.apply(v, x_, ssm_j, train=False))(
            variables, jnp.asarray(x))
    with torch.no_grad():
        et = tm.eval()(_t(x), ssm_t)
    for g, w in zip(et, ej):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=MODEL_TOL,
                                   atol=MODEL_TOL)

    jloss_fn = jdgssm_loss.make_dgssm_loss()

    def jloss(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          jnp.asarray(x), ssm_j, train=True,
                          mutable=["batch_stats"])
        tw = jssm.ssm_project(ssm_j, jnp.asarray(t_corr))
        return jloss_fn(out, (jnp.asarray(t_corr), tw,
                              jnp.asarray(t_params)))[0]
    with jax.default_matmul_precision("float32"):
        lj, gj = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    for p in tm.parameters():         # an inactive head's: zeros, as JAX's
        p.grad = torch.zeros_like(p)
    out = tm.train()(_t(x), ssm_t)
    lt = get_loss_fn("ssm")(out, (_t(t_corr), ssm_project(ssm_t,
                                                          _t(t_corr)),
                                  _t(t_params)))[0]
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5)
    got = export_jax_variables(tm, grad=True)["params"]
    leaves_j = dict(jax.tree_util.tree_flatten_with_path(gj)[0])
    leaves_t = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert leaves_j.keys() == leaves_t.keys()
    whole = max(float(np.abs(np.asarray(g)).max())
                for g in leaves_j.values())
    for k, g in leaves_j.items():
        name = jax.tree_util.keystr(k)
        head = next((h for h in HEADS[1:] if f"head_{h}" in name), None)
        if head is not None and (head not in heads or not affine):
            assert not np.asarray(g).any() and not leaves_t[k].any(), name
            continue
        if "['Dense_1']['bias']" in name:
            # a bias the next train-mode BatchNorm removes: its true
            # gradient is 0, float32 noise held at the whole gradient's scale
            err = float(np.abs(leaves_t[k] - np.asarray(g)).max())
            assert err <= MODEL_GRAD_TOL * whole, (name, err, whole)
            continue
        _close_to_max(leaves_t[k], g, MODEL_GRAD_TOL, name)
    stats = export_jax_variables(tm)["batch_stats"]
    assert stats.keys() == variables["batch_stats"].keys()


def test_make_dgssm_loss_matches_jax():
    rng = np.random.default_rng(5)
    pred = (rng.normal(size=(3, 20, 3)), rng.normal(size=(3, 4)),
            rng.normal(0, 0.3, (3, 9)))
    targ = (rng.normal(size=(3, 20, 3)), rng.normal(size=(3, 4)),
            np.concatenate([rng.normal(0, 0.3, (3, 6)),
                            rng.uniform(0.8, 1.2, (3, 3))], -1))
    pred, targ = ([a.astype(np.float32) for a in p] for p in (pred, targ))
    for w in ([1.0, 0.5, 0.5], [1.0, 0.5, 0.0]):
        lj, cj = jdgssm_loss.make_dgssm_loss(*w)(
            tuple(map(jnp.asarray, pred)), tuple(map(jnp.asarray, targ)))
        lt, ct = get_loss_fn("ssm", term_weights=w)(tuple(map(_t, pred)),
                                                     tuple(map(_t, targ)))
        np.testing.assert_allclose(float(lt), float(lj), **TOL)
        assert set(ct) == set(cj)
        for k in cj:
            np.testing.assert_allclose(float(ct[k]), float(cj[k]), **TOL)
    np.testing.assert_allclose(
        corresponding_point_distance(_t(pred[0]), _t(targ[0])).numpy(),
        np.asarray(jdgssm_loss.corresponding_point_distance(
            jnp.asarray(pred[0]), jnp.asarray(targ[0]))), **TOL)


# ---- data -------------------------------------------------------------------

@pytest.fixture(scope="module")
def corr_data():
    cases = synthetic.make_synthetic_dataset(5, n_points=300,
                                             with_feature=False)
    corr, labels = train_dgcnn_ssm.synthetic_correspondences(cases, False)
    rng = np.random.default_rng(6)
    prereg = [{"rotation": np.asarray(jaug.so3_exp_map(jnp.asarray(
        rng.normal(0, 0.2, 3).astype(np.float32)))),
        "translation": rng.normal(0, 3, 3).astype(np.float32),
        "scale": float(rng.uniform(0.9, 1.1))} for _ in cases]
    return cases, corr, prereg, labels


def _corr_datasets(corr_data):
    cases, corr, prereg, labels = corr_data
    kw = dict(corr_labels=labels, sample_points=48, do_augmentation=True)
    return (CorrespondingPointDataset(cases, corr, prereg, **kw),
            jmesh_dataset.CorrespondingPointDataset(cases, corr, prereg,
                                                    **kw))


def test_corresponding_point_targets_match_jax(corr_data):
    ours, theirs = _corr_datasets(corr_data)
    assert ours.num_classes == theirs.num_classes == 3
    pts, params = ours.corr_targets()
    pj, paj = theirs.corr_targets()
    np.testing.assert_allclose(pts, pj, **TOL)
    np.testing.assert_allclose(params, paj, **TOL)
    np.testing.assert_array_equal(
        ours.get_normalized_corr_datamatrix_with_affine_reg(),
        theirs.get_normalized_corr_datamatrix_with_affine_reg())
    split = {"train": [list(ours.ids[0]), ours.ids[2][0], list(ours.ids[4])],
             "val": [list(ours.ids[1]), list(ours.ids[3])]}
    for a, b in zip(ours.split_data_set(split),
                    theirs.split_data_set(split)):
        assert a.ids == b.ids
        assert a.augment_correspondingly == b.augment_correspondingly
        np.testing.assert_allclose(a.corr_targets()[1], b.corr_targets()[1],
                                   **TOL)


@pytest.mark.parametrize("augment", [True, False])
def test_corresponding_point_batch_with_jax_draws(corr_data, augment):
    ours, theirs = _corr_datasets(corr_data)
    ours.augment_correspondingly = theirs.augment_correspondingly = augment
    pts, params = ours.corr_targets()
    idx = np.asarray([3, 0, 3, 1])
    key = jax.random.PRNGKey(8)
    jstore = jbuild_store(theirs.cases)
    xj, (cj, pj) = theirs.sample_batch(key, jstore, jnp.asarray(idx),
                                       jnp.asarray(pts), jnp.asarray(params))
    r_pts, r_aug = jax.random.split(key)
    noise = jax.random.uniform(jax.random.split(r_pts)[0],
                               (4, jstore.coords.shape[1]))
    tj = jaug.random_transform(r_aug, (4,))
    draws = {"noise": _t(noise),
             "transform": aug.SimilarityTransform(*(_t(a) for a in tj))}
    xt, (ct, pt_) = ours.sample_batch(ours.to_store(), _t(idx), _t(pts),
                                      _t(params), draws=draws)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(pt_.numpy(), np.asarray(pj), **TOL)


def test_ensemble_predict_with_jax_subsets():
    rng = np.random.default_rng(9)
    jm, variables, ssm_j = _jax_model_and_ssm(rng)
    tm = load_jax_variables(DGSSM(k=6, in_features=3,
                                  ssm_modes=ssm_j.num_modes, dynamic=False),
                            variables).eval()
    pc = _dyadic(rng, (1, 150, 3))
    key = jax.random.PRNGKey(10)
    with jax.default_matmul_precision("float32"):
        want = jdg_ssm.dgssm_ensemble_predict(
            jax.jit(jm.apply, static_argnames="train"), variables, ssm_j,
            jnp.asarray(pc), key, sample_points=64, n_runs_min=4)
    perms = np.stack([np.asarray(jax.random.permutation(r, 150))[:64]
                      for r in jax.random.split(key, 4)])
    got = dgssm_ensemble_predict(tm, _port_ssm(ssm_j), _t(pc),
                                 sample_points=64, n_runs_min=4,
                                 perms=_t(perms))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=MODEL_TOL,
                                   atol=MODEL_TOL)


# ---- the entry --------------------------------------------------------------

SMALL = ["--ds", "synthetic", "--epochs", "3", "--batch", "4", "--pts", "64",
         "--k", "8", "--fold", "0", "--static", "--scheduler", "none",
         "--predict_affine", "--head_schedule",
         '{"main": 0, "translation": 0, "rotation": 1, "scaling": 2}']
ENTRY_FILES = {"commandline_args.json", "cross_val_split.json",
               "cv_results.csv", "op_count.csv", "fold0/ssm.npz",
               "fold0/model.pt", "fold0/history.csv", "fold0/train_time.csv",
               "fold0/test/corr_point_distance.csv"}


@pytest.fixture(scope="module")
def small_cases():
    made = synthetic.make_synthetic_dataset(12, n_points=600,
                                            with_feature=False)

    def small(n, n_points, with_feature):
        import copy
        return copy.deepcopy(made)
    return small


@pytest.mark.parametrize("extra", [[], ["--lssm", "--exclude_rhf"]])
def test_entry_trains_and_tests_on_cpu(tmp_path, monkeypatch, small_cases,
                                       extra, capsys):
    monkeypatch.setattr(train_dgcnn_ssm, "make_synthetic_dataset",
                        small_cases)
    out = str(tmp_path / "run")
    assert train_dgcnn_ssm.main(SMALL + extra + ["--output", out],
                                device="cpu") == 0
    log = capsys.readouterr().out
    assert "epoch 1: active heads ('main', 'translation', 'rotation')" in log
    have = {os.path.relpath(os.path.join(d, f), out)
            for d, _, fs in os.walk(out) for f in fs}
    assert ENTRY_FILES <= have, ENTRY_FILES - have
    ssm = jssm.load_ssm(os.path.join(out, "fold0", "ssm.npz"))
    assert ssm.alpha == 3.0
    with open(os.path.join(out, "fold0", "test",
                           "corr_point_distance.csv")) as f:
        first = f.read()
    from fissure_segmentation_tpu_torch.models import load_model
    model = load_model(os.path.join(out, "fold0", "model.pt"))
    assert model.active_heads == HEADS and model.ssm_modes == ssm.num_modes
    assert train_dgcnn_ssm.main(["--output", out, "--test_only", "--fold",
                                 "0"], device="cpu") == 0
    with open(os.path.join(out, "fold0", "test",
                           "corr_point_distance.csv")) as f:
        assert f.read() == first


def test_entry_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train_dgcnn_ssm.main(SMALL + ["--output", str(tmp_path)])
