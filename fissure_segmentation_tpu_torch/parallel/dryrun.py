"""`dryrun_multichip`: the parallel layer end to end over n ranks
(counterpart of the JAX package's __graft_entry__.py:dryrun_multichip, at
its sizes, with its prints; the asserts hold the port's own tolerances).

    python -m fissure_segmentation_tpu_torch.parallel.dryrun 2 \\
        [--backend gloo|nccl] [--device cuda|cpu]

The steps, each on every rank of one spawned group:
  1. one data-parallel train step of DGCNNSeg(k=8, static) on a batch of
     2n from the 4-case synthetic set, against the single-device step on
     the same batch (rank 0): the loss within 1e-5 relative, every
     gradient within 4x the model's own reduction-order spread or 2e-2 of
     its leaf's largest magnitude (a leaf whose gradient is float32 noise,
     below 1e-4 of the largest of all, is held at that level). The spread
     is the same single-device step with the batch's halves swapped: it
     moves the gradients by up to 8.5e-3 of their leaf's largest
     magnitude on the CPU (1e-3 in most leaves), where a max over k or a
     LeakyReLU takes another branch;
  2. a 10-epoch data-parallel ModelTrainer run against the single-device
     one at the same seed: the loss trajectories within the JAX check's
     rtol = atol = 3e-2;
  3. the sharded subset ensemble against `ensemble_predict` on the same
     subsets (within 1e-5);
  4. the z-slab sliding window of a small MobileNetASPP against
     `predict_all_patches` (atol 2e-5);
  5. the ring kNN edge features of a (64n, 3) cloud against the dense
     graph's (atol 1e-5);
  6./7. the sharded serving ensemble on a 64^3 synthetic CT: its
     predictions equal the fused single-device dispatch's and the
     standalone single-device ensemble's (wherever the top two
     probabilities are more than 1e-4 apart; the rest are counted), and the
     PSR/marching meshes built from them are equal for every class whose
     keypoints the two predictions agree on.

Backends: gloo with every rank on the first card (the default,
`device="cuda"`: several ranks share it), gloo on the CPU (`device="cpu"`),
or NCCL with card i for rank i (`backend="nccl"`). Without a card it
raises unless the caller asks for the CPU.
"""
from __future__ import annotations

import argparse
import copy
import tempfile

import numpy as np
import torch

from ..data.dataset import PointDataset
from ..data.synthetic import make_synthetic_dataset, make_synthetic_image_case
from ..losses import get_loss_fn
from ..models import (DGCNNSeg, MobileNetASPP, ensemble_predict,
                      predict_all_patches)
from ..ops.edge import _flat_gather
from ..ops.knn import knn
from ..train.trainer import ModelTrainer, TrainConfig
from .ensemble import sharded_ensemble_predict
from .mesh import Mesh, all_gather, shard_along, spawn
from .points import sharded_edge_features
from .spatial import sharded_predict_all_patches


def _dataset() -> PointDataset:
    return PointDataset(make_synthetic_dataset(4, n_points=512,
                                               with_feature=True),
                        sample_points=128)


def _grads(model) -> dict:
    return {n: p.grad.detach().cpu().clone()
            for n, p in model.named_parameters() if p.grad is not None}


def _dp_step(mesh: Mesh, say) -> None:
    dev, n = mesh.device, mesh.size
    ds = _dataset()
    loss_fn = get_loss_fn("nnunet", torch.as_tensor(ds.get_class_weights(),
                                                    device=dev))
    model = DGCNNSeg(k=8, in_features=4, num_classes=4, dynamic=False,
                     generator=torch.Generator().manual_seed(0))
    single = copy.deepcopy(model)
    cfg = TrainConfig(lr=1e-3, batch_size=2 * n, weight_decay=0.0,
                      scheduler="none")
    idx = torch.arange(2 * n, device=dev) % len(ds)
    with tempfile.TemporaryDirectory() as td:
        tr = ModelTrainer(model, ds, loss_fn, td, cfg, device=dev,
                          group=mesh.group)
        x, y = tr._draw(tr._generator(42), idx, True, tr._rows(2 * n))
        loss, _ = tr.train_step(x, y)
        g_dp = _grads(tr.model)
        if mesh.rank == 0:
            swapped = copy.deepcopy(single)
            tr1 = ModelTrainer(single, ds, loss_fn, td, cfg, device=dev)
            x1, y1 = tr1._draw(tr1._generator(42), idx, True, None)
            loss1, _ = tr1.train_step(x1, y1)
            np.testing.assert_allclose(float(loss), float(loss1), rtol=1e-5)
            g1s = _grads(tr1.model)
            tr2 = ModelTrainer(swapped, ds, loss_fn, td, cfg, device=dev)
            perm = torch.roll(torch.arange(2 * n, device=dev), n)
            tr2.train_step(x1[perm], y1[perm])
            g2s = _grads(tr2.model)
            top = max(float(g.abs().max()) for g in g1s.values())
            worst = 0.0
            for name, g1 in g1s.items():
                scale = max(float(g1.abs().max()), 1e-4 * top)
                err = float((g_dp[name] - g1).abs().max()) / scale
                spread = float((g2s[name] - g1).abs().max()) / scale
                worst = max(worst, err)
                assert err <= max(4 * spread, 2e-2), (name, err, spread)
            say(f"dryrun_multichip: {n}-device DP train step ok, "
                f"loss={float(loss):.4f} (single-device {float(loss1):.4f}, "
                f"largest gradient difference {worst:.2e} of the leaf's "
                "largest magnitude)")


def _trainer_parity(mesh: Mesh, say) -> None:
    dev, n = mesh.device, mesh.size
    ds = _dataset()
    loss_fn = get_loss_fn("nnunet", torch.as_tensor(ds.get_class_weights(),
                                                    device=dev))
    cfg = TrainConfig(epochs=10, lr=1e-3, batch_size=n, scheduler="cosine",
                      show_every=100, seed=0)

    def run(group):
        m = DGCNNSeg(k=8, in_features=4, num_classes=4, dynamic=False,
                     generator=torch.Generator().manual_seed(0))
        with tempfile.TemporaryDirectory() as td:
            tr = ModelTrainer(m, ds, loss_fn, td, cfg, device=dev,
                              group=group)
            tr.run()
        return np.asarray(tr.training_history["total_loss"])

    hn = run(mesh.group)
    if mesh.rank == 0:
        h1 = run(None)
        np.testing.assert_allclose(h1, hn, rtol=3e-2, atol=3e-2)
        say(f"dryrun_multichip: {cfg.epochs}-epoch DP ModelTrainer parity "
            f"ok, final loss {hn[-1]:.4f} (single-device {h1[-1]:.4f}, "
            f"largest difference {np.abs(h1 - hn).max():.2e})")


def _ensemble(mesh: Mesh, say) -> None:
    dev, n = mesh.device, mesh.size
    ds = _dataset()
    model = DGCNNSeg(k=8, in_features=4, num_classes=4, dynamic=False,
                     generator=torch.Generator().manual_seed(0)).to(dev).eval()
    pc = torch.as_tensor(np.asarray(ds.get_full_pointcloud(0)[0],
                                    np.float32), device=dev)
    kw = dict(sample_points=128, n_runs_min=n * 2, subset_batch=2)
    probs = sharded_ensemble_predict(
        model, pc, mesh, generator=torch.Generator().manual_seed(7), **kw)
    assert probs.shape == (pc.shape[0], 4)
    ref = ensemble_predict(model, pc,
                           generator=torch.Generator().manual_seed(7), **kw)
    err = float((probs - ref).abs().max())
    assert err <= 1e-5, err
    say(f"dryrun_multichip: sharded ensemble inference ok, "
        f"{tuple(probs.shape)} (largest difference to the single-device "
        f"ensemble {err:.2e})")


def _window(mesh: Mesh, say) -> None:
    dev, n = mesh.device, mesh.size
    cnn = MobileNetASPP(num_classes=3, patch_size=(8, 12, 12),
                        generator=torch.Generator().manual_seed(9))
    cnn = cnn.to(dev).eval()
    vol = torch.randn((2 * n + 3, 16, 16),
                      generator=torch.Generator().manual_seed(10)).to(dev)
    kw = dict(patch_size=(8, 12, 12), min_overlap=0.4)
    soft = sharded_predict_all_patches(cnn, vol, 3, mesh, **kw)
    assert soft.shape == (*vol.shape, 3)
    err = float((soft - predict_all_patches(cnn, vol, 3, **kw)).abs().max())
    assert err <= 2e-5, err
    say(f"dryrun_multichip: spatial halo-sharded CNN inference ok, "
        f"{tuple(soft.shape)} (largest difference to predict_all_patches "
        f"{err:.2e})")


def _ring(mesh: Mesh, say) -> None:
    dev, n = mesh.device, mesh.size
    big = torch.randn((n * 64, 3),
                      generator=torch.Generator().manual_seed(11)).to(dev)
    ef = all_gather(sharded_edge_features(shard_along(big, mesh), 8, mesh),
                    mesh)
    assert ef.shape == (n * 64, 8, 6)
    idx = knn(big[None], 8)
    xj = _flat_gather(big[None], idx)[0]
    xi = big[:, None].expand_as(xj)
    err = float((ef - torch.cat([xj - xi, xi], -1)).abs().max())
    assert err <= 1e-5, err
    say(f"dryrun_multichip: point-axis ring kNN/EdgeConv ok, "
        f"{tuple(ef.shape)}")


def _serving(mesh: Mesh, say) -> None:
    from .. import serving
    from ..postprocess.surface_fitting import batched_psr_mc
    from ..utils.coords import kpts_to_grid
    dev, n = mesh.device, mesh.size
    case = make_synthetic_image_case(0, shape=(64, 64, 64))
    vol = torch.as_tensor(case["image"], dtype=torch.float32, device=dev)
    vmask = torch.as_tensor(case["lung_mask"], device=dev).to(torch.bool)
    sm = DGCNNSeg(k=8, in_features=3, num_classes=4, dynamic=False,
                  generator=torch.Generator().manual_seed(12)).to(dev).eval()
    ens = dict(sample_points=128, n_runs_min=2 * n, subset_batch=2)
    mc = dict(grid_res=(16, 16, 16), sig=4.0, k_normals=30, max_tris=2000,
              class_cap=256)
    fused = serving._fetch_case(serving._dispatch_case(
        vol, vmask, sm, torch.Generator().manual_seed(13), device=dev,
        max_kpts=512, **ens, **mc))
    kpts, valid, shape = serving._keypoints(
        vol, vmask, None, kp_mode="foerstner", max_kpts=512, fissure_mu=0.0,
        fissure_sigma=1.0, cnn_model=None, cnn_dtype=None, kp_scores=None,
        approx_top_k=False)
    coords = torch.where(valid[:, None],
                         kpts_to_grid(kpts.flip(-1).to(torch.float32), shape),
                         -1.0)
    probs_sh = sharded_ensemble_predict(
        sm, coords, mesh, generator=torch.Generator().manual_seed(13), **ens)
    probs_1d = ensemble_predict(
        sm, coords, generator=torch.Generator().manual_seed(13), **ens)
    top2 = probs_1d.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1] > 1e-4).cpu().numpy()
    pred_sh = probs_sh.argmax(-1)
    pred_1d = probs_1d.argmax(-1)
    p_sh = pred_sh.cpu().numpy()
    np.testing.assert_array_equal(p_sh[clear], fused.out[2][clear])
    np.testing.assert_array_equal(p_sh[clear], pred_1d.cpu().numpy()[clear])
    # the meshes of every class whose keypoints the two predictions agree
    # on (every class unless a near-tie flipped)
    masks = [torch.stack([valid & (p == c) for c in (1, 2, 3)])
             for p in (pred_sh, pred_1d)]
    packed = [batched_psr_mc(coords.flip(-1), m, **mc) for m in masks]
    n_tris = int(packed[0][2].sum())
    compared = 0
    for c in range(3):
        if torch.equal(masks[0][c], masks[1][c]):
            for a, b in zip(packed[0], packed[1]):
                assert torch.equal(a[c], b[c]), f"class {c + 1} meshes differ"
            compared += 1
    say("dryrun_multichip: sharded fused-serving parity ok (ensemble over "
        f"{n} devices: predictions match the fused dispatch where the top "
        f"two are 1e-4 apart, {int((~clear).sum())} near-ties; "
        f"{n_tris} triangles, {compared} of 3 classes' meshes equal to the "
        "single-device ones, the rest with keypoints flipped at near-ties)")


def _dryrun_rank(mesh: Mesh) -> None:
    def say(*a):
        if mesh.rank == 0:
            print(*a, flush=True)
    for step in (_dp_step, _trainer_parity, _ensemble, _window, _ring,
                 _serving):
        step(mesh, say)


def dryrun_multichip(n_devices: int, backend: str = "gloo",
                     device="cuda") -> None:
    """Run the steps above on `n_devices` spawned ranks; on the card unless
    the caller passes device="cpu".

    :param backend: "gloo" or "nccl" (NCCL: card i for rank i)
    :param device: "cuda" or "cpu" for gloo (under "cuda" every rank
        computes on the first card)
    """
    on_card = backend == "nccl" or str(device).startswith("cuda")
    if on_card and torch.cuda.device_count() < (
            n_devices if backend == "nccl" else 1):
        raise RuntimeError(f"dryrun_multichip: {torch.cuda.device_count()} "
                           f"CUDA cards for {n_devices} {backend} ranks; "
                           "pass device='cpu' to run on the CPU")
    if backend == "nccl":
        devices = [f"cuda:{i}" for i in range(n_devices)]
    else:
        devices = "cuda:0" if on_card else str(device)
    if on_card:
        from ..kernels import _build
        _build.build()      # once, here, not in every rank at once
    spawn(_dryrun_rank, n_devices, backend, devices, timeout_s=600.0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int)
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    dryrun_multichip(a.n, a.backend, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
