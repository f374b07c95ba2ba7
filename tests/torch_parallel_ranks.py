"""Rank functions of the parallel tests (tests/test_torch_parallel*.py).

The ranks are spawned interpreters that import this module by name; it
imports no JAX (the tests' conftest, which points JAX at the CPU, does not
run in them), so everything JAX computes comes in as numpy arrays.
"""
import os
import tempfile

import numpy as np
import torch

from fissure_segmentation_tpu_torch.data import dataset, synthetic
from fissure_segmentation_tpu_torch.losses import get_loss_fn
from fissure_segmentation_tpu_torch.models import (DGCNNSeg, MobileNetASPP,
                                                   ensemble_predict,
                                                   export_jax_variables,
                                                   load_jax_variables)
from fissure_segmentation_tpu_torch.models.blocks import \
    convert_sync_batchnorm
from fissure_segmentation_tpu_torch.ops.collectives import all_reduce_
from fissure_segmentation_tpu_torch.parallel import (
    halo_exchange, halo_exchange_down, halo_reduce, halo_reduce_down,
    ppermute, replicate, shard_along, sharded_edge_features,
    sharded_ensemble_predict,
    sharded_gather_neighbors, sharded_knn, sharded_predict_all_patches)
from fissure_segmentation_tpu_torch.train.trainer import (ModelTrainer,
                                                          TrainConfig)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def modules_rank(mesh, inp):
    """Every function of parallel/ on the inputs `inp` (global arrays;
    each rank takes its share). Returns this rank's outputs."""
    out = {}
    slab = shard_along(_t(inp["x"]), mesh)
    out["halo_exchange"] = _np(halo_exchange(slab, inp["halo"], mesh))
    out["halo_reduce"] = _np(halo_reduce(shard_along(_t(inp["y_ext"]), mesh),
                                         inp["halo"], mesh))
    out["halo_exchange_down"] = _np(halo_exchange_down(slab, inp["hops"],
                                                       mesh))
    out["halo_reduce_down"] = _np(halo_reduce_down(
        shard_along(_t(inp["y_down"]), mesh), inp["hops"], slab.shape[0],
        mesh))
    out["ppermute_partial"] = _np(ppermute(slab, mesh, [(0, 1)]))
    out["replicate"] = _np(replicate(slab, mesh))
    pts = shard_along(_t(inp["pts"]), mesh)
    for self_loop in (False, True):
        idx, d = sharded_knn(pts, inp["k"], mesh, self_loop=self_loop,
                             return_dist=True)
        out[f"knn_{self_loop}"] = (_np(idx), _np(d))
    out["gather"] = _np(sharded_gather_neighbors(
        shard_along(_t(inp["feats"]), mesh),
        shard_along(_t(inp["gather_idx"]), mesh), mesh))
    out["edge"] = _np(sharded_edge_features(pts, inp["k"], mesh))

    cnn = load_jax_variables(MobileNetASPP(num_classes=3,
                                           patch_size=(8, 12, 12)),
                             inp["cnn_vars"]).eval()
    out["window"] = _np(sharded_predict_all_patches(
        cnn, _t(inp["img"]), 3, mesh, patch_size=(8, 12, 12),
        min_overlap=0.4))

    seg = load_jax_variables(DGCNNSeg(k=6, in_features=4, num_classes=4,
                                      dynamic=False), inp["seg_vars"]).eval()
    kw = dict(sample_points=inp["sample_points"],
              subset_batch=inp["subset_batch"], subsets=_t(inp["subsets"]))
    out["ensemble"] = _np(sharded_ensemble_predict(seg, _t(inp["pc"]), mesh,
                                                   **kw))
    if mesh.rank == 0:
        out["ensemble_single"] = _np(ensemble_predict(seg, _t(inp["pc"]),
                                                      **kw))
    return out


def _tiny_dataset(n_cases=4):
    return dataset.PointDataset(
        synthetic.make_synthetic_dataset(n_cases, n_points=300),
        sample_points=64)


def _grad_tree(model):
    return export_jax_variables(model, grad=True)["params"]


def dp_step_rank(mesh, inp):
    """One data-parallel ModelTrainer step of DGCNNSeg(k=6, static) from
    the JAX weights on this rank's rows of the injected batch, with the
    fused EdgeConv off and on (FSEG_FUSED_EDGE); then the same batch as a
    plain-DDP port would take it (per-rank loss and BatchNorm, the mean of
    the ranks' losses and gradients); then a data-parallel trainer run."""
    out = {}
    rows = slice(mesh.rank * inp["share"], (mesh.rank + 1) * inp["share"])
    x, y = _t(inp["x"])[rows], _t(inp["y"])[rows].long()
    cw = _t(inp["cw"])
    for fused in (False, True):
        os.environ["FSEG_FUSED_EDGE"] = "1" if fused else "0"
        model = load_jax_variables(DGCNNSeg(k=6, in_features=4,
                                            num_classes=4, dynamic=False),
                                   inp["vars"])
        with tempfile.TemporaryDirectory() as td:
            tr = ModelTrainer(model, _tiny_dataset(),
                              get_loss_fn("nnunet", cw), td,
                              TrainConfig(lr=inp["lr"],
                                          weight_decay=inp["wd"],
                                          batch_size=inp["share"]
                                          * mesh.size),
                              device="cpu", group=mesh.group)
            loss, comps = tr.train_step(x, y)
        out[f"step_{fused}"] = dict(
            loss=float(loss), comps={k: float(v) for k, v in comps.items()},
            grads=_grad_tree(model), variables=export_jax_variables(model))
    os.environ.pop("FSEG_FUSED_EDGE")

    # the unbalanced batch: the global loss, and the plain-DDP one
    xu, yu = _t(inp["xu"])[rows], _t(inp["yu"])[rows].long()
    for name, group in (("global", mesh.group), ("ddp", None)):
        model = load_jax_variables(DGCNNSeg(k=6, in_features=4,
                                            num_classes=4, dynamic=False),
                                   inp["vars"]).train()
        convert_sync_batchnorm(model, group)
        kw = {} if group is None else {"group": group}
        loss, _ = get_loss_fn("nnunet", cw)(model(xu), yu, **kw)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        for g in grads:
            all_reduce_(g, mesh.group)
        if group is None:
            loss = all_reduce_(loss.detach().clone(), mesh.group) / mesh.size
            for g in grads:
                g /= mesh.size
        out[name] = dict(loss=float(loss), grads=_grad_tree(model))

    # a few epochs of the data-parallel trainer
    with tempfile.TemporaryDirectory() as td:
        tr = ModelTrainer(DGCNNSeg(k=6, in_features=4, num_classes=4,
                                   dynamic=False,
                                   generator=torch.Generator().manual_seed(3)),
                          _tiny_dataset(10), get_loss_fn("nnunet", cw), td,
                          TrainConfig(**inp["train_cfg"]), device="cpu",
                          group=mesh.group)
        tr.run()
        out["history"] = (tr.training_history, tr.validation_history)
        out["files"] = sorted(os.listdir(td))
    return out


def single_trainer_history(inp):
    """The same run as dp_step_rank's last one, on one device."""
    cw = _t(inp["cw"])
    with tempfile.TemporaryDirectory() as td:
        tr = ModelTrainer(DGCNNSeg(k=6, in_features=4, num_classes=4,
                                   dynamic=False,
                                   generator=torch.Generator().manual_seed(3)),
                          _tiny_dataset(10), get_loss_fn("nnunet", cw), td,
                          TrainConfig(**inp["train_cfg"]), device="cpu")
        tr.run()
        return (tr.training_history, tr.validation_history), \
            sorted(os.listdir(td))
