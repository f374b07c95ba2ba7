"""Trainer of the voxel CNNs (counterpart of train/image_trainer.py).

CT volumes have their own shapes, so patches are cropped on the host for
each step (data/image_dataset.py:random_patch_crop), then augmented, run
forward and backward and stepped on the training device:

  * the inner train/val split and the step count as the JAX trainer's
    (numpy, seeded from `TrainConfig.seed`; steps = len(train) // batch);
  * crops from ``np.random.default_rng(seed + 1)``, in the JAX trainer's
    order, so both packages train on the same patches; validation crops
    one patch of each validation case from ``default_rng(seed + i)``;
  * the augmentation's and the dropout's draws from a `torch.Generator` on
    the device seeded ``seed + 2`` (the JAX trainer splits a key seeded
    ``seed + 2`` every step; `run(inject=...)` hands a step JAX's draws);
  * Adam with the weight decay added to the gradient (optax
    `add_decayed_weights` then `adam`: `torch.optim.Adam(weight_decay)`),
    cosine or plateau (`PlateauScheduler`) learning rates by epoch;
  * losses over the flattened voxels, (B, V, C) logits against (B, V)
    labels; epoch means of the steps' losses and components;
  * the best epoch's parameters and BatchNorm statistics (ties to the
    later epoch), `train_time.csv` and the fold's model as the JAX
    trainer's `model.fst` (models/io.py:save_fst).

The CNN trains in float32 with its checkpointed blocks (models/seg_cnn.py).
"""
from __future__ import annotations

import csv
import math
import os
import time
from typing import Callable

import numpy as np
import torch

from ..data.image_dataset import (ImageDataset, augment_image_batch,
                                  random_patch_crop)
from ..models.io import save_fst
from .trainer import PlateauScheduler, TrainConfig


class ImageTrainer:
    def __init__(self, model: torch.nn.Module, ds: ImageDataset,
                 loss_fn: Callable, out_dir: str,
                 config: TrainConfig = TrainConfig(), device=None):
        """
        :param model: MobileNetASPP or LRASPPMobileNetV33D; moved to
            `device`
        :param loss_fn: ``loss_fn(logits (B, V, C), labels (B, V)) ->
            (loss, components)``
        :param device: where to train (default: the first CUDA card; the
            CPU only when ``device="cpu"`` is passed — without a card and
            without `device` it raises)
        """
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("ImageTrainer: no CUDA card found; pass "
                               "device='cpu' to train on the CPU")
        self.device = torch.device("cuda" if device is None else device)
        self.model = model.to(self.device)
        self.ds, self.loss_fn = ds, loss_fn
        self.out_dir, self.cfg = out_dir, config
        os.makedirs(out_dir, exist_ok=True)

        rng = np.random.default_rng(config.seed)
        n_val = int(len(ds) * config.val_split)
        perm = rng.permutation(len(ds))
        self.val_indices = perm[:n_val].tolist()
        self.train_indices = perm[n_val:].tolist()
        self.steps_per_epoch = max(1, len(self.train_indices)
                                   // max(config.batch_size, 1))

        self.min_lr = config.lr * 0.05
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=config.lr,
                                          weight_decay=config.weight_decay)
        wait = math.ceil(0.05 * config.epochs)
        self.scheduler = PlateauScheduler(
            config.lr, 0.8, wait, 1e-4, wait, self.min_lr) \
            if config.scheduler == "plateau" else None
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed + 2)
        self.training_history: dict[str, list] = {}
        self.validation_history: dict[str, list] = {}
        self.best_epoch, self.best_val, self.best_snapshot = \
            0, float("inf"), None

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _loss(self, logits: torch.Tensor, lbls: torch.Tensor):
        b = logits.shape[0]
        return self.loss_fn(logits.reshape(b, -1, logits.shape[-1]),
                            lbls.reshape(b, -1))

    def train_step(self, imgs: torch.Tensor, lbls: torch.Tensor,
                   draws: dict | None = None,
                   keep: torch.Tensor | None = None):
        """One Adam step on a (B, D, H, W) patch batch on the device:
        augmentation where the dataset augments, the train-mode forward
        and backward. `draws`/`keep`: the augmentation's draws and the
        dropout's keep mask to use instead of the generator's. Returns
        (loss, components), detached device tensors."""
        self.model.train()
        if self.ds.do_augmentation:
            imgs, lbls = augment_image_batch(self.generator, imgs, lbls,
                                             draws=draws)
        logits = self.model(imgs[..., None], keep=keep,
                            generator=self.generator)
        loss, comps = self._loss(logits, lbls)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in comps.items()}

    @torch.no_grad()
    def val_step(self, imgs: torch.Tensor, lbls: torch.Tensor):
        self.model.eval()
        return self._loss(self.model(imgs[..., None]), lbls)

    def _record(self, history, values, epoch):
        for k, v in values.items():
            history.setdefault(k, [0.0] * self.cfg.epochs)
            history[k][epoch] = float(v)

    def _state(self) -> dict:
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.model.state_dict().items()}

    def run(self, initial_epoch: int = 0,
            inject: Callable[[int], dict] | None = None):
        """Train `cfg.epochs` epochs; returns the model (the best epoch's
        state). `inject(step)`: keyword arguments of `train_step` for the
        run's step `step` (the tests hand in JAX's draws)."""
        cfg = self.cfg
        rng_np = np.random.default_rng(cfg.seed + 1)
        start = time.time()
        step = 0
        for epoch in range(initial_epoch, cfg.epochs):
            t0 = time.time()
            if cfg.scheduler == "cosine":
                self._set_lr(self.min_lr + (cfg.lr - self.min_lr) * (
                    1 + math.cos(math.pi * epoch / cfg.epochs)) / 2)
            losses, comps = [], []
            order = rng_np.permutation(self.train_indices).tolist()
            for s in range(self.steps_per_epoch):
                batch_idx = [order[(s * cfg.batch_size + j) % len(order)]
                             for j in range(cfg.batch_size)]
                imgs, lbls = self.ds.crop_batch(rng_np, batch_idx,
                                                self.device)
                loss, c = self.train_step(imgs, lbls,
                                          **(inject(step) if inject else {}))
                losses.append(loss)
                comps.append(c)
                step += 1
            # one read of the epoch's losses; means over Python floats, as
            # the JAX trainer takes them
            keys = list(comps[0])
            table = torch.stack([torch.stack([l, *(c[k] for k in keys)])
                                 for l, c in zip(losses, comps)]).cpu()
            means = [float(np.mean(col.tolist())) for col in table.T]
            train_vals = {"total_loss": means[0], **dict(zip(keys, means[1:]))}
            self._record(self.training_history, train_vals, epoch)

            if self.val_indices:
                v_losses = []
                for i in self.val_indices:
                    img, lbl = random_patch_crop(
                        np.random.default_rng(cfg.seed + i),
                        self.ds.images[i], self.ds.labels[i],
                        self.ds.patch_size)
                    loss, _ = self.val_step(
                        torch.from_numpy(img[None]).to(self.device),
                        torch.from_numpy(lbl[None]).to(self.device))
                    v_losses.append(float(loss))
                val_total = float(np.mean(v_losses))
            else:
                val_total = float(train_vals["total_loss"])
            self._record(self.validation_history, {"total_loss": val_total},
                         epoch)

            if cfg.scheduler == "plateau":
                self._set_lr(self.scheduler.step(val_total))
            if val_total <= self.best_val:
                self.best_val, self.best_epoch = val_total, epoch
                self.best_snapshot = self._state()
            if epoch % cfg.show_every == 0 or epoch == cfg.epochs - 1:
                print(f"EPOCH {epoch} ({time.time() - t0:.3f}s) "
                      f"train {train_vals['total_loss']:.4f} val "
                      f"{val_total:.4f}", flush=True)
        self._finalize(time.time() - start)
        return self.model

    def _finalize(self, total_s: float) -> None:
        with open(os.path.join(self.out_dir, "train_time.csv"), "w") as f:
            w = csv.writer(f)
            w.writerow(["train time [m]"])
            w.writerow([str(total_s / 60)])
        if self.best_snapshot is not None:
            self.model.load_state_dict(self.best_snapshot)
        save_fst(self.model, os.path.join(self.out_dir, "model.fst"))
