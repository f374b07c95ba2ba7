"""Training loop (counterpart of train/trainer.py:56-462): Adam with L2
weight decay, cosine/plateau/none schedulers, loss-component history, the
best model by validation loss, checkpoint and resume.

  * inner 80/20 train/val split of the fold's training set (numpy, seeded
    from `TrainConfig.seed`, the same split as the JAX trainer), drop_last
    iff len(train) // 2 >= batch_size;
  * `torch.optim.Adam(weight_decay=wd)` adds wd * p to the gradient before
    Adam — optax `add_decayed_weights` followed by `adam`;
  * the plateau scheduler is a plain-Python ReduceLROnPlateau (factor 0.8,
    patience and cooldown ceil(0.05 * epochs), rel. threshold 1e-4, min_lr
    0.05 lr) stepped on the validation loss; cosine is closed form;
  * an epoch is a Python loop over steps on the training device; losses
    stay on the device and are read once per epoch;
  * history = per-epoch means over the steps (every step has the same batch
    size); the best snapshot (ties -> later epoch) is written as `model.pt`
    (models/weights.py:save_model) with train_time.csv and history.csv.

Family hooks (the JAX trainer's, train/trainer.py:21-30, 104-130):
  * `batch_fn(generator, case_idx, train)` draws batches otherwise;
  * `forward_fn(model, x, train)` applies the model otherwise (DG-SSM
    passes its fitted SSM);
  * `epoch_in_loss`: the loss takes the epoch, ``loss_fn(out, y,
    epoch=epoch)`` (DPSR-Net's Chamfer switch);
  * `init_input`: one eval-mode forward on that input before training
    (the JAX trainer initializes its variables from it; the port's are
    made at construction, so this only checks that the model runs on it);
  * `epoch_callback(trainer, epoch)` before each epoch may change the
    model in place (DG-SSM's head schedule sets `active_heads`); it
    returns whether it did, where the JAX trainer then recompiles its
    epoch and the port has nothing to rebuild.

Random streams: the data order comes from numpy (seed + 1, as in the JAX
trainer, so both packages train on the same case order); batch sampling and
augmentation from a device `torch.Generator` reseeded every epoch from a
numpy stream (seed + 2), the counterpart of the JAX trainer's per-epoch key
split. Resuming replays both streams, so a resumed run continues with the
draws the uninterrupted run would have made.
"""
from __future__ import annotations

import copy
import csv
import dataclasses
import math
import os
import time
from typing import Callable

import numpy as np
import torch

from ..data.store import sample_batch
from ..models.weights import save_model


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 1000
    lr: float = 1e-3
    batch_size: int = 32
    weight_decay: float = 1e-5
    scheduler: str = "plateau"  # cosine | plateau | none
    val_split: float = 0.2
    seed: int = 0
    show_every: int = 50  # print frequency (epochs)
    checkpoint_every: int | None = None  # epochs between checkpoints


class PlateauScheduler:
    """torch.optim.lr_scheduler.ReduceLROnPlateau, mode=min, rel threshold
    (train/trainer.py:69-100)."""

    def __init__(self, lr, factor, patience, threshold, cooldown, min_lr):
        self.lr, self.factor, self.patience = lr, factor, patience
        self.threshold, self.cooldown, self.min_lr = threshold, cooldown, min_lr
        self.best = float("inf")
        self.num_bad = 0
        self.cooldown_counter = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.lr

    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, d):
        self.__dict__.update(d)


class ModelTrainer:
    def __init__(self, model: torch.nn.Module, ds, loss_fn: Callable,
                 out_dir: str, config: TrainConfig = TrainConfig(),
                 device=None, batch_fn: Callable | None = None,
                 forward_fn: Callable | None = None,
                 epoch_in_loss: bool = False,
                 init_input: torch.Tensor | None = None,
                 epoch_callback: Callable | None = None):
        """
        :param model: initialized module; moved to `device`
        :param ds: the fold's training set; by default (a PointDataset)
            batches are sampled from its store on `device`
        :param batch_fn: ``batch_fn(generator, case_idx, train) -> (x, y)``
            to draw batches otherwise (the PC-AE samples its meshes), with
            a generator and indices on `device`
        :param loss_fn: ``loss_fn(out, y) -> (loss, components)``, with
            `epoch_in_loss` ``loss_fn(out, y, epoch=epoch)``
        :param forward_fn: ``forward_fn(model, x, train) -> out`` instead
            of ``model(x)``
        :param init_input: an input for one eval-mode forward before
            training
        :param epoch_callback: ``epoch_callback(trainer, epoch) -> bool``,
            called before each epoch
        :param device: where to train (default: the first CUDA card; the
            CPU only when ``device="cpu"`` is passed — without a card and
            without `device` it raises)
        """
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("ModelTrainer: no CUDA card found; pass "
                               "device='cpu' to train on the CPU")
        self.device = torch.device("cuda" if device is None else device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.forward_fn = forward_fn
        self.epoch_in_loss = epoch_in_loss
        self.epoch_callback = epoch_callback
        self.current_epoch = 0
        self.out_dir = out_dir
        self.cfg = config
        os.makedirs(out_dir, exist_ok=True)

        rng = np.random.default_rng(config.seed)
        n_val = int(len(ds) * config.val_split)
        perm = rng.permutation(len(ds))
        self.val_indices = perm[:n_val].tolist()
        self.train_indices = perm[n_val:].tolist()

        if batch_fn is None:
            store = ds.to_store(device=self.device)

            def batch_fn(generator, case_idx, train):
                return sample_batch(store, case_idx, ds.sample_points,
                                    generator,
                                    augment=train and ds.do_augmentation,
                                    binary=ds.binary)
        self.batch_fn = batch_fn

        n_train = len(self.train_indices)
        self.drop_last = n_train // 2 >= config.batch_size
        if self.drop_last:
            self.steps_per_epoch = n_train // config.batch_size
        else:
            self.steps_per_epoch = max(1, -(-n_train // config.batch_size))

        if init_input is not None:
            with torch.no_grad():
                self.model.eval()
                self._forward(init_input.to(self.device), False)

        self.min_lr = config.lr * 0.05
        self.optimizer = torch.optim.Adam(self.model.parameters(),
                                          lr=config.lr,
                                          weight_decay=config.weight_decay)
        if config.scheduler == "plateau":
            wait = math.ceil(0.05 * config.epochs)
            self.scheduler = PlateauScheduler(
                config.lr, factor=0.8, patience=wait, threshold=1e-4,
                cooldown=wait, min_lr=self.min_lr)
        elif config.scheduler in ("cosine", "none"):
            self.scheduler = None
        else:
            raise ValueError(f'Scheduler "{config.scheduler}" undefined.')

        self.training_history: dict[str, list] = {}
        self.validation_history: dict[str, list] = {}
        self.best_epoch = 0
        self.best_val = float("inf")
        self.best_snapshot = None

    # ---- one step / one epoch ----
    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _cosine_lr(self, epoch: int) -> float:
        cfg = self.cfg
        return self.min_lr + (cfg.lr - self.min_lr) * \
            (1 + math.cos(math.pi * epoch / cfg.epochs)) / 2

    def _forward(self, x, train: bool):
        if self.forward_fn is not None:
            return self.forward_fn(self.model, x, train)
        return self.model(x)

    def _loss(self, out, y, epoch: int):
        if self.epoch_in_loss:
            return self.loss_fn(out, y, epoch=epoch)
        return self.loss_fn(out, y)

    def train_step(self, x: torch.Tensor, y, epoch: int | None = None):
        """One Adam step on the batch (`epoch`: the loss's, default the
        current one); returns (loss, components) as device tensors,
        detached."""
        self.model.train()
        loss, comps = self._loss(self._forward(x, True), y,
                                 self.current_epoch if epoch is None
                                 else epoch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in comps.items()}

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _epoch(self, perm: np.ndarray, seed: int):
        gen = self._generator(seed)
        idx = torch.as_tensor(perm, device=self.device)
        losses, comps = [], {}
        for step in range(perm.shape[0]):
            x, y = self.batch_fn(gen, idx[step], True)
            loss, c = self.train_step(x, y)
            losses.append(loss)
            for k, v in c.items():
                comps.setdefault(k, []).append(v)
        means = {"total_loss": torch.stack(losses).mean(),
                 **{k: torch.stack(v).mean() for k, v in comps.items()}}
        return {k: float(v) for k, v in
                zip(means, torch.stack(list(means.values())).cpu())}

    @torch.no_grad()
    def _validate(self, seed: int):
        self.model.eval()
        idx = torch.as_tensor(self.val_indices, device=self.device)
        x, y = self.batch_fn(self._generator(seed), idx, False)
        loss, comps = self._loss(self._forward(x, False), y,
                                 self.current_epoch)
        vals = {"total_loss": loss, **comps}
        return {k: float(v) for k, v in
                zip(vals, torch.stack(list(vals.values())).cpu())}

    # ---- host-side orchestration ----
    def _make_perm(self, rng: np.random.Generator) -> np.ndarray:
        """(steps, batch) case indices for one epoch; the last partial batch
        is filled with re-draws. (The JAX trainer draws one extra
        permutation only, and fails when steps * batch exceeds twice the
        training set; here permutations are appended until the batch is
        full, which draws the same numbers wherever the JAX trainer works.)"""
        idx = np.asarray(self.train_indices)
        b, s = self.cfg.batch_size, self.steps_per_epoch
        need = s * b
        perm = rng.permutation(len(idx))
        while len(perm) < need:
            perm = np.concatenate([perm, rng.permutation(len(idx))])
        return idx[perm[:need]].reshape(s, b)

    @staticmethod
    def _epoch_seeds(rng: np.random.Generator):
        return (int(s) for s in rng.integers(0, 2 ** 62, size=2))

    def _record(self, history, values: dict, epoch: int) -> None:
        for k, v in values.items():
            history.setdefault(k, [0.0] * self.cfg.epochs)
            history[k][epoch] = float(v)

    def _state(self) -> dict:
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.model.state_dict().items()}

    # ---- checkpoint / resume ----
    @property
    def _ckpt_path(self) -> str:
        return os.path.join(self.out_dir, "checkpoint.pt")

    def save_checkpoint(self, epoch: int) -> None:
        state = {
            "epoch": epoch,
            "model": self._state(),
            "optimizer": self.optimizer.state_dict(),
            "training_history": self.training_history,
            "validation_history": self.validation_history,
            "best_epoch": self.best_epoch, "best_val": self.best_val,
            "best_snapshot": self.best_snapshot,
            "scheduler": self.scheduler.state_dict() if self.scheduler
            else None,
        }
        tmp = self._ckpt_path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._ckpt_path)

    def load_checkpoint(self) -> int:
        """Restore the full training state; returns the next epoch to run."""
        state = torch.load(self._ckpt_path, map_location=self.device,
                           weights_only=True)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])

        def pad(h):
            return {k: v + [0.0] * max(0, self.cfg.epochs - len(v))
                    for k, v in h.items()}
        self.training_history = pad(state["training_history"])
        self.validation_history = pad(state["validation_history"])
        self.best_epoch = state["best_epoch"]
        self.best_val = state["best_val"]
        self.best_snapshot = state["best_snapshot"]
        if self.best_snapshot is not None:
            self.best_snapshot = {k: v.cpu()
                                  for k, v in self.best_snapshot.items()}
        if self.scheduler and state["scheduler"]:
            self.scheduler.load_state_dict(state["scheduler"])
        return state["epoch"] + 1

    def run(self, initial_epoch: int = 0, resume: bool = False):
        cfg = self.cfg
        if resume and os.path.exists(self._ckpt_path):
            initial_epoch = self.load_checkpoint()
            print(f"resuming from checkpoint at epoch {initial_epoch}")
        rng_perm = np.random.default_rng(cfg.seed + 1)
        rng_seeds = np.random.default_rng(cfg.seed + 2)
        # replay the host streams so a resumed run sees the same draws
        for _ in range(initial_epoch):
            self._make_perm(rng_perm)
            tuple(self._epoch_seeds(rng_seeds))
        training_start = time.time()

        for epoch in range(initial_epoch, cfg.epochs):
            epoch_start = time.time()
            self.current_epoch = epoch
            if self.epoch_callback is not None:
                self.epoch_callback(self, epoch)
            if cfg.scheduler == "cosine":
                self._set_lr(self._cosine_lr(epoch))
            seed_ep, seed_val = self._epoch_seeds(rng_seeds)
            train_vals = self._epoch(self._make_perm(rng_perm), seed_ep)
            self._record(self.training_history, train_vals, epoch)
            val_vals = (self._validate(seed_val) if self.val_indices
                        else train_vals)
            self._record(self.validation_history, val_vals, epoch)
            val_total = val_vals["total_loss"]

            if cfg.scheduler == "plateau":
                self._set_lr(self.scheduler.step(val_total))
            if val_total <= self.best_val:
                self.best_val = val_total
                self.best_epoch = epoch
                self.best_snapshot = self._state()
            if cfg.checkpoint_every and (epoch + 1) % cfg.checkpoint_every == 0:
                self.save_checkpoint(epoch)
            if epoch % cfg.show_every == 0 or epoch == cfg.epochs - 1:
                print(f"EPOCH {epoch} ({time.time() - epoch_start:.3f}s) "
                      f"train {train_vals['total_loss']:.4f} "
                      f"val {val_total:.4f}", flush=True)

        self._finalize(time.time() - training_start)
        return self.model

    def _finalize(self, total_train_time_s: float) -> None:
        with open(os.path.join(self.out_dir, "train_time.csv"), "w") as f:
            w = csv.writer(f)
            w.writerow(["train time [m]"])
            w.writerow([str(total_train_time_s / 60)])
        if self.best_snapshot is not None:
            self.model.load_state_dict(copy.deepcopy(self.best_snapshot))
        save_model(self.model, os.path.join(self.out_dir, "model.pt"))
        self._save_history()
        self._plot_progression()

    def _save_history(self) -> None:
        keys = sorted(self.training_history)
        with open(os.path.join(self.out_dir, "history.csv"), "w") as f:
            w = csv.writer(f)
            w.writerow([f"train_{k}" for k in keys]
                       + [f"val_{k}" for k in keys])
            for ep in range(self.cfg.epochs):
                w.writerow([self.training_history[k][ep] for k in keys]
                           + [self.validation_history[k][ep] for k in keys])

    def _plot_progression(self) -> None:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.plot(self.training_history["total_loss"], label="train")
        ax.plot(self.validation_history["total_loss"], label="valid")
        ax.axvline(self.best_epoch, color="g", ls="--",
                   label=f"best ({self.best_epoch})")
        ax.set_xlabel("epoch")
        ax.set_ylabel("loss")
        ax.legend()
        fig.savefig(os.path.join(self.out_dir, "training_progression.png"),
                    dpi=100)
        plt.close(fig)
