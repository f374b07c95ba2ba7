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

Data parallelism (`group=`, the counterpart of the JAX trainer's `mesh=`,
train/trainer.py:103-125,195-230 there): one process a rank, each holding
the model; the trainer computes the single-device step of the global
batch, as GSPMD does:
  * the parameters and buffers are broadcast from the group's rank 0 at
    the start, and every BatchNorm (the fused EdgeConv's too) takes the
    global batch's statistics (models/blocks.py:convert_sync_batchnorm);
  * every rank draws the whole batch from the shared generator and keeps
    its contiguous share of the rows (data/store.py:sample_batch `rows`),
    so each rank trains on exactly the rows a single-device run draws at
    the same seed; the batch size must divide by the group's size (the
    store's sampler only: a caller's `batch_fn` is refused under a group);
  * the loss is taken with ``group=`` (losses/segmentation.py): its value
    on every rank is the global batch's, and its backward leaves each
    rank its share of the gradient; the shares are summed over the group
    once a step (one flat all-reduce) and Adam runs alike on every rank;
  * validation gives the global value: split over the ranks where the
    validation set divides by the group's size, else the whole set on
    every rank (the JAX trainer replicates it then too);
  * only rank 0 writes (checkpoints, history, plots, model.pt, the
    visualizations); `run()` returns the same best snapshot on every rank.

`visualization_fn(x, y, out, epoch, out_dir)` (the JAX trainer's hook,
train/trainer.py:111-135,393-399 there): after validation, every
`visualize_every` epochs, with host numpy arrays of the validation batch
and the eval-mode output (utils/visualization.py:point_seg_visualization).

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
import inspect
import math
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..data.store import sample_batch
from ..models.blocks import convert_sync_batchnorm
from ..models.weights import save_model
from ..ops.collectives import all_reduce_, global_rank, group_rank, group_size
from ..utils.profiling import span


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
                 epoch_callback: Callable | None = None,
                 visualization_fn: Callable | None = None,
                 visualize_every: int = 1, group=None):
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
        :param visualization_fn: ``fn(x, y, out, epoch, out_dir)`` every
            `visualize_every` epochs (rank 0 only)
        :param group: a torch.distributed process group to train over,
            data-parallel (this process is one rank, `device` its device);
            the loss must take ``group=``
        """
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("ModelTrainer: no CUDA card found; pass "
                               "device='cpu' to train on the CPU")
        self.device = torch.device("cuda" if device is None else device)
        self.model = model.to(self.device)
        self.group = group
        self.rank, self.world = group_rank(group), group_size(group)
        if group is not None:
            if config.batch_size % self.world:
                raise ValueError(f"batch_size {config.batch_size} not "
                                 f"divisible by the group's size "
                                 f"{self.world}")
            if "group" not in inspect.signature(loss_fn).parameters:
                raise ValueError("ModelTrainer: under a group the loss must "
                                 "take group= (losses/segmentation.py)")
            if batch_fn is not None:
                raise ValueError("ModelTrainer: under a group batches come "
                                 "from the dataset's store")
            convert_sync_batchnorm(self.model, group)
            with torch.no_grad():
                for t in self.model.state_dict().values():
                    dist.broadcast(t, src=global_rank(group, 0), group=group)
        self.visualization_fn = visualization_fn
        self.visualize_every = visualize_every
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

            def batch_fn(generator, case_idx, train, rows=None):
                with span("train.sample"):
                    return sample_batch(store, case_idx, ds.sample_points,
                                        generator,
                                        augment=train and ds.do_augmentation,
                                        binary=ds.binary, rows=rows)
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

    def _loss(self, out, y, epoch: int, group=None):
        kw = {} if group is None else {"group": group}
        if self.epoch_in_loss:
            kw["epoch"] = epoch
        return self.loss_fn(out, y, **kw)

    def train_step(self, x: torch.Tensor, y, epoch: int | None = None):
        """One Adam step on the batch (`epoch`: the loss's, default the
        current one); returns (loss, components) as device tensors,
        detached. Under a group x and y are this rank's rows, and the
        loss is the global batch's."""
        self.model.train()
        with span("train.forward"):
            out = self._forward(x, True)
        with span("train.loss"):
            loss, comps = self._loss(out, y, self.current_epoch
                                     if epoch is None else epoch, self.group)
        with span("train.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if self.group is not None:
                self._sum_gradients()
        with span("train.optimizer"):
            self.optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in comps.items()}

    def _sum_gradients(self) -> None:
        """Sum the ranks' shares of the gradient over the group, as one flat
        all-reduce."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]),
                           self.group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def _rows(self, n: int) -> slice:
        """This rank's contiguous share of a batch of n rows."""
        share = n // self.world
        return slice(self.rank * share, (self.rank + 1) * share)

    def _draw(self, gen, idx, train: bool, rows: slice | None):
        """The batch of case indices `idx`, or its `rows` only (drawn for
        the whole batch)."""
        if rows is None:
            return self.batch_fn(gen, idx, train)
        return self.batch_fn(gen, idx, train, rows=rows)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _epoch(self, perm: np.ndarray, seed: int):
        gen = self._generator(seed)
        idx = torch.as_tensor(perm, device=self.device)
        rows = None if self.group is None else self._rows(perm.shape[1])
        losses, comps = [], {}
        for step in range(perm.shape[0]):
            x, y = self._draw(gen, idx[step], True, rows)
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
        split = self.group is not None and len(idx) % self.world == 0
        x, y = self._draw(self._generator(seed), idx, False,
                          self._rows(len(idx)) if split else None)
        loss, comps = self._loss(self._forward(x, False), y,
                                 self.current_epoch,
                                 self.group if split else None)
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

    @torch.no_grad()
    def _visualize(self, seed: int, epoch: int) -> None:
        """The hook on the validation batch, in eval mode (rank 0)."""
        self.model.eval()
        idx = torch.as_tensor(self.val_indices, device=self.device)
        x, y = self.batch_fn(self._generator(seed), idx, False)
        out = self._forward(x, False)

        def host(t):
            if isinstance(t, torch.Tensor):
                return t.detach().float().cpu().numpy()
            if isinstance(t, dict):
                return {k: host(v) for k, v in t.items()}
            if isinstance(t, (tuple, list)):
                return type(t)(host(v) for v in t)
            return t
        self.visualization_fn(host(x), host(y), host(out), epoch,
                              self.out_dir)

    def _state(self) -> dict:
        return {k: v.detach().to("cpu", copy=True)
                for k, v in self.model.state_dict().items()}

    # ---- checkpoint / resume ----
    @property
    def _ckpt_path(self) -> str:
        return os.path.join(self.out_dir, "checkpoint.pt")

    def save_checkpoint(self, epoch: int) -> None:
        """Rank 0 writes the checkpoint; under a group every rank waits for
        it."""
        if self.rank == 0:
            self._write_checkpoint(epoch)
        if self.group is not None:
            dist.barrier(group=self.group)

    def _write_checkpoint(self, epoch: int) -> None:
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
            if (self.visualization_fn is not None and self.val_indices
                    and self.rank == 0
                    and (epoch + 1) % self.visualize_every == 0):
                self._visualize(seed_val, epoch)

            if cfg.scheduler == "plateau":
                self._set_lr(self.scheduler.step(val_total))
            if val_total <= self.best_val:
                self.best_val = val_total
                self.best_epoch = epoch
                self.best_snapshot = self._state()
            if cfg.checkpoint_every and (epoch + 1) % cfg.checkpoint_every == 0:
                self.save_checkpoint(epoch)
            if self.rank == 0 and (epoch % cfg.show_every == 0
                                   or epoch == cfg.epochs - 1):
                print(f"EPOCH {epoch} ({time.time() - epoch_start:.3f}s) "
                      f"train {train_vals['total_loss']:.4f} "
                      f"val {val_total:.4f}", flush=True)

        self._finalize(time.time() - training_start)
        return self.model

    def _finalize(self, total_train_time_s: float) -> None:
        if self.best_snapshot is not None:
            self.model.load_state_dict(copy.deepcopy(self.best_snapshot))
        if self.rank != 0:
            return
        with open(os.path.join(self.out_dir, "train_time.csv"), "w") as f:
            w = csv.writer(f)
            w.writerow(["train time [m]"])
            w.writerow([str(total_train_time_s / 60)])
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
