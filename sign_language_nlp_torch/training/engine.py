"""The population trainer: the port of
sign_language_nlp_tpu/training/engine.py (TrainTask, TrainConfig,
PopulationTrainer.fit and predict_log_probs; engine.py:268-390,
761-1294 there).

A population is P independent fits (cells) over one shared corpus: each
cell has its own train and monitor rows, learning rate and dropout rate.
The JAX engine vmaps the cells into one compiled program, a TPU compile
and dispatch economy. Here each cell is its own module on the device,
with its own optimizer state and its own `torch.Generator`, and each
epoch steps the cells one after another; the attention kernels take one
cell's [B,S,E] as they are. Per cell, every epoch is what the JAX
program does to it:

  * the cell's rows are a padded index matrix: pad rows point at row 0
    with weight 0 and label `tgt_pad_idx`, so they drop out of the loss
    and of every metric (engine.py:83-93, 775);
  * one batch size for every cell, min(batch_size, most rows of any
    cell), so every cell takes the same number of steps (engine.py
    :532-560);
  * a train pass (dropout on; the metric statistics come from these
    outputs, as skorch's on_train scoring does, engine.py:782-786), then
    a valid pass in eval mode;
  * the monitor (training/schedule.py) updates the learning rate, early
    stopping and the best-params snapshot on the valid loss;
  * the loop ends when every cell has stopped.

A cell that has stopped is skipped, where the JAX program steps it at
learning rate 0 (engine.py:802): its params, monitor and best params
stay exactly as the JAX program leaves them, and its history after the
stop repeats its last row, as the JAX compaction path records frozen
cells (engine.py:1076-1086).

A cell's init and dropout streams are seeded from (TrainConfig.seed,
seed_id), so its fit does not depend on how the population was packed
(engine.py:277-282). The streams cannot be the JAX package's; compare
the two from the same weights with dropout off.

Not ported yet, and refused when turned on: shuffle, length bucketing,
compaction, epoch blocking, remat and the mesh (ROADMAP queue 1 item 6).
The port runs f32 only (models/registry.py refuses bf16).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..ops.losses import resolve_criterion
from ..ops.metrics import (finalize_metric_stats, init_metric_stats,
                           update_metric_stats)
from ..predict import resolve_device
from ..utils import log
from .optimizers import clip_by_global_norm, make_optimizer, set_lr
from .schedule import (EarlyStopConfig, PlateauConfig, init_monitor_state,
                       update_monitor_state)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pad_idx_matrix(rows: list, pad_to: int) -> tuple:
    """List of 1-D index arrays → ([P, pad_to] int32 indices padded with
    0, [P, pad_to] float32 weights)."""
    P = len(rows)
    idx = np.zeros((P, pad_to), np.int32)
    w = np.zeros((P, pad_to), np.float32)
    for i, r in enumerate(rows):
        r = np.asarray(r, np.int32)
        idx[i, :len(r)] = r
        w[i, :len(r)] = 1.0
    return idx, w


@dataclass
class TrainTask:
    """One population: per-cell row indices + hyperparameters."""

    train_rows: list                # P arrays of corpus row indices
    valid_rows: list                # P arrays (monitor split)
    lr: np.ndarray                  # [P]
    dropout: np.ndarray             # [P]
    cell_ids: list = field(default_factory=list)  # opaque labels
    # Stable per-cell RNG identity (default arange(P)): a cell's init and
    # dropout streams are seeded from (TrainConfig.seed, seed_id), so its
    # fit is the same in any population.
    seed_ids: Optional[np.ndarray] = None
    # Floor (n_train_rows, n_valid_rows) for the padded row matrices, so
    # chunks of one grid share one geometry.
    pad_rows_to: Optional[tuple] = None

    @property
    def population(self) -> int:
        return len(self.train_rows)


@dataclass
class TrainConfig:
    optimizer: str = "torch.optim.SGD"
    optimizer_args: dict = field(default_factory=dict)
    criterion: str = "torch.nn.CrossEntropyLoss"
    criterion_args: dict = field(default_factory=dict)
    batch_size: int = 50
    max_epochs: int = 200
    gradient_clipping: Optional[dict] = None   # {"gradient_clip_value": x}
    lr_scheduler: Optional[dict] = None        # reference lr_scheduler args
    early_stopping: Optional[dict] = None      # reference early_stopping args
    scoring: tuple = ("accuracy",)
    seed: int = 0
    eval_batch_size: int = 256
    keep_best_params: bool = True
    verbose: int = 1
    # True removes dropout from the train step (attribution and
    # cross-framework checks).
    train_deterministic: bool = False
    # The torch device the population trains on. There is no fallback:
    # "cuda" without a card raises; the CPU runs only when named.
    device: str = "cuda"
    # Fields of the JAX TrainConfig whose features are not ported yet
    # (ROADMAP queue 1 item 6). Each raises NotImplementedError when
    # turned on; the tuning fields beside them are kept for the day they
    # are.
    shuffle: bool = False
    shuffle_device: bool = True
    remat: bool = False
    compact: bool = False
    compact_min_remaining: int = 20
    compact_granularity: Optional[int] = None
    length_bucketing: bool = False
    bucket_percentile: float = 50.0
    bucket_percentiles: Optional[object] = None
    epoch_block: int = 1
    epoch_block_threshold_s: float = 0.75


# (field, its value when off): the features the port does not have yet.
_NOT_PORTED = (("shuffle", False), ("remat", False), ("compact", False),
               ("length_bucketing", False), ("epoch_block", 1))


def _plateau_from_config(cfg: TrainConfig) -> PlateauConfig:
    a = cfg.lr_scheduler or {}
    if not a:
        return PlateauConfig(enabled=False)
    return PlateauConfig(
        factor=float(a.get("factor", 0.1)),
        patience=int(a.get("patience", 10)),
        threshold=float(a.get("threshold", 1e-4)),
        threshold_mode=str(a.get("threshold_mode", "rel")),
        min_lr=float(a.get("min_lr", 0.0)),
        enabled=True)


def _earlystop_from_config(cfg: TrainConfig) -> EarlyStopConfig:
    a = cfg.early_stopping or {}
    if not a:
        return EarlyStopConfig(enabled=False)
    return EarlyStopConfig(
        patience=int(a.get("patience", 5)),
        threshold=float(a.get("threshold", 1e-4)),
        threshold_mode=str(a.get("threshold_mode", "rel")),
        enabled=True)


def cell_generators(seed: int, seed_id: int, device: torch.device
                    ) -> tuple[torch.Generator, torch.Generator]:
    """(init generator on the CPU, dropout generator on `device`) of the
    cell `seed_id`, from two 64-bit words of a numpy SeedSequence over
    (seed, seed_id)."""
    init_seed, drop_seed = np.random.SeedSequence(
        [int(seed), int(seed_id)]).generate_state(2, np.uint64)
    return (torch.Generator().manual_seed(int(init_seed)),
            torch.Generator(device=device).manual_seed(int(drop_seed)))


class _Cell:
    """One fit's module, optimizer, dropout generator and best params."""

    def __init__(self, model: nn.Module, optimizer, generator,
                 keep_best: bool):
        self.model = model
        self.optimizer = optimizer
        self.generator = generator
        self.best = _snapshot(model) if keep_best else None


def _snapshot(model: nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


class PopulationTrainer:
    """`model_factory(generator)` builds one cell's model with weights
    drawn from the CPU `generator` (e.g. a `models.registry.build_model`
    call); `fit` trains a population of them."""

    def __init__(self, model_factory: Callable[[torch.Generator], nn.Module],
                 tgt_pad_idx: int, num_classes: int, config: TrainConfig,
                 mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "the mesh (population sharded over cards) is not ported "
                "yet (ROADMAP queue 1 item 12)")
        self.model_factory = model_factory
        self.config = config
        self.tgt_pad_idx = int(tgt_pad_idx)
        self.num_classes = int(num_classes)
        self.criterion = resolve_criterion(config.criterion)
        self.plateau = _plateau_from_config(config)
        self.early = _earlystop_from_config(config)
        self.clip_value = (config.gradient_clipping or {}).get(
            "gradient_clip_value")
        for name, off in _NOT_PORTED:
            if getattr(config, name) != off:
                raise NotImplementedError(
                    f"TrainConfig.{name}={getattr(config, name)!r} is not "
                    "ported yet (ROADMAP queue 1 item 6)")

    # ------------------------------------------------------------ geometry
    def _geometry(self, task: TrainTask) -> tuple:
        """(batch, eval_batch, n_train_batches, n_valid_batches), as the
        JAX engine's single-bucket geometry (engine.py:532-560)."""
        cfg = self.config
        n_tr = max(len(r) for r in task.train_rows)
        n_va = max(len(r) for r in task.valid_rows)
        if task.pad_rows_to is not None:
            n_tr = max(n_tr, int(task.pad_rows_to[0]))
            n_va = max(n_va, int(task.pad_rows_to[1]))
        if n_va == 0:
            n_va = 1  # the monitor needs a valid loss: one weight-0 batch
        batch = min(cfg.batch_size, max(n_tr, 1))
        eval_batch = min(cfg.eval_batch_size, max(n_va, 1))
        return (batch, eval_batch, _ceil_div(n_tr, batch),
                _ceil_div(n_va, eval_batch))

    # ------------------------------------------------------------ one cell
    def _batches(self, corpus, idx, w, batch):
        """Yield (tokens, lengths, y, w) per batch of one cell's padded
        index row; pad rows take y = pad (the ignore index)."""
        tokens, lengths, labels = corpus
        for b in range(idx.shape[0] // batch):
            sl = slice(b * batch, (b + 1) * batch)
            idx_b, w_b = idx[sl], w[sl]
            y = torch.where(w_b > 0, labels[idx_b],
                            torch.full_like(labels[idx_b],
                                            self.tgt_pad_idx))
            yield tokens[idx_b], lengths[idx_b], y, w_b

    def _train_epoch(self, cell: _Cell, corpus, idx, w, batch, lr: float,
                     rate: float) -> dict:
        cfg = self.config
        model = cell.model
        model.train()
        set_lr(cell.optimizer, lr)
        params = [p for p in model.parameters() if p.requires_grad]
        stats = init_metric_stats(self.num_classes, idx.device)
        for tok, ln, y, w_b in self._batches(corpus, idx, w, batch):
            out = model(tok, ln, y, dropout_rate=rate,
                        generator=cell.generator)
            loss = self.criterion(out, y, ignore_index=self.tgt_pad_idx,
                                  sample_weight=w_b)
            cell.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if self.clip_value is not None:
                clip_by_global_norm([p.grad for p in params
                                     if p.grad is not None],
                                    float(self.clip_value))
            cell.optimizer.step()
            stats = update_metric_stats(stats, y, out.detach(), w_b,
                                        loss_sum=loss.detach() * w_b.sum())
        return finalize_metric_stats(stats, tuple(cfg.scoring) + ("loss",))

    @torch.no_grad()
    def _eval_epoch(self, model: nn.Module, corpus, idx, w,
                    eval_batch) -> dict:
        model.eval()
        stats = init_metric_stats(self.num_classes, idx.device)
        for tok, ln, y, w_b in self._batches(corpus, idx, w, eval_batch):
            out = model(tok, ln, y)
            loss = self.criterion(out, y, ignore_index=self.tgt_pad_idx,
                                  sample_weight=w_b)
            stats = update_metric_stats(stats, y, out, w_b,
                                        loss_sum=loss * w_b.sum())
        return finalize_metric_stats(stats,
                                     tuple(self.config.scoring) + ("loss",))

    def _new_cell(self, seed_id: int, init_state: dict | None,
                  lr: float, dev: torch.device) -> _Cell:
        cfg = self.config
        init_gen, drop_gen = cell_generators(cfg.seed, seed_id, dev)
        model = self.model_factory(init_gen)
        if init_state is not None:
            model.load_state_dict(init_state)
        model.to(dev)
        optimizer = make_optimizer(cfg.optimizer, cfg.optimizer_args,
                                   model.parameters(), lr)
        return _Cell(model, optimizer, drop_gen, cfg.keep_best_params)

    # ------------------------------------------------------------ fit
    def fit(self, data, task: TrainTask, init_params: list | None = None
            ) -> dict:
        """data: (tokens [N,S], lengths [N], labels [N]) numpy arrays.
        init_params: optional list of P state dicts to start from (e.g.
        `models.convert.params_from_jax_population` of a JAX population);
        optimizer state starts fresh.

        Returns {"params": [P state dicts], "best_params": [P state
        dicts] (None without keep_best_params), "monitor": MonitorState
        of [P] arrays, "history": {name: [E, P] array}, "epochs_run":
        [P], "steps": train steps taken over all cells, "eval_batches":
        valid batches run over all cells}."""
        cfg = self.config
        dev = resolve_device(cfg.device)
        P = task.population
        if init_params is not None and len(init_params) != P:
            raise ValueError(f"{len(init_params)} init states for {P} cells")
        tokens, lengths, labels = [np.asarray(a) for a in data]
        batch, eval_batch, n_tb, n_vb = self._geometry(task)
        train_idx, train_w = _pad_idx_matrix(task.train_rows, n_tb * batch)
        valid_idx, valid_w = _pad_idx_matrix(task.valid_rows,
                                             n_vb * eval_batch)
        seed_ids = np.asarray(task.seed_ids if task.seed_ids is not None
                              else np.arange(P), np.int64)
        rates = np.zeros(P) if cfg.train_deterministic else np.asarray(
            task.dropout, np.float64)

        def on_dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        corpus = (on_dev(tokens, torch.int64), on_dev(lengths, torch.int64),
                  on_dev(labels, torch.int64))
        train_idx, valid_idx = (on_dev(m, torch.int64)
                                for m in (train_idx, valid_idx))
        train_w, valid_w = (on_dev(m, torch.float32)
                            for m in (train_w, valid_w))
        monitor = init_monitor_state(np.asarray(task.lr, np.float32))
        cells = [self._new_cell(int(seed_ids[c]),
                                None if init_params is None
                                else init_params[c],
                                float(monitor.lr[c]), dev)
                 for c in range(P)]

        history: list = []
        steps = eval_batches = 0
        names = tuple(cfg.scoring) + ("loss",)
        while (len(history) < cfg.max_epochs
               and not bool(monitor.stopped.all())):
            t0 = time.perf_counter()
            live = np.flatnonzero(~monitor.stopped)
            metrics = {}
            for c in live:
                cell = cells[c]
                train = self._train_epoch(cell, corpus, train_idx[c],
                                          train_w[c], batch,
                                          float(monitor.lr[c]),
                                          float(rates[c]))
                valid = self._eval_epoch(cell.model, corpus, valid_idx[c],
                                         valid_w[c], eval_batch)
                metrics[c] = (train, valid)
                steps += n_tb
                eval_batches += n_vb
            valid_loss = np.full(P, np.inf, np.float32)
            for c, (_, valid) in metrics.items():
                valid_loss[c] = valid["loss"]
            monitor, improved = update_monitor_state(
                monitor, valid_loss, self.plateau, self.early)
            for c in live:
                if cfg.keep_best_params and improved[c]:
                    cells[c].best = _snapshot(cells[c].model)

            rec = ({k: v.copy() for k, v in history[-1].items()} if history
                   else {"lr": np.zeros(P, np.float32),
                         "stopped": np.zeros(P, bool),
                         "ckpt_improved": np.zeros(P, bool),
                         **{f"{s}_{n}": np.zeros(P, np.float32)
                            for s in ("train", "valid") for n in names}})
            for c, (train, valid) in metrics.items():
                rec["lr"][c] = monitor.lr[c]
                rec["stopped"][c] = monitor.stopped[c]
                rec["ckpt_improved"][c] = improved[c]
                for n in names:
                    rec[f"train_{n}"][c] = train[n]
                    rec[f"valid_{n}"][c] = valid[n]
            history.append(rec)
            if cfg.verbose >= 2:
                log(f"epoch {len(history)}: valid_loss="
                    f"{rec['valid_loss'].round(4)} stopped="
                    f"{int(rec['stopped'].sum())}/{P} "
                    f"({time.perf_counter() - t0:.2f} s)")

        return {
            "params": [{k: v.detach() for k, v in
                        cell.model.state_dict().items()} for cell in cells],
            "best_params": ([cell.best for cell in cells]
                            if cfg.keep_best_params else None),
            "monitor": monitor,
            "history": {k: np.stack([h[k] for h in history])
                        for k in history[0]} if history else {},
            "epochs_run": monitor.epoch.copy(),
            "steps": steps,
            "eval_batches": eval_batches,
        }

    # ------------------------------------------------------------ predict
    @torch.no_grad()
    def predict_log_probs(self, params: list, data, rows: list,
                          batch_size: int | None = None) -> tuple:
        """Batched inference for P cells (`params`: P state dicts) over
        per-cell row lists. Returns ([P, M, V] log-probs, [P, M]
        weights) as numpy, M the most rows of any cell; pad rows (weight
        0) read row 0, as in the JAX engine."""
        dev = resolve_device(self.config.device)
        tokens, lengths, labels = (
            torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)
            for a in data)
        M = max(max(len(r) for r in rows), 1)
        eb = min(batch_size or self.config.eval_batch_size, M)
        idx, w = _pad_idx_matrix(rows, _ceil_div(M, eb) * eb)
        idx_d = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        outs = []
        for c, state in enumerate(params):
            model = self.model_factory(torch.Generator().manual_seed(0))
            model.load_state_dict(state)
            model.to(dev).eval()
            cell_out = [model(tokens[idx_d[c, s:s + eb]],
                              lengths[idx_d[c, s:s + eb]],
                              labels[idx_d[c, s:s + eb]]).cpu()
                        for s in range(0, idx.shape[1], eb)]
            outs.append(torch.cat(cell_out).numpy())
        return np.stack(outs)[:, :M], w[:, :M]


def predict_log_probs(model_factory, params: list, data, rows: list,
                      tgt_pad_idx: int = 1, num_classes: int | None = None,
                      batch_size: int = 256, device: str = "cuda") -> tuple:
    """Convenience single-shot predict (one state dict per cell)."""
    cfg = TrainConfig(eval_batch_size=batch_size, device=device)
    trainer = PopulationTrainer(model_factory, tgt_pad_idx,
                                num_classes or 2, cfg)
    return trainer.predict_log_probs(params, data, rows)
