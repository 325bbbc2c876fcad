"""The training loop: loss, gradients, AdamW, checkpoints, resume and the
straggler watchdog — the port of ``repro/train/loop.py``.

``Trainer`` keeps the reference's names and semantics: ``loss_fn(params,
batch) -> (loss, metrics)``; each step takes the gradients of the loss
with respect to every leaf of ``state.params`` (``torch.autograd.grad``)
and updates the parameters and the optimizer state in place
(:func:`~repro_torch.train.optimizer.adamw_update`, the counterpart of the
reference's ``jit`` with donated state).  The parameters are the model's
own tensors (``convert.transformer_param_tree``), so the model sees every
update.  Differences:

* :meth:`Trainer.init_state` marks the parameters as requiring grad;
* :meth:`Trainer.maybe_resume` copies the restored leaves into the state's
  tensors, which stay where they are, and raises on a leaf of another
  type; it returns the same state;
* on the card, each batch goes through one of two pinned host buffers per
  key and is copied with ``non_blocking=True``, as ``stream_plq`` copies
  its row groups: before refilling a buffer the host waits for the event
  recorded after the copy that last read it.

As in the reference, the metrics are read to the host only on log steps,
and :meth:`Trainer.run` reads the batch iterator from its start after a
resume (``loop.py:101``): a caller that wants an uninterrupted run's
batches passes ``lm_batches(start_step=...)``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..data.pipeline import PinnedStager
from .checkpoint import (restore_latest, save_checkpoint, tree_flatten,
                         tree_unflatten)
from .elastic import StragglerWatchdog
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainState", "Trainer"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any

    def tree(self):
        return {"params": self.params, "opt": self.opt}


class Trainer:
    def __init__(
        self,
        loss_fn: Callable,              # (params, batch) -> (loss, metrics)
        opt_cfg: AdamWConfig,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 100,
        keep: int = 3,
    ):
        self.loss_fn = loss_fn
        self.opt_cfg = opt_cfg
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.watchdog = StragglerWatchdog()
        self._stager: Optional[PinnedStager] = None

    def _step(self, state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict:
        leaves, treedef = tree_flatten(state.params)
        loss, metrics = self.loss_fn(state.params, batch)
        grads = torch.autograd.grad(loss, leaves)
        _, _, opt_metrics = adamw_update(tree_unflatten(treedef, grads),
                                         state.opt, state.params, self.opt_cfg)
        metrics = dict(metrics or {})
        metrics.update(opt_metrics)
        metrics["loss"] = loss.detach()
        return metrics

    def _to_device(self, batch: Dict[str, Any], device: torch.device
                   ) -> Dict[str, torch.Tensor]:
        """The host batch's arrays on ``device``; on the card through the
        stager's pinned double buffers, without a host sync."""
        if self._stager is None or self._stager.device != device:
            self._stager = PinnedStager(device)
        arrays = {k: np.asarray(v) for k, v in batch.items()}
        bufs = self._stager.take({k: (a.shape, a.dtype) for k, a in arrays.items()})
        for k, a in arrays.items():
            np.copyto(bufs[k], a)
        return self._stager.send()

    # -- lifecycle -----------------------------------------------------------
    def init_state(self, params) -> TrainState:
        for leaf in tree_flatten(params)[0]:
            leaf.requires_grad_(True)
        return TrainState(
            params=params, opt=adamw_init(params, self.opt_cfg.state_dtype))

    def maybe_resume(self, state: TrainState) -> Tuple[TrainState, int]:
        """Restore the latest committed checkpoint, if one exists, into the
        state's tensors."""
        if not self.ckpt_dir:
            return state, 0
        out = restore_latest(self.ckpt_dir, state.tree())
        if out is None:
            return state, 0
        step, tree, _extra = out
        with torch.no_grad():
            for i, (dst, src) in enumerate(zip(tree_flatten(state.tree())[0],
                                               tree_flatten(tree)[0])):
                src = torch.as_tensor(src)
                if src.dtype != dst.dtype:
                    raise ValueError(f"step {step} leaf {i} is {src.dtype}, the "
                                     f"state's is {dst.dtype}")
                dst.copy_(src)
        return state, step

    def checkpoint(self, state: TrainState, step: int) -> None:
        if self.ckpt_dir:
            save_checkpoint(
                self.ckpt_dir, step, state.tree(),
                extra={"wall_time": time.time()}, keep=self.keep,
            )

    # -- main loop ------------------------------------------------------------
    def run(
        self,
        state: TrainState,
        batches: Iterator[Dict[str, Any]],
        n_steps: int,
        log_every: int = 10,
        log_fn: Callable[[int, Dict], None] = None,
    ) -> Tuple[TrainState, Dict[str, float]]:
        state, start = self.maybe_resume(state)
        device = tree_flatten(state.params)[0][0].device
        history: Dict[str, float] = {}
        for step in range(start, n_steps):
            batch = next(batches)
            batch = {k: v for k, v in batch.items() if k not in ("step", "shard")}
            batch = self._to_device(batch, device)
            self.watchdog.start()
            metrics = self._step(state, batch)
            is_ckpt_step = self.ckpt_every and (step + 1) % self.ckpt_every == 0
            straggler = self.watchdog.stop(exclude=step == start or bool(is_ckpt_step))
            if is_ckpt_step:
                self.checkpoint(state, step + 1)
            if log_every and (step % log_every == 0 or step == n_steps - 1):
                history = {k: float(v) for k, v in metrics.items()}
                history["step"] = step
                history["straggler"] = bool(straggler)
                if log_fn:
                    log_fn(step, history)
                else:
                    msg = " ".join(
                        f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in history.items()
                    )
                    print(f"[train] {msg}", flush=True)
        return state, history
