"""repro_torch.train — the port of ``repro.train``: the optimizer, the
training loop and the atomic, manifest-driven checkpoint protocol that the
trainer and the streaming service commit through."""
from .checkpoint import (  # noqa: F401
    complete_steps,
    gc_checkpoints,
    latest_step,
    read_manifest,
    restore_checkpoint,
    restore_latest,
    save_checkpoint,
    step_is_complete,
    tree_flatten,
    tree_unflatten,
)
from .loop import Trainer, TrainState  # noqa: F401
from .optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: F401

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "Trainer",
    "TrainState",
    "complete_steps",
    "gc_checkpoints",
    "latest_step",
    "read_manifest",
    "restore_checkpoint",
    "restore_latest",
    "save_checkpoint",
    "step_is_complete",
    "tree_flatten",
    "tree_unflatten",
]
