"""repro_torch.train — the checkpoint API of ``repro.train`` (the atomic,
manifest-driven protocol the streaming service commits through).  The
optimizer and the training loop are not ported yet (ROADMAP.md queue 1
item 11)."""
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

__all__ = [
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
