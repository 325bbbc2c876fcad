"""Training launcher: ``--arch <id>`` end to end — the port of
``repro/launch/train.py`` on one device.

Trains the arch's smoke config (``configs/<arch>.smoke_config()``, as the
reference does by default) on ``lm_batches`` through ``Trainer``, AdamW
with the reference launcher's settings (lr 3e-4, 20 warmup steps, WSD for
minicpm-2b, else cosine), checkpointing every ``max(steps // 4, 10)``
steps into ``--ckpt-dir`` and resuming from it.  Weights are drawn from
seed 0 by a ``torch.Generator`` on the device (the reference draws
``jax.random.key(0)``: other numbers).

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        --steps 8 --device cpu
    python -m repro_torch.launch.train --arch minicpm-2b --d-head 64

Runs on the card unless ``--device cpu``; without a card it raises.  On
the card attention runs through the kernel, which takes heads of 32, 64
and 128; the smoke configs' heads are 8, so on the card ``--d-head`` must
name one of those (the header line states it) or the run exits 2.  On the
CPU attention runs through the plain version.  The MoE archs
(``mixtral-8x7b``, ``arctic-480b``) train through the same ``loss_fn``,
with the auxiliary load-balancing term in the loss (``moe_aux_loss`` and
``moe_dropped`` on the log lines); their combine runs on the segment-sum
kernel on the card.
Unlike the reference, a run that resumes at or past ``--steps`` reports
that and exits 0 (the reference reads the last step's loss, which such a
run never logs, and raises).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import sys
import time


def smoke_config(arch: str, d_head=None):
    """``arch``'s smoke config, with heads of ``d_head`` when given."""
    cfg = importlib.import_module(
        f"..configs.{arch.replace('-', '_')}", __package__).smoke_config()
    return cfg if d_head is None else dataclasses.replace(cfg, d_head=d_head)


def train_lm(arch: str, steps: int, ckpt_dir, batch: int, seq: int,
             log_every: int, device="cuda", d_head=None):
    """Train ``arch``'s smoke config for ``steps`` steps; returns the last
    logged metrics (empty when the run resumed at or past ``steps``)."""
    from ..convert import transformer_param_tree
    from ..core.table import resolve_device
    from ..data.pipeline import Prefetcher, lm_batches
    from ..models import transformer as T
    from ..train import AdamWConfig, Trainer

    device = resolve_device(device)
    attn = "cuda" if device.type == "cuda" else "torch"
    cfg = dataclasses.replace(smoke_config(arch, d_head), kernel_backend=attn)
    opt = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=max(steps, 2),
                      schedule="wsd" if arch == "minicpm-2b" else "cosine")

    model = T.Transformer(cfg, device=device, seed=0)
    print(f"[train] arch={arch} (smoke config) params={cfg.n_params / 1e6:.1f}M "
          f"d_head={cfg.head_dim} batch={batch} seq={seq} device={device} "
          f"attn={attn}", flush=True)

    trainer = Trainer(
        lambda p, b: T.loss_fn(model, b["tokens"], b["labels"]),
        opt, ckpt_dir=ckpt_dir, ckpt_every=max(steps // 4, 10),
    )
    state = trainer.init_state(transformer_param_tree(model))
    taken = []  # one batch a step: the steps this run takes

    def counted(it):
        for b in it:
            taken.append(b["step"])
            yield b

    t0 = time.time()
    with Prefetcher(lm_batches(batch, seq, cfg.vocab, seed=0)) as batches:
        state, hist = trainer.run(state, counted(batches), steps,
                                  log_every=log_every)
    dt = time.time() - t0
    if not taken:
        print(f"[train] done: resumed at step {int(state.opt['step'])} of "
              f"{steps}, nothing to run", flush=True)
        return hist
    tok_s = len(taken) * batch * seq / dt
    print(f"[train] done: final loss {hist['loss']:.4f}  "
          f"{tok_s:,.0f} tok/s  stragglers={trainer.watchdog.flagged}", flush=True)
    return hist


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--d-head", type=int, default=None,
                    help="head size in place of the smoke config's; on the "
                         "card one the attention kernel takes (32, 64, 128)")
    args = ap.parse_args(argv)
    from ..core.table import resolve_device
    from ..kernels.flash_attention import HEAD_DIMS

    device = resolve_device(args.device)
    head_dim = smoke_config(args.arch, args.d_head).head_dim
    if device.type == "cuda" and head_dim not in HEAD_DIMS:
        print(f"{args.arch}: heads of {head_dim}; the attention kernel takes "
              f"{HEAD_DIMS}: pass --d-head, or --device cpu", file=sys.stderr)
        return 2
    train_lm(args.arch, args.steps, args.ckpt_dir, args.batch, args.seq,
             args.log_every, device, args.d_head)
    return 0


if __name__ == "__main__":
    sys.exit(main())
