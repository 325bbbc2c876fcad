"""The port's plain attention as it was written before it could be
differentiated: kv heads widened by ``repeat_interleave`` and both masks
applied in place.  ``ref.ref_attention`` must give the same values, bit for
bit, so the yardstick of the serving tests and of ``chip_smoke.py``'s
phases 6 and 7 did not move.  Imports torch only."""
import torch


def ref_attention_before(q, k, v, *, causal=True, window=None, scale=None):
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    kk = k.repeat_interleave(group, dim=1).to(torch.float32)
    vv = v.repeat_interleave(group, dim=1).to(torch.float32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kk) * scale
    q_pos = torch.arange(lq, device=q.device)[:, None] + (lkv - lq)
    k_pos = torch.arange(lkv, device=q.device)[None, :]
    mask = torch.ones(lq, lkv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    probs = torch.softmax(logits.masked_fill_(~mask, float("-inf")), dim=-1)
    del logits
    probs.masked_fill_(~mask.any(dim=-1, keepdim=True), 0.0)
    return (probs @ vv).to(q.dtype)
