"""The hand-written CUDA attention kernel and its wrapper.

Replaces the TPU kernel ``flash_attention_pallas``
(``repro/kernels/flash_attention.py:85``, body ``_fa_kernel`` at ``:33``):
FlashAttention-2's forward pass with GQA, a causal mask, a sliding window
and end alignment.  A sequential kv grid axis with VMEM scratch there; here
three kernels (``csrc/flash_attention.cu`` says why and what bounds each),
one path a call, picked from the shapes by :func:`attention_path`:

* ``"prefill"`` (bfloat16): a kv loop inside each block of 128 query rows,
  K and V tiles brought in by TMA, both products on ``wgmma``;
* ``"decode"`` (bfloat16, the GQA group's ``Hq / Hkv`` heads x ``Lq`` rows
  at most :data:`DECODE_ROWS`): the group packed into one tile, the kv axis
  split into chunks (:func:`decode_split`) whose float32 partials a second
  kernel combines, both launched by one C call;
* ``"f32"`` (float32): a CUDA-core loop, one warp a query row.

The plain version of the same contract is
:func:`repro_torch.kernels.ref.ref_attention`; the split-and-combine
arithmetic of the decode path is mirrored by
:func:`repro_torch.kernels.ref.ref_attention_split`.

:func:`flash_attention_cuda` takes CUDA tensors only and raises on anything
else; the dispatch between kernel and plain version lives in
:mod:`repro_torch.kernels.ops`.  ``LAUNCHES`` counts the wrapper's kernel
launches, so a run can show that its main path went through the kernel.

:class:`FlashAttention` makes the kernel differentiable, as the reference's
``custom_vjp`` (``flash_attention.py:143-171``) makes the TPU kernel: the
kernel runs the forward and saves ``(q, k, v)`` (``_fa_fwd``), and the
backward is the plain version's autograd on them (``_fa_bwd``, the exact
``jax.vjp`` of ``ref_attention``).  The reference has no backward kernel;
neither has the port.  The backward recomputes the plain forward, so it
holds the plain version's ``(B, Hq, Lq, Lkv)`` float32 buffers (logits,
probabilities and their gradients) for one layer at a time.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build, ref
from ._device import _on_device, _sm_count

__all__ = ["LAUNCHES", "HEAD_DIMS", "DECODE_ROWS", "attention_path",
           "decode_split", "flash_attention_cuda", "FlashAttention"]

LAUNCHES = 0

HEAD_DIMS = (32, 64, 128)  # the head sizes the source instantiates
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The decode kernel's packed tile: the GQA group's query heads x Lq rows, in
# one m16 tile of mma.sync.  Dispatch rule: a bfloat16 call whose group x Lq
# rows fit it takes the split-kv decode path; any other takes prefill, whose
# blocks hold 128 query rows of one head (at Lq = 1 its grid is B x Hq
# blocks, each using 1 of its 128 rows and walking the whole cache alone).
DECODE_ROWS = 16
DECODE_TILE = 64  # keys per stage of the decode kernel; chunks are whole tiles
# Chunks are sized for about this many decode blocks on each SM (two fit at
# once: 104 KB of shared memory each at D 128), in one wave.
DECODE_BLOCKS_PER_SM = 2


# The wrapper's host work sets a decode call's time (0.05-0.09 ms by CUDA
# events against 0.02 on the device, PERF.md), so the bound function is kept
# once found.
_FN = None


def _bind():
    global _FN
    if _FN is None:
        fn = build.load("flash_attention").flash_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, ctypes.POINTER(ctypes.c_longlong),
                       i, i, i, i, i, i, i, i, ctypes.c_float, p, i, i, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def attention_path(q: torch.Tensor, k: torch.Tensor) -> str:
    """The kernel a call with these operands runs: ``"f32"`` for float32,
    else ``"decode"`` when the GQA group's ``Hq / Hkv`` heads x ``Lq`` rows
    fit :data:`DECODE_ROWS`, else ``"prefill"``."""
    if q.dtype != torch.bfloat16:
        return "f32"
    rows = q.shape[1] // k.shape[1] * q.shape[2]
    return "decode" if rows <= DECODE_ROWS else "prefill"


def decode_split(batch: int, hkv: int, lq: int, lkv: int,
                 window: Optional[int], n_sms: int) -> Tuple[int, int, int]:
    """The decode path's cut of the kv axis: ``(begin, chunk_keys,
    n_chunks)``, chunk ``c`` covering keys ``[begin + c * chunk_keys, +
    chunk_keys)``.  Only the band the rows may see is cut (a window moves
    ``begin`` up, to a whole tile), into whole 64-key tiles, in as many
    chunks as give about ``DECODE_BLOCKS_PER_SM`` blocks per SM over the
    ``batch x hkv`` rows of kv heads, at least one tile each."""
    begin = max(0, lkv - lq - window + 1) if window else 0
    begin -= begin % DECODE_TILE
    tiles = max(1, -(-(lkv - begin) // DECODE_TILE))
    n = max(1, min(tiles, DECODE_BLOCKS_PER_SM * n_sms // (batch * hkv)))
    per = -(-tiles // n)
    return begin, per * DECODE_TILE, -(-tiles // per)


def _strides(name: str, x: torch.Tensor) -> Tuple[int, int, int]:
    """The batch, head and position strides of a ``(B, H, L, D)`` operand,
    checked for what the kernel's 16-byte loads need: a contiguous feature
    axis, an aligned base and strides of whole 16-byte chunks (a stride of
    a size-1 axis is never used, and passed as 0)."""
    st, shape = x.stride(), x.shape
    if st[3] != 1:
        raise ValueError(f"{name} must have a contiguous last axis, got strides "
                         f"{st}")
    strides = (st[0] if shape[0] > 1 else 0, st[1] if shape[1] > 1 else 0,
               st[2] if shape[2] > 1 else 0)
    if x.data_ptr() % 16 or (strides[0] | strides[1] | strides[2]) % (
            16 // x.element_size()):
        raise ValueError(f"{name} must start on 16 bytes with strides in whole "
                         f"16-byte chunks, got strides {st}")
    return strides


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    path: Optional[str] = None,
) -> torch.Tensor:
    """Fused attention forward on the card: the contract of
    ``ref_attention``.

    q ``(B, Hq, Lq, D)``, k and v ``(B, Hkv, Lkv, D)``, all bfloat16 or all
    float32, ``D`` in :data:`HEAD_DIMS`; any batch, head and position
    strides (a cut of a longer KV cache is read in place).  Returns q's type
    in a ``(B, Hq, Lq, D)`` view of ``(B, Lq, Hq, D)`` memory, so that the
    caller's merge of the heads, ``o.transpose(1, 2).reshape(B, Lq, Hq *
    D)``, copies nothing.  Launches on the current stream and does not
    synchronize.  ``path`` (bfloat16 only) overrides :func:`attention_path`
    with ``"prefill"`` or ``"decode"``, to time one path against the other.
    """
    global LAUNCHES
    if not q.is_cuda:
        raise ValueError(
            f"flash_attention_cuda runs on CUDA tensors, got q on {q.device}; "
            "the plain version for the CPU is kernels.ref.ref_attention")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, Hq, Lq, D) and k, v (B, Hkv, Lkv, D) expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}: "
                         "same B and D, and Hq a multiple of Hkv")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q {q.dtype} on "
                             f"{q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"attention kernel takes bfloat16 or float32, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} not among the kernel's {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if max(b, hq, lq, lkv) >= 2 ** 31 or b >= 2 ** 16 or hq >= 2 ** 16:
        raise ValueError(f"shape {tuple(q.shape)} / {tuple(k.shape)} beyond the "
                         "kernel's grid")
    auto = attention_path(q, k)
    if path is not None and (auto == "f32" or path not in ("prefill", "decode")
                             or (path == "decode" and auto != "decode")):
        raise ValueError(f"path {path!r} cannot take {q.dtype} q {tuple(q.shape)} "
                         f"with {hkv} kv heads (the decode tile holds "
                         f"{DECODE_ROWS} rows)")
    path = path or auto
    scale = d ** -0.5 if scale is None else float(scale)
    window = None if window is None else min(int(window), 2 ** 31 - 1)
    out = torch.empty(b, lq, hq, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(  # out's are those of (B, Lq, Hq, D) memory
        *_strides("q", q), *_strides("k", k), *_strides("v", v),
        lq * hq * d if b > 1 else 0, d if hq > 1 else 0, hq * d if lq > 1 else 0)
    part, split = None, (0, 0, 0)
    if path == "decode":
        split = decode_split(b, hkv, lq, lkv, window, _sm_count(q.device))
        part = torch.empty(split[2] * hkv * b * DECODE_ROWS * (d + 2),
                           dtype=torch.float32, device=q.device)
    with _on_device(q.device):
        err = _bind()(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), strides, b, hq, hkv, lq, lkv, d, int(causal),
            window or 0, scale, None if part is None else part.data_ptr(),
            *split, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err < 0:
        raise RuntimeError(f"attention kernel: a tensor map did not encode, "
                           f"CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


class FlashAttention(torch.autograd.Function):
    """``flash_attention_cuda`` forward, ``ref.ref_attention``'s autograd
    backward: ``FlashAttention.apply(q, k, v, causal, window, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.attrs = (causal, window, scale)
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    scale=scale)

    @staticmethod
    def backward(ctx, g):
        causal, window, scale = ctx.attrs
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.ref_attention(q, k, v, causal=causal, window=window,
                                    scale=scale)
        return (*torch.autograd.grad(out, (q, k, v), g), None, None, None)
