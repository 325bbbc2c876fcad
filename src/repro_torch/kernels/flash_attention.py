"""The hand-written CUDA attention kernel and its wrapper.

Replaces the TPU kernel ``flash_attention_pallas``
(``repro/kernels/flash_attention.py:85``, body ``_fa_kernel`` at ``:33``):
FlashAttention-2's forward pass with GQA, a causal mask, a sliding window
and end alignment.  A sequential kv grid axis with VMEM scratch there, a kv
loop inside each block here, ``mma.sync`` on the tensor cores for bfloat16
and a CUDA-core loop for float32 (``csrc/flash_attention.cu`` says why and
what bounds it).  The plain version of the same contract is
:func:`repro_torch.kernels.ref.ref_attention`.

:func:`flash_attention_cuda` takes CUDA tensors only and raises on anything
else; the dispatch between kernel and plain version lives in
:mod:`repro_torch.kernels.ops`.  ``LAUNCHES`` counts the wrapper's kernel
launches, so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

__all__ = ["LAUNCHES", "HEAD_DIMS", "flash_attention_cuda"]

LAUNCHES = 0

HEAD_DIMS = (32, 64, 128)  # the head sizes the source instantiates
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind() -> ctypes.CDLL:
    fn = build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, ctypes.POINTER(ctypes.c_longlong),
                       i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _strides(name: str, x: torch.Tensor) -> list:
    """The batch, head and position strides of a ``(B, H, L, D)`` operand,
    checked for what the kernel's 16-byte loads need: a contiguous feature
    axis, an aligned base and strides of whole 16-byte chunks (a stride of
    a size-1 axis is never used, and passed as 0)."""
    if x.stride(3) != 1:
        raise ValueError(f"{name} must have a contiguous last axis, got strides "
                         f"{tuple(x.stride())}")
    chunk = 16 // x.element_size()
    strides = [x.stride(a) if x.shape[a] > 1 else 0 for a in range(3)]
    if x.data_ptr() % 16 or any(s % chunk for s in strides):
        raise ValueError(f"{name} must start on 16 bytes with strides in whole "
                         f"16-byte chunks, got strides {tuple(x.stride())}")
    return strides


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused attention forward on the card: the contract of
    ``ref_attention``.

    q ``(B, Hq, Lq, D)``, k and v ``(B, Hkv, Lkv, D)``, all bfloat16 or all
    float32, ``D`` in :data:`HEAD_DIMS`; any batch, head and position
    strides (a cut of a longer KV cache is read in place).  Returns q's type
    in a ``(B, Hq, Lq, D)`` view of ``(B, Lq, Hq, D)`` memory, so that the
    caller's merge of the heads, ``o.transpose(1, 2).reshape(B, Lq, Hq *
    D)``, copies nothing.  Launches on the current stream and does not
    synchronize.
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
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty(b, lq, hq, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *_strides("q", q), *_strides("k", k), *_strides("v", v),
        *_strides("out", out))
    with torch.cuda.device(q.device):
        err = _bind()(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), strides, b, hq, hkv, lq, lkv, d, int(causal),
            0 if window is None else min(int(window), 2 ** 31 - 1), scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
