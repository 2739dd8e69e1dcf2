"""Public wrapper for flash attention.

``flash_attention`` dispatches on where the tensors lie, not on ``impl``:
a CUDA tensor always launches the hand-written kernel (``kernel.py``), a CPU
tensor takes the plain version (``ref.mha``, or ``ref.chunked_mha`` for
``impl="chunked"``).  There is no fallback: a build or launch failure
raises.  On the card the call is a ``torch.autograd.Function`` whose
backward recomputes through ``ref.mha`` — the recompute backward of the
reference's ``custom_vjp`` (no O(S²) residuals are kept).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window, prefix_len, logit_softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, sliding_window=sliding_window, prefix_len=prefix_len,
                      logit_softcap=logit_softcap, scale=scale)
        return _kernel.flash_attention_fwd(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = _ref.mha(*leaves, **ctx.kw)
        grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: int | None = None,
    prefix_len: int | None = None,
    logit_softcap: float | None = None,
    scale: float | None = None,
    impl: str = "ref",
    q_block_axis: str | None = None,
) -> torch.Tensor:
    """Public API, the reference's signature.  ``impl`` chooses the plain
    version on the CPU ('chunked' → online-softmax loops, anything else →
    ``mha``); on the card the kernel runs whatever it says.
    ``q_block_axis`` (the ``sp`` plan) names a mesh axis over which the
    chunked form's query blocks are placed when ``q`` is a DTensor, as the
    reference constrains them; the kernel takes whole local tensors."""

    if q.is_cuda:
        return _Flash.apply(q, k, v, causal, sliding_window, prefix_len, logit_softcap, scale)
    kw = dict(causal=causal, sliding_window=sliding_window, prefix_len=prefix_len,
              logit_softcap=logit_softcap, scale=scale)
    if impl == "chunked":
        return _ref.chunked_mha(q, k, v, q_block_axis=q_block_axis, **kw)
    return _ref.mha(q, k, v, **kw)
