"""Public wrapper for the SSD scan.

``ssd_scan`` dispatches on where the tensors lie, not on ``impl``: a CUDA
tensor always launches the hand-written kernel (``kernel.py``), a CPU tensor
takes the plain chunked form (``ref.ssd_chunked``).  There is no fallback: a
build or launch failure raises.  On the card the call is a
``torch.autograd.Function`` whose backward recomputes through
``ref.ssd_chunked`` — the recompute backward of the reference's
``custom_vjp`` (SSD residuals are O(L·state); recompute keeps memory at
activations only).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import kernel as _kernel
from repro_torch.kernels.ssd_scan import ref as _ref


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk, return_state):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _kernel.ssd_scan_fwd(x, dt, A, B, C, chunk=chunk, return_state=return_state)

    @staticmethod
    def backward(ctx, g_y, g_state=None):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in inputs]
            y, state = _ref.ssd_chunked(*leaves, chunk=ctx.chunk)
        outs, grads = [y], [g_y]
        if g_state is not None:
            outs.append(state)
            grads.append(g_state)
        return (*torch.autograd.grad(outs, leaves, grads), None, None)


def _scan(x, dt, A, B, C, chunk, return_state):
    if x.is_cuda:
        return _SSDScan.apply(x, dt.float(), A.float(), B, C, chunk, return_state)
    y, state = _ref.ssd_chunked(x, dt, A, B, C, chunk=chunk)
    return (y, state) if return_state else y


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128, impl: str = "ref"):
    """y = SSD(x, dt, A, B, C); shapes as in :mod:`.ref`.  ``impl`` names
    the reference's implementation; the port picks by device and ignores
    it."""

    return _scan(x, dt, A, B, C, chunk, False)


def ssd_scan_with_state(x, dt, A, B, C, *, chunk: int = 128):
    """(y, final fp32 state (b, h, p, n)) from a zero state: one kernel
    launch on the card, ``ref.ssd_chunked`` on the CPU."""

    return _scan(x, dt, A, B, C, chunk, True)


ssd_decode_step = _ref.ssd_decode_step
