"""Global-norm gradient clipping — :mod:`repro.optim.clip` over nests of
tensors.

A leaf is read in pieces of at most :data:`PIECE` elements, so that its
fp32 temporaries stay small beside a model's state on the card (a stacked
bf16 leaf of phi4-mini is 1.6 G elements: 6.4 GB a temporary in fp32).
The scaling is elementwise, so pieces change nothing in it; the norm sums
each piece's squares, then the pieces.
"""

from __future__ import annotations

import torch

from repro_torch.core.futures import flatten

#: The most elements of one leaf that one fp32 temporary holds.
PIECE = 1 << 26


def pieces(t: torch.Tensor, n: int = PIECE) -> list[torch.Tensor]:
    """Flat views of ``t`` (contiguous) of at most ``n`` elements each."""

    flat = t.view(-1)
    return [flat[i:i + n] for i in range(0, flat.numel(), n)] or [flat]


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.stack([torch.sum(torch.square(p.float())) for p in pieces(
        leaf.contiguous())])) for leaf in flatten(tree)[0]]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Returns (clipped_tree, pre_clip_norm).

    The leaves are scaled **in place** and ``tree`` itself is returned: the
    train step owns its gradients (as the reference's donated step does),
    and a second tree of them would cost a model's worth of memory on the
    card.  Each leaf is scaled in fp32 and rounded once, as in the
    reference."""

    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in flatten(tree)[0]:
        for p in pieces(g) if g.is_contiguous() else [g]:
            p.copy_((p.float() * scale).to(p.dtype))
    return tree, norm
