"""Global-norm gradient clipping — :mod:`repro.optim.clip` over nests of
tensors.

A leaf is read in pieces of at most :data:`PIECE` elements, so that its
fp32 temporaries stay small beside a model's state on the card (a stacked
bf16 leaf of phi4-mini is 1.6 G elements: 6.4 GB a temporary in fp32).
The scaling is elementwise, so pieces change nothing in it; the norm sums
each piece's squares, then the pieces.

A DTensor leaf (placed state, :mod:`repro_torch.sharding`) counts over the
whole tensor: each rank sums its own shard's squares the same way, the
sums add over the mesh dims that split the leaf (a replicated dim counts
once), and the scaling runs on the local shard in place.
"""

from __future__ import annotations

import torch

from repro_torch.core.futures import flatten
from repro_torch.sharding.local import is_dtensor

#: The most elements of one leaf that one fp32 temporary holds.
PIECE = 1 << 26


def pieces(t: torch.Tensor, n: int = PIECE) -> list[torch.Tensor]:
    """Flat views of ``t`` (contiguous) of at most ``n`` elements each."""

    flat = t.view(-1)
    return [flat[i:i + n] for i in range(0, flat.numel(), n)] or [flat]


def _square_sum(leaf: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.stack([torch.sum(torch.square(p.float())) for p in pieces(
        leaf.contiguous())]))


def _leaf_square_sum(leaf: torch.Tensor) -> torch.Tensor:
    """The whole leaf's sum of squares; a DTensor's as a plain tensor."""

    if not is_dtensor(leaf):
        return _square_sum(leaf)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    part = [Partial() if pl.is_shard() else Replicate() for pl in leaf.placements]
    local = _square_sum(leaf.to_local())
    return DTensor.from_local(local, leaf.device_mesh, part, run_check=False).full_tensor()


def global_norm(tree) -> torch.Tensor:
    leaves = [_leaf_square_sum(leaf) for leaf in flatten(tree)[0]]
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
        g = g.to_local() if is_dtensor(g) else g
        for p in pieces(g) if g.is_contiguous() else [g]:
            p.copy_((p.float() * scale).to(p.dtype))
    return tree, norm
