"""Shared model components: norms, RoPE, initialisers, activation helpers.

Numerics follow :mod:`repro.models.common` exactly: ``rms_norm`` scales by
``1 + scale`` in fp32 (the scale is stored as zeros, gemma-style), RoPE
splits the head dimension into halves with fp32 angles, and ``"gelu"`` is
the tanh form (``jax.nn.gelu`` defaults to ``approximate=True``).

The reference's ``key_iter`` (an endless stream of ``jax.random.split``
keys) has no counterpart (ROADMAP A16): the port draws from one seeded
``torch.Generator`` that each initialiser advances in turn, which is the
stream ``key_iter`` stands for in JAX's stateless random numbers.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

Params = dict[str, Any]

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# -- init ----------------------------------------------------------------------


def _draw(gen: torch.Generator, shape, stddev: float) -> torch.Tensor:
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if is_fake(x):
        # a shape stand-in (``models/api.param_structs``): the truncation's
        # redraw loop reads values, which a fake tensor has none of
        return x
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return x.mul_(stddev)


def _truncated_normal(gen: torch.Generator, shape, stddev: float, dtype,
                      stacked: bool = False) -> torch.Tensor:
    """A truncated normal in ``dtype``.  A ``stacked`` leaf is drawn one unit
    slice of its leading dim at a time, straight into its buffer, so the
    fp32 draw never holds more than one layer: a whole stack in fp32 would
    not fit the card beside the weights of the larger models."""

    if not stacked:
        return _draw(gen, shape, stddev).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for unit in out:
        unit.copy_(_draw(gen, unit.shape, stddev))
    return out


def trunc_normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    stddev = scale / math.sqrt(max(1, shape[0] if len(shape) else 1))
    return _truncated_normal(gen, shape, stddev, dtype)


def dense_init(gen: torch.Generator, in_dim: int, shape: tuple[int, ...], dtype, *,
               stacked: bool = False) -> torch.Tensor:
    """``shape`` is the leaf's whole shape; ``stacked`` says that its leading
    dim is a stack of units (layers), drawn one at a time."""

    return _truncated_normal(gen, shape, 1.0 / math.sqrt(in_dim), dtype, stacked)


def split_dim(x: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``x.unflatten(dim, sizes)`` as a reshape to the whole shape, which
    DTensor's view propagation carries over a dim split on its leading
    part (heads sharded on ``model``); ``unflatten`` checks the sizes
    against the local shard."""

    dim = dim % x.dim()
    sizes = tuple(sizes)
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes = tuple(x.shape[dim] // known if s == -1 else s for s in sizes)
    return x.reshape(tuple(x.shape[:dim]) + sizes + tuple(x.shape[dim + 1:]))


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``table[tokens]`` by ``F.embedding``, whose backward (and its
    DTensor strategy over a vocabulary split on ``model``) is the
    embedding's own rather than an indexed accumulate.  Over a split
    vocabulary the rows come out as a masked partial sum, reduced here to
    whole rows: DTensor cannot redistribute such a partial onto a batch
    split."""

    x = F.embedding(tokens, table)
    from repro_torch.sharding.local import is_dtensor

    if is_dtensor(x) and any(p.is_partial() for p in x.placements):
        x = _WholeGradient.apply(_reduced(x))
    return x


def _reduced(x):
    """A DTensor with its pending sums (partial placements) done."""

    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


class _WholeGradient(torch.autograd.Function):
    """The identity, whose backward completes a pending sum in the
    gradient: the gradient of the reduced embedding rows can come back as
    a partial sum (over four model ranks it does), which DTensor cannot
    carry back to the lookup's masked partial."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.sharding.local import is_dtensor

        return _reduced(g) if is_dtensor(g) else g


# -- norms -----------------------------------------------------------------------


def init_rmsnorm(d: int, dtype, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)  # stored as (scale - 1)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


# -- activations --------------------------------------------------------------------


def activation(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# -- rotary embeddings -----------------------------------------------------------------


def rope(
    x: torch.Tensor, positions: torch.Tensor, *, theta: float, rope_dim: int | None = None
) -> torch.Tensor:
    """Apply rotary embedding.  x: (..., seq, heads, head_dim); positions:
    broadcastable to (..., seq).  ``rope_dim`` rotates only the first
    ``rope_dim`` features (partial RoPE)."""

    d = x.shape[-1]
    rd = rope_dim or d
    half = rd // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # a fill kernel, not a host-to-device copy, which CUDA graph capture refuses
    base = torch.full((), theta, dtype=torch.float32, device=x.device)
    freqs = torch.pow(base, exponent)
    angles = positions[..., None].float() * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    xr, rest = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., :half], xr[..., half:]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    out = torch.cat([out1, out2], dim=-1).to(x.dtype)
    if rest.shape[-1]:
        out = torch.cat([out, rest], dim=-1)
    return out


def pin(x: torch.Tensor, dims: tuple, pcfg) -> torch.Tensor:
    """Constrain a DTensor's placement: the reference's
    ``with_sharding_constraint`` as a ``redistribute``.  ``dims`` entries:
    ``'data'`` (the ParallelConfig data axes), ``'model'``, ``'experts'``
    (the model axis iff ``shard_experts``) or ``None``; a mesh axis appears
    once, a dim that does not divide (or an axis of one) stays replicated,
    and every mesh dim not named is replicated.  The identity on a plain
    tensor, or when nothing would be sharded."""

    from repro_torch.sharding.local import is_dtensor

    if pcfg is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    shape = dict(zip(names, mesh.mesh.shape))
    table = {
        "data": tuple(a for a in pcfg.data_axes if a in shape) or None,
        "model": pcfg.model_axis if pcfg.model_axis in shape else None,
        "experts": pcfg.model_axis if pcfg.shard_experts and pcfg.model_axis in shape else None,
    }
    out: list = [Replicate()] * len(names)
    used: set = set()
    any_axis = False
    for dim, (size, name) in enumerate(zip(x.shape, dims)):
        axes = table.get(name) if name else None
        if axes is None:
            continue
        group = (axes,) if isinstance(axes, str) else axes
        n = math.prod(int(shape[a]) for a in group)
        if used & set(group) or n <= 1 or size % n:
            continue
        used |= set(group)
        any_axis = True
        for a in group:
            out[names.index(a)] = Shard(dim)
    if not any_axis:
        return x
    return x.redistribute(mesh, out)


def constrain(x: torch.Tensor, pcfg, *, logits: bool = False) -> torch.Tensor:
    """Pin activation sharding: batch over the data axes, last dim over
    'model' for logits; everything else replicated.  The identity on plain
    tensors or when no dim divides."""

    dims = ("data",) + (None,) * (x.dim() - 2) + ("model" if logits else None,)
    return pin(x, dims[: x.dim()], pcfg)


# -- losses -------------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *, softcap_val=None) -> torch.Tensor:
    """Token-mean CE in fp32; logits (..., V), labels (...)."""

    logits = logits.float()
    if softcap_val is not None:
        logits = softcap(logits, softcap_val)
    if _vocab_split(logits):
        return torch.mean(_vocab_parallel_token_ce(logits, labels))
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    # the gathered column keeps its trailing dim: over a vocabulary sharded
    # on ``model`` the gather is a masked partial, which a view cannot drop
    gold = torch.gather(logits, -1, labels[..., None].long())
    return torch.mean(logz - gold)


def _vocab_split(logits) -> list[int]:
    """The mesh dims over which a DTensor's vocabulary (its last dim) is
    split across more than one rank; none for a plain tensor."""

    from repro_torch.sharding.local import is_dtensor

    if not is_dtensor(logits):
        return []
    last, dm = logits.dim() - 1, logits.device_mesh
    return [i for i, p in enumerate(logits.placements) if p.is_shard(last) and dm.size(i) > 1]


class _SumOver(torch.autograd.Function):
    """A local partial summed over process groups; the result is the same
    on every rank of them, so its gradient reaches each partial as it is."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist

        x = x.clone()
        for g in groups:
            dist.all_reduce(x, group=g)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _vocab_parallel_token_ce(logits, labels):
    """Per-token CE of fp32 DTensor logits whose vocabulary is split over
    ``model`` (the tied embedding's placement), on local shards: the max,
    the sum of exponentials and the gold logit are reduced over the
    vocabulary's ranks, so no rank holds the whole (tokens, vocab) logits,
    which DTensor's ``logsumexp`` would gather.  The output (labels' shape)
    is placed as the logits' leading dims."""

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate

    from repro_torch.sharding import local

    dm, last = logits.device_mesh, logits.dim() - 1
    split = _vocab_split(logits)
    groups = [dm.get_group(i) for i in split]
    pl = tuple(p if p.is_shard() and (p.dim < last or i in split) else Replicate()
               for i, p in enumerate(logits.placements))
    token_pl = tuple(Replicate() if p.is_shard(last) else p for p in pl)
    off, _ = local.shard_range(pl, dm, last, logits.shape[-1])
    if not local.is_dtensor(labels):   # a plain tensor meeting DTensors is replicated
        from torch.distributed.tensor import DTensor

        labels = DTensor.from_local(labels, dm, [Replicate()] * dm.ndim, run_check=False)

    def body(lg, y):
        m = lg.detach().amax(-1, keepdim=True)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        z = _SumOver.apply(torch.exp(lg - m).sum(-1, keepdim=True), groups)
        col = y.long()[..., None] - off
        held = (col >= 0) & (col < lg.shape[-1])
        gold = torch.gather(lg, -1, col.clamp(0, lg.shape[-1] - 1))
        gold = _SumOver.apply(torch.where(held, gold, torch.zeros_like(gold)), groups)
        return (m + torch.log(z) - gold)[..., 0]

    return local.local_map(body, out_placements=list(token_pl), in_placements=(pl, token_pl),
                           device_mesh=dm, redistribute_inputs=True)(logits, labels)
