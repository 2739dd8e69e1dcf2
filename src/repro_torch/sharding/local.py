"""The kernels on local shards: each hand-written kernel sees this rank's
piece of a DTensor through ``local_map``, as the reference's Pallas calls
see a device's block under GSPMD.

* :func:`attention_heads` — flash attention over this rank's batch rows and
  query heads.  A query head keeps its key/value head across the split:
  where the key/value heads shard like the query heads the kernel takes the
  local heads as they are; where they cannot (fewer key/value heads than
  ranks, as paligemma's one) they stay whole and each rank picks the ones
  its query heads read, by its own head offset; their gradient is then
  summed over the ranks that split the query heads (each read a part).
  Row tensors beside them (the decode's validity mask) reach the function
  as this rank's rows.
* :func:`ssd_heads` — the SSD scan over this rank's batch rows and heads
  (groups of ``B``/``C`` picked the same way); :func:`ssd_step_heads` its
  decode step, placed as the cached state.
* :func:`counts_over_rows` — a count over index entries split as rows
  are (the MoE's expert loads), each rank's part summed.
* :func:`rowwise` — a function of whole rows (the int8 quantize and
  dequantize): any dim but the last may stay sharded.

A placement the call cannot honour (a dim split that does not divide) is
redistributed to ``Replicate`` first, never handed to the kernel.  On
import, DTensor's partial placements get hashes that are the same in
every process (:func:`_stable_placement_hashes`), so every rank breaks
DTensor's strategy ties alike.  Around
the model: :func:`replicating` runs an entry point under a re-entrant
:func:`implicit_replication` on the FSDP-gathered parameters
(:func:`gather_fsdp`; without autograd one stacked unit at a time,
:func:`gather_unit`), off the data axes where they do not split the
batch (:class:`_DataFree`).  torch 2.11's DTensor cannot flatten a split
head dim or ``index_add`` split indices, where torch 2.13's can: the
helpers above take such ops onto local shards (ROADMAP C26).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import torch


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _stable_placement_hashes() -> None:
    """Give DTensor's partial placements a hash that is the same in every
    process.  ``Partial`` hashes its reduce op's string, which Python
    salts per process, and DTensor's strategy search breaks ties between
    equal-cost strategies in the iteration order of sets of placements:
    ranks with different salts can choose different strategies for one op
    (a redistribution of one operand on one rank, of the other on another)
    and wait on each other's collectives (ROADMAP C16, C21).  Done when
    this module is imported, before any placement is hashed."""

    import zlib

    from torch.distributed.tensor import placement_types as pt

    def digest(*parts) -> int:
        return zlib.crc32(repr(parts).encode())

    pt.Partial.__hash__ = lambda self: 1 + digest(self.reduce_op)
    masked = getattr(pt, "MaskPartial", None) or getattr(pt, "_MaskPartial", None)
    if masked is not None:
        masked.__hash__ = lambda self: 1 + digest(self.reduce_op, tuple(self.offset_shape or ()),
                                                  self.offset_dim)


_stable_placement_hashes()


def shard_range(placements, mesh, dim: int, size: int) -> tuple[int, int]:
    """(offset, count) of this rank's slice of tensor dim ``dim`` of length
    ``size`` under ``placements`` (nested chunks, in mesh-dim order)."""

    off = 0
    for i, pl in enumerate(placements):
        if pl.is_shard(dim):
            size //= mesh.size(i)
            off += mesh.get_local_rank(i) * size
    return off, size


def _pick(x: torch.Tensor, dim: int, needed: list[int]) -> torch.Tensor:
    """The entries ``needed`` (ascending, with repeats) of dim ``dim``: a
    narrow when they are a run of distinct heads each repeated equally,
    else a gather of one per query head."""

    first, distinct = needed[0], sorted(set(needed))
    rep = len(needed) // len(distinct)
    if distinct == list(range(first, first + len(distinct))) and \
            needed == [h for h in distinct for _ in range(rep)]:
        return x.narrow(dim, first, len(distinct))
    return x.index_select(dim, torch.tensor(needed, device=x.device))


def _native(needed: list[int], groups: int) -> bool:
    """The kernel's own mapping (query head ``j`` reads group ``j //
    (heads / groups)``) already gives each local head the group it
    needs."""

    n = len(needed)
    return n % groups == 0 and needed == [j // (n // groups) for j in range(n)]


def _grouped_placements(x, heads_dim: int, n_heads: int, groups: int):
    """Per mesh dim: the query-side placement (batch rows ``Shard(0)`` and
    heads ``Shard(heads_dim)`` kept where they divide, else ``Replicate``)
    and the group side's (heads split only where the groups divide too)."""

    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    qp, gp = [], []
    for i, pl in enumerate(x.placements):
        n = mesh.size(i)
        if pl.is_shard(0) and x.shape[0] % n == 0:
            qp.append(Shard(0))
            gp.append(Shard(0))
        elif pl.is_shard(heads_dim) and n_heads % n == 0:
            qp.append(Shard(heads_dim))
            gp.append(Shard(heads_dim) if groups % n == 0 else Replicate())
        else:
            qp.append(Replicate())
            gp.append(Replicate())
    return tuple(qp), tuple(gp)


def _local_groups(mesh, qp, gp, heads_dim, n_heads, groups):
    """The group indices (into the local group shard) that this rank's
    query heads read, head by head."""

    q_off, q_n = shard_range(qp, mesh, heads_dim, n_heads)
    g_off, _ = shard_range(gp, mesh, heads_dim, groups)
    per = n_heads // groups
    return [(q_off + j) // per - g_off for j in range(q_n)]


class _SummedGradient(torch.autograd.Function):
    """The identity on a local tensor every rank of ``groups`` holds whole
    (a ``Replicate`` input of ``local_map``) but reads only in part (the
    groups its query heads read): the backward sums the parts' gradients
    over ``groups``, so each rank returns the whole gradient its
    placement says it holds."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


def _read_in_part(mesh, qp, gp, heads_dim) -> list:
    """The process groups of the mesh dims that split the query's heads
    but not the groups'."""

    return [mesh.get_group(i) for i, (a, b) in enumerate(zip(qp, gp))
            if a.is_shard(heads_dim) and not b.is_shard(heads_dim) and mesh.size(i) > 1]


def attention_heads(fn, q, k, v, *rows):
    """``fn(q, k, v, *rows)`` (B, S, H, D) attention on local shards; the
    output is placed as the query.  Each of ``rows`` (a mask, say) has the
    batch rows on dim 0 and reaches ``fn`` as this rank's rows: a DTensor
    through its placement, a plain tensor sliced here."""

    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    h, hk = q.shape[2], k.shape[2]
    qp, kp = _grouped_placements(q, 2, h, hk)
    needed = _local_groups(mesh, qp, kp, 2, h, hk)
    partly = _read_in_part(mesh, qp, kp, 2)
    rp = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in qp)
    off, n = shard_range(qp, mesh, 0, q.shape[0])

    def body(ql, kl, vl, *rl):
        if partly and torch.is_grad_enabled():
            kl, vl = _SummedGradient.apply(kl, partly), _SummedGradient.apply(vl, partly)
        if not _native(needed, kl.shape[2]):
            kl, vl = _pick(kl, 2, needed), _pick(vl, 2, needed)
        rl = [r if is_dtensor(w) else r[off:off + n] for r, w in zip(rl, rows)]
        return fn(ql, kl, vl, *rl)

    in_pl = (qp, kp, kp) + tuple(rp if is_dtensor(r) else None for r in rows)
    return local_map(body, out_placements=list(qp), in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v, *rows)


def ssd_step_heads(fn, state, x, dt, A, B, C):
    """``fn(state, x, dt, A, B, C)`` (one SSD decode step: state (b, h, p,
    n), x (b, h, p), dt (b, h), A (h,), B/C (b, g, n)) on local shards,
    placed as the state (the cache's layout): batch rows on dim 0, heads on
    dim 1; y is placed so too."""

    from torch.distributed.tensor import Replicate, Shard

    mesh = state.device_mesh
    h, g = state.shape[1], B.shape[1]
    sp, bp = _grouped_placements(state, 1, h, g)
    ap = tuple(Shard(0) if pl.is_shard(1) else Replicate() for pl in sp)
    needed = _local_groups(mesh, sp, bp, 1, h, g)

    def body(sl, xl, dtl, Al, Bl, Cl):
        if not _native(needed, Bl.shape[1]):
            Bl, Cl = _pick(Bl, 1, needed), _pick(Cl, 1, needed)
        return fn(sl, xl, dtl, Al, Bl, Cl)

    return local_map(body, out_placements=(list(sp), list(sp)),
                     in_placements=(sp, sp, sp, ap, bp, bp),
                     device_mesh=mesh, redistribute_inputs=True)(state, x, dt, A, B, C)


def counts_over_rows(fn, idx):
    """``fn(idx)``, a count over the entries of ``idx`` (an index tensor
    whose entries are split as rows are), summed over the ranks that split
    them: each rank counts its own entries, and the sum of the parts is the
    whole's count.  Exact for counts an fp32 holds."""

    from torch.distributed.tensor import Partial, Replicate

    pl = _row_placements(idx) if idx.dim() > 1 else tuple(
        p if p.is_shard(0) else Replicate() for p in idx.placements)
    out = [Partial() if p.is_shard() else Replicate() for p in pl]
    summed = local_map(fn, out_placements=out, in_placements=(pl,),
                       device_mesh=idx.device_mesh, redistribute_inputs=True)(idx)
    return summed.redistribute(idx.device_mesh, [Replicate()] * len(out))


def ssd_heads(fn, x, dt, A, B, C, *, with_state: bool):
    """``fn(x, dt, A, B, C)`` (the SSD scan: x (b, l, h, p), dt (b, l, h),
    A (h,), B/C (b, l, g, n)) on local shards; y is placed as x, the final
    state (b, h, p, n) with heads on dim 1."""

    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    h, g = x.shape[2], B.shape[2]
    xp, bp = _grouped_placements(x, 2, h, g)
    ap = tuple(Shard(0) if pl.is_shard(2) else Replicate() for pl in xp)
    sp = tuple(Shard(1) if pl.is_shard(2) else pl for pl in xp)
    needed = _local_groups(mesh, xp, bp, 2, h, g)
    partly = _read_in_part(mesh, xp, bp, 2)

    def body(xl, dtl, Al, Bl, Cl):
        if partly and torch.is_grad_enabled():
            Bl, Cl = _SummedGradient.apply(Bl, partly), _SummedGradient.apply(Cl, partly)
        if not _native(needed, Bl.shape[2]):
            Bl, Cl = _pick(Bl, 2, needed), _pick(Cl, 2, needed)
        return fn(xl, dtl, Al, Bl, Cl)

    out = (list(xp), list(sp)) if with_state else list(xp)
    return local_map(body, out_placements=out, in_placements=(xp, xp, ap, bp, bp),
                     device_mesh=mesh, redistribute_inputs=True)(x, dt, A, B, C)


def _row_placements(x):
    from torch.distributed.tensor import Replicate, Shard

    mesh, nd = x.device_mesh, x.dim()
    out = []
    for i, pl in enumerate(x.placements):
        keep = pl.is_shard() and pl.dim < nd - 1 and x.shape[pl.dim] % mesh.size(i) == 0
        out.append(Shard(pl.dim) if keep else Replicate())
    return tuple(out)


def rowwise(fn, x, *rest, n_out: int):
    """``fn(x, *rest)`` of whole rows of the last dim: ``x`` and every
    tensor of ``rest`` (the same leading dims) keep their shards on the
    leading dims; each of the ``n_out`` outputs is placed as ``x``."""

    pl = _row_placements(x)
    out = list(pl) if n_out == 1 else (list(pl),) * n_out
    return local_map(fn, out_placements=out, in_placements=(pl,) * (1 + len(rest)),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x, *rest)


def local_map(fn, **kw):
    """``torch.distributed.tensor.experimental.local_map``, imported at the
    call.  A single output's placements are a list (a tuple stands for one
    placement sequence per output)."""

    from torch.distributed.tensor.experimental import local_map as _local_map

    return _local_map(fn, **kw)


@contextlib.contextmanager
def implicit_replication():
    """``torch.distributed.tensor.experimental.implicit_replication``, made
    re-entrant: a plain tensor meeting a DTensor (positions, masks, the
    MoE's indices) counts as replicated.  Entered around every model entry
    point and the trainer's backward; nesting keeps it on until the
    outermost exit."""

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication as _on

    if DTensor._op_dispatcher._allow_implicit_replication:
        yield
        return
    with _on():
        yield


#: the ParallelConfig of the inference entry point whose stacked units are
#: gathered one at a time (:func:`gather_unit`), else None
_UNIT_GATHER: contextvars.ContextVar = contextvars.ContextVar("unit_gather", default=None)


def gather_fsdp(params, pcfg, *, units: bool = True):
    """The FSDP gather: every DTensor leaf with its data-axis shards made
    whole (``redistribute``; a leaf split only over ``model`` is returned
    as it is).  Under autograd the gather's backward is the reduce-scatter
    of the gradient over the data axes.  ``units=False`` leaves the
    stacked unit trees (``rules._STACKED``) as they are, for
    :func:`gather_unit` to gather one unit at a time."""

    from torch.distributed.tensor import Replicate

    from repro_torch.core.futures import flatten, unflatten
    from repro_torch.sharding.rules import _STACKED

    if not units and isinstance(params, dict):
        return {k: v if k in _STACKED else gather_fsdp(v, pcfg) for k, v in params.items()}
    leaves, treedef = flatten(params)
    if not leaves or not is_dtensor(leaves[0]):
        return params
    data = set(pcfg.data_axes)
    out = []
    for leaf in leaves:
        names = leaf.device_mesh.mesh_dim_names
        pl = [Replicate() if names[i] in data and p.is_shard() else p
              for i, p in enumerate(leaf.placements)]
        out.append(leaf if pl == list(leaf.placements) else
                   leaf.redistribute(leaf.device_mesh, pl))
    return unflatten(treedef, out)


def gather_unit(unit):
    """One unit of a stacked parameter tree, FSDP-gathered when an
    inference entry point (:func:`replicating` with autograd off) left the
    stacked trees placed: a step then holds one unit's gathered weights at
    a time, not the whole model's (ROADMAP C27).  The values are the whole
    gather's, sliced.  Otherwise ``unit`` as it is."""

    pcfg = _UNIT_GATHER.get()
    return unit if pcfg is None else gather_fsdp(unit, pcfg)


def rows_split(rows: int, device_mesh, pcfg) -> bool:
    """Whether the data axes of ``device_mesh`` split a batch of ``rows``
    rows (as the reference's ``batch_spec`` keeps the mapping)."""

    shape = dict(zip(device_mesh.mesh_dim_names, device_mesh.mesh.shape))
    return rows % math.prod(int(shape.get(a, 1)) for a in pcfg.data_axes) == 0


class _DataFree:
    """The view of a placed call whose batch the data axes do not split:
    the reference replicates that batch, so every data rank computes the
    same values, and the call runs on the submesh of the other axes (plain
    tensors where none is left), each leaf replicated over the data axes.

    A mesh axis on which every operand of an op is replicated gives
    DTensor's strategy search free moves: it may split the op's
    contraction over that axis, and it breaks ties between equal-cost
    moves in the iteration order of a set of placements, whose hash
    (``Partial("sum")``'s string) differs from process to process.  Ranks
    then issue different collectives: on three gloo ranks serving two rows
    placed on a 3 x 1 mesh, one rank all-gathered an uneven split that
    another never sent.  Without the data axes in the mesh the search has
    no such move to make."""

    def __init__(self, device_mesh, pcfg):
        from torch.distributed.tensor import Replicate

        self.mesh = device_mesh
        names = tuple(device_mesh.mesh_dim_names)
        self.data = [n in pcfg.data_axes for n in names]
        keep = tuple(n for n, d in zip(names, self.data) if not d)
        self.sub = device_mesh[keep] if keep else None
        if self.sub is not None:
            # a submesh equals its parent's kin only (core/communicator.py's
            # device_mesh: an epoch's meshes equal no one else's)
            self.sub._thread_id = device_mesh._thread_id
        self._rep = Replicate()

    def onto(self, tree):
        from torch.distributed.tensor import DTensor

        from repro_torch.core.futures import flatten, unflatten

        def view(leaf):
            if not is_dtensor(leaf) or leaf.device_mesh != self.mesh:
                return leaf
            pl = [self._rep if d else p for p, d in zip(leaf.placements, self.data)]
            if pl != list(leaf.placements):
                leaf = leaf.redistribute(self.mesh, pl)
            local = leaf.to_local()
            if self.sub is None:
                return local
            return DTensor.from_local(local, self.sub,
                                      [p for p, d in zip(pl, self.data) if not d],
                                      run_check=False, shape=leaf.shape, stride=leaf.stride())

        leaves, treedef = flatten(tree)
        return unflatten(treedef, [view(x) for x in leaves])

    def back(self, tree):
        from torch.distributed.tensor import DTensor

        from repro_torch.core.futures import flatten, unflatten

        def place(leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            placed = is_dtensor(leaf)
            rest = iter(leaf.placements if placed else ())
            pl = [self._rep if d else next(rest, self._rep) for d in self.data]
            return DTensor.from_local(leaf.to_local() if placed else leaf, self.mesh, pl,
                                      run_check=False, shape=leaf.shape, stride=leaf.stride())

        leaves, treedef = flatten(tree)
        return unflatten(treedef, [place(x) for x in leaves])


def _rows(node) -> int | None:
    """The leading dim of the first tensor of ``node`` (the batch's rows)."""

    from repro_torch.core.futures import flatten

    for leaf in flatten(node)[0]:
        if isinstance(leaf, torch.Tensor) and leaf.dim() > 0:
            return int(leaf.shape[0])
    return None


def replicating(fn, pcfg_at: int):
    """``fn(params, *args)``, whose ``args[pcfg_at]`` is the
    ``ParallelConfig`` and ``args[pcfg_at - 1]`` the batch (or the decode's
    token), run under :func:`implicit_replication` on the FSDP-gathered
    parameters (:func:`gather_fsdp`: whole over the data axes for the call,
    as GSPMD gathers an FSDP weight before its use).  A batch the data
    axes do not split runs off them (:class:`_DataFree`), its outputs
    placed back on the whole mesh, replicated over the data axes."""

    @functools.wraps(fn)
    def run(params, *args, **kwargs):
        pcfg = args[pcfg_at]
        # without autograd (serving) the stacked units are gathered one at
        # a time as the layers run (gather_unit); under autograd the whole
        # model at once, its backward one reduce-scatter a leaf
        lazy = not torch.is_grad_enabled()
        with implicit_replication():
            first = _first_dtensor(params)
            rows = _rows(args[pcfg_at - 1])
            if first is None or rows is None or rows_split(rows, first.device_mesh, pcfg):
                token = _UNIT_GATHER.set(pcfg if lazy else None)
                try:
                    return fn(gather_fsdp(params, pcfg, units=not lazy), *args, **kwargs)
                finally:
                    _UNIT_GATHER.reset(token)
            params = gather_fsdp(params, pcfg)
            view = _DataFree(first.device_mesh, pcfg)
            args = tuple(a if i == pcfg_at else view.onto(a) for i, a in enumerate(args))
            return view.back(fn(view.onto(params), *args, **kwargs))

    return run


def _first_dtensor(tree):
    """The first leaf of a placed tree, else ``None``."""

    from repro_torch.core.futures import flatten

    leaves = flatten(tree)[0]
    return leaves[0] if leaves and is_dtensor(leaves[0]) else None
