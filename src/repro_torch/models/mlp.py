"""MLPs: the gated (SwiGLU/GeGLU) dense block and the mixture-of-experts
block of :mod:`repro.models.mlp` (top-k routing, shared experts,
capacity-bounded sort-based dispatch; the global and the per-row dispatch).

The dispatch is the reference's, made deterministic on the card, where a
scatter-add's atomics add in any order:

- ties: the router's top-k and the bucket sort are stable sorts, so tied
  probabilities pick the lower expert first (``jax.lax.top_k``) and the
  rows of one expert keep their order (``jnp.argsort``), which decides the
  rows that overflow capacity;
- dropped rows: the slot buffers carry one sink row past the ``e * c``
  slots, where overflowed rows are written and read (a zero row), and which
  is cut off: nothing is indexed past the end;
- the combine adds each token's k weighted rows in order ``j = 0 … k-1``
  in the model's dtype (the order of XLA's serial scatter-add on the CPU),
  not by ``index_add_``: the sum is the same bits every run, so a CUDA
  graph's decode equals the eager loop's and remat's recompute equals the
  forward;
- a row is repeated k times for the dispatch by ``expand``, whose backward
  sums the k gradients in a fixed order.

Everything is capturable in a CUDA graph: no ``.item()``, no
boolean-mask indexing, the capacity computed from static shapes.

The expert-parallel dispatch (:func:`moe_neighbor` over the router's expert
graph, :func:`expert_dispatch_graph`) moves token rows between the ranks
that own the experts with two ``neighbor_alltoallv`` rounds of a
:class:`~repro_torch.core.topology.DistGraphComm`; each rank calls it with
its own tokens and its own slice of the experts.

On DTensor parameters the dispatch's index math (the stable sort, the
slot of each row) runs on whole rows of each rank's batch shard through
``local_map``; :func:`_pin` is the reference's sharding constraint as a
``redistribute`` (:func:`repro_torch.models.common.pin`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import Replicate

from repro_torch.core import errors
from repro_torch.models import common
from repro_torch.models.common import dense_init
from repro_torch.sharding.local import is_dtensor, rowwise


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# dense gated MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, f: int, dtype, *, stack: tuple[int, ...] = ()) -> common.Params:
    """``stack`` prepends leading dims (the scanned unit stack)."""

    return {
        "w_gate": dense_init(gen, d, stack + (d, f), dtype, stacked=bool(stack)),
        "w_up": dense_init(gen, d, stack + (d, f), dtype, stacked=bool(stack)),
        "w_down": dense_init(gen, f, stack + (f, d), dtype, stacked=bool(stack)),
    }


def mlp(p: common.Params, x: torch.Tensor, act: str) -> torch.Tensor:
    a = common.activation(act)
    g = torch.matmul(x, p["w_gate"])
    u = torch.matmul(x, p["w_up"])
    return torch.matmul(a(g) * u, p["w_down"])


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------


def _pin(x: torch.Tensor, dims: tuple, pcfg) -> torch.Tensor:
    """Constrain a MoE-internal tensor's placement (the identity on a plain
    tensor or when no mapped dim divides).  ``dims`` entries: 'data' (the
    ParallelConfig data axes), 'model', 'experts' (model axis iff
    shard_experts), or None."""

    return common.pin(x, dims, pcfg)


def _dispatch_slots(bucket: torch.Tensor, e: int, c: int) -> torch.Tensor:
    """Each row's flat slot ``bucket * c + position in its bucket``, or
    ``e * c`` where the position reaches capacity; positions follow the
    rows' order within a bucket (a stable sort)."""

    if is_dtensor(bucket):
        return rowwise(lambda b: _dispatch_slots(b, e, c), bucket, n_out=1)
    n = bucket.shape[-1]
    order = torch.argsort(bucket, dim=-1, stable=True)
    sorted_b = torch.gather(bucket, -1, order)
    first = torch.searchsorted(sorted_b, sorted_b, side="left")
    pos_in_b = torch.arange(n, device=bucket.device) - first
    slot_sorted = torch.where(pos_in_b < c, sorted_b * c + pos_in_b,
                              torch.full_like(pos_in_b, e * c))
    return torch.empty_like(slot_sorted).scatter_(-1, order, slot_sorted).to(torch.int32)


def _scatter_rows(rows: torch.Tensor, slot: torch.Tensor, e: int, c: int) -> torch.Tensor:
    """rows (..., n, d) into (..., e, c, d) at their flat ``slot`` (..., n);
    rows at ``e * c`` land in a sink row that is cut off.  Every other slot
    takes at most one row, so the write is a copy (the reference adds into
    zeros)."""

    *lead, n, d = rows.shape
    buf = rows.new_zeros((*lead, e * c + 1, d))
    index = [torch.arange(m, device=rows.device).reshape((-1,) + (1,) * (len(lead) - i))
             for i, m in enumerate(lead)]
    buf = buf.index_put((*index, slot.long()), rows)
    return common.split_dim(buf[..., : e * c, :], -2, (e, c))


def _sort_dispatch(rows: torch.Tensor, bucket: torch.Tensor, e: int, c: int):
    """Capacity-bounded sort-based dispatch: scatter ``rows`` (n, d) into
    ``(e, c, d)`` slots keyed by ``bucket`` (n,) ids.  Returns ``(slots,
    slot)`` where ``slot`` (n,) int32 is each row's flat destination
    (``e*c`` = overflowed/dropped)."""

    slot = _dispatch_slots(bucket, e, c)
    return _scatter_rows(rows, slot, e, c), slot


def init_moe(gen: torch.Generator, cfg, dtype, *, stack: tuple[int, ...] = ()) -> common.Params:
    """The router is fp32 in any model dtype, as the reference draws it."""

    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    st = bool(stack)
    p = {
        "router": dense_init(gen, d, stack + (d, e), torch.float32, stacked=st),
        "w_gate": dense_init(gen, d, stack + (e, d, f), dtype, stacked=st),
        "w_up": dense_init(gen, d, stack + (e, d, f), dtype, stacked=st),
        "w_down": dense_init(gen, f, stack + (e, f, d), dtype, stacked=st),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, d, cfg.num_shared_experts * f, dtype, stack=stack)
    return p


def _route(p, xt: torch.Tensor, k: int):
    """fp32 router logits, softmax, top-k (ties to the lower expert, as
    ``jax.lax.top_k``) and the renormalised gates."""

    logits = torch.matmul(xt.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_p, top_e


def _repeat_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """(..., t, d) → (..., t*k, d), row i*k + j = row i: ``x[token_idx]``
    with ``token_idx = repeat(arange(t), k)``."""

    *lead, t, d = x.shape
    return x.unsqueeze(-2).expand(*lead, t, k, d).reshape(*lead, t * k, d)


def _experts(p, slots: torch.Tensor, act: str, pcfg=None) -> torch.Tensor:
    """The grouped expert FFN: ``slots`` (..., e, c, d) → (..., e, c, d).
    With ``pcfg`` (the per-row dispatch's (b, e, c, d) slots) the hidden
    and output slots are pinned as the reference pins them."""

    a = common.activation(act)
    g = torch.matmul(slots, p["w_gate"])
    u = torch.matmul(slots, p["w_up"])
    if pcfg is not None:
        g = _pin(g, ("data", "experts", None, "model"), pcfg)
        u = _pin(u, ("data", "experts", None, "model"), pcfg)
    out = torch.matmul(a(g) * u, p["w_down"])
    if pcfg is not None:
        out = _pin(out, ("data", "experts", None, None), pcfg)
    return out


def _combine(out_slots: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor, k: int):
    """Gather each dispatch's output row (a zero row where it was dropped),
    weight it by its gate in the rows' dtype, and add each token's k rows
    in order j = 0 … k-1.  out_slots (..., e*c, d), slot/gates (..., t*k)
    → (..., t, d)."""

    *lead, n, d = out_slots.shape
    padded = torch.cat([out_slots, out_slots.new_zeros((*lead, 1, d))], dim=-2)
    idx = slot.long().unsqueeze(-1).expand(*slot.shape, d)
    gathered = torch.gather(padded, -2, idx)
    weighted = common.split_dim(gathered * gates.unsqueeze(-1).to(gathered.dtype), -2, (-1, k))
    y = weighted[..., 0, :]
    for j in range(1, k):
        y = y + weighted[..., j, :]
    return y


def _aux(logits, probs, top_e, slot, e: int, c: int) -> dict:
    me = probs.reshape(-1, e).mean(0)                          # (e,)
    flat_e = top_e.reshape(-1)
    ce_frac = torch.zeros(e, device=probs.device).index_add(
        0, flat_e, torch.ones(flat_e.shape, device=probs.device)) / flat_e.numel()
    return {
        "load_balance_loss": e * torch.sum(me * ce_frac),
        "router_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "dropped_fraction": torch.mean((slot == e * c).float()),
    }


def moe_per_row(p: common.Params, x: torch.Tensor, cfg, pcfg=None) -> tuple[torch.Tensor, dict]:
    """Data-local MoE dispatch: routing, sort and scatter run independently
    per batch row, with capacity bounded per row."""

    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    logits, probs, top_p, top_e = _route(p, x, k)             # (b, s, k)
    c = min(_round_up(int(cfg.capacity_factor * s * k / e) or 1, 8), s * k)
    slot = _dispatch_slots(top_e.reshape(b, s * k), e, c)     # (b, s*k)
    rows = _repeat_rows(x, k)                                 # (b, s*k, d)
    slots = _scatter_rows(rows, slot, e, c)                   # (b, e, c, d)
    slots = _pin(slots, ("data", "experts", None, None), pcfg)
    out_flat = _experts(p, slots, cfg.act, pcfg).reshape(b, e * c, d)
    y = _pin(_combine(out_flat, slot, top_p.reshape(b, s * k), k), ("data", None, None), pcfg)
    if cfg.num_shared_experts:
        y = y + mlp(p["shared"], x, cfg.act)
    return y, _aux(logits, probs, top_e, slot, e, c)


# ---------------------------------------------------------------------------
# expert-parallel dispatch over a distributed-graph topology (MPI 4.0 ch. 8)
# ---------------------------------------------------------------------------

#: Explicit mantissa bits of the payload dtypes (``jnp.finfo(...).nmant``).
_MANTISSA_BITS = {torch.float64: 52, torch.float32: 23, torch.float16: 10, torch.bfloat16: 7}


def expert_dispatch_graph(
    world: int, num_experts: int, *, radius: int | None = None
) -> tuple[list[list[int]], list[list[int]]]:
    """The router's expert map as a ``dist_graph_create_adjacent`` adjacency.

    Rank ``r`` owns experts ``[r·E/W, (r+1)·E/W)`` and its router may select
    experts owned by ranks within ring distance ``radius`` (device-limited
    routing, the production trick that keeps expert dispatch neighbor-local
    instead of world-dense; ``radius=None`` → the full graph, vanilla top-k
    over every expert).  The returned ``(sources, destinations)`` lists are
    symmetric and order-aligned per rank — the property
    :func:`moe_neighbor` needs so expert outputs ride the reverse edges
    home — and include the self-edge (local experts dispatch through the
    same path, keeping the program uniform).
    """

    errors.check(
        num_experts % world == 0,
        errors.ErrorClass.ERR_DIMS,
        f"{num_experts} experts do not shard over {world} ranks",
    )
    r_eff = world if radius is None else int(radius)
    errors.check(
        r_eff >= 0,
        errors.ErrorClass.ERR_ARG,
        f"expert graph radius must be >= 0, got {radius}",
    )
    neighbors = []
    for r in range(world):
        nb = {(r + off) % world for off in range(-r_eff, r_eff + 1)}
        neighbors.append(sorted(nb))
    return [list(n) for n in neighbors], [list(n) for n in neighbors]


def moe_neighbor(
    p: common.Params, x: torch.Tensor, cfg, graph, *, capacity: int | None = None
) -> tuple[torch.Tensor, dict]:
    """Expert-parallel MoE dispatch riding ``neighbor_alltoallv`` over a
    :class:`~repro_torch.core.topology.DistGraphComm` built from the router's
    expert map (:func:`expert_dispatch_graph`).

    Every rank of ``graph`` calls it: ``x`` (t, d) is this rank's tokens,
    ``p['router']`` is the whole router, and the expert tensors hold only
    this rank's **local** expert slice (E/W, ...).  Routing is masked to
    experts the graph can reach; token blocks (capacity-padded) and expert
    ids travel to the owning ranks over the graph's exchange, experts run
    locally through the same sort-based dispatch as the dense path, and
    outputs ride the reverse edges home (the adjacency must be symmetric
    and order-aligned, which :func:`expert_dispatch_graph` guarantees) —
    two ``neighbor_alltoallv`` rounds in all, the expert ids travelling as
    a trailing payload column of the token exchange.  A row the router
    sends to an owner the graph cannot reach lands in the dropped bucket.
    """

    t, d = x.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    el = p["w_gate"].shape[0]
    n = graph.size()
    errors.check(
        el * n == e,
        errors.ErrorClass.ERR_DIMS,
        f"local expert slice {el} x {n} ranks != {e} experts",
    )
    adj = [graph.dist_graph_neighbors(r) for r in range(n)]
    for r, (srcs, _, dsts, _) in enumerate(adj):
        errors.check(
            tuple(srcs) == tuple(dsts),
            errors.ErrorClass.ERR_TOPOLOGY,
            f"moe_neighbor needs a symmetric, order-aligned expert graph "
            f"(rank {r}: sources {srcs} != destinations {dsts}) — expert "
            f"outputs return over the reverse edges",
        )
    d_out = graph.outdegree()
    c = capacity if capacity is not None else t * k

    # static router map: which experts each rank may select, and the out
    # slot of each owning rank
    slot_tab = np.full((n, n), -1, np.int64)
    mask_tab = np.zeros((n, e), bool)
    owner = np.arange(e) // el
    for r, (_, _, dsts, _) in enumerate(adj):
        for j, dst in enumerate(dsts):
            slot_tab[r, dst] = j
            mask_tab[r, owner == dst] = True
    # every rank's router must be able to fill its top-k from reachable
    # experts; otherwise top_k is forced onto masked (prob-0) experts whose
    # owner is not a neighbor and the dispatch has nowhere to send them
    reachable = mask_tab.sum(axis=1)
    errors.check(
        int(reachable.min()) >= k,
        errors.ErrorClass.ERR_TOPOLOGY,
        f"expert graph reaches only {int(reachable.min())} experts from "
        f"some rank but the router selects top-{k}; widen the graph radius",
    )
    rank = graph.rank()
    mask = torch.as_tensor(mask_tab[rank], device=x.device)     # (e,)

    logits = torch.matmul(x.float(), p["router"])
    logits = torch.where(mask[None, :], logits, torch.full_like(logits, -torch.inf))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]                  # (t, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)                                  # (t*k,)
    flat_slot = torch.as_tensor(slot_tab[rank], device=x.device)[flat_e // el]
    flat_slot = torch.where(flat_slot < 0, torch.full_like(flat_slot, d_out), flat_slot)

    # pack token rows with the local expert id as a trailing payload column
    # (one exchange moves both; ids stay exact as long as the mantissa
    # covers the local expert range)
    errors.check(
        el <= 2 ** _MANTISSA_BITS.get(x.dtype, 0),
        errors.ErrorClass.ERR_TYPE,
        f"{el} local experts are not exactly representable in the id "
        f"column's {x.dtype} payload",
    )
    local_ids = (flat_e % el).to(x.dtype)[:, None]
    payload = torch.cat([_repeat_rows(x, k), local_ids], dim=-1)       # (t*k, d+1)
    pos = _dispatch_slots(flat_slot, d_out, c)
    # a row with no reachable owner (bucket d_out) goes to the sink row
    pos = torch.where(flat_slot >= d_out, torch.full_like(pos, d_out * c), pos)
    send_x = _scatter_rows(payload, pos, d_out, c)                     # (d_out, c, d+1)

    counts = np.zeros((n, d_out), np.int64)
    for r, (_, _, dsts, _) in enumerate(adj):
        counts[r, : len(dsts)] = c
    recv, _ = graph.neighbor_alltoallv(send_x, counts).get()          # (d_in, c, d+1)
    recv_x, recv_ids = recv[..., :d], recv[..., d]

    # owner side: group arrivals by local expert (capacity = all arrivals:
    # the sender-side capacity already bounded the traffic, so nothing drops
    # here) and run the expert FFNs
    rows_in = recv_x.reshape(-1, d)
    ids_in = torch.round(recv_ids.reshape(-1)).to(torch.int64)
    ci = rows_in.shape[0]
    slots, pos_in = _sort_dispatch(rows_in, ids_in, el, ci)
    out_slots = _experts(p, slots, cfg.act).reshape(-1, d)

    # un-dispatch to arrival order and ride the reverse edges home
    padded = torch.cat([out_slots, out_slots.new_zeros((1, d))])
    reply = padded[pos_in.long()].reshape(recv_x.shape)
    home, _ = graph.neighbor_alltoallv(reply, counts).get()           # (d_out, c, d)

    # combine at the origin: each dispatch's packed position, weighted by
    # its gate, the token's k rows added in order
    y = _combine(home.reshape(-1, d), pos, top_p.reshape(-1), k)
    if cfg.num_shared_experts:
        y = y + mlp(p["shared"], x, cfg.act)

    ce_frac = torch.zeros(e, device=x.device).index_add_(
        0, flat_e, torch.ones(flat_e.shape, device=x.device)) / (t * k)
    masked = torch.where(mask[None, :], logits, torch.full_like(logits, -1e30))
    aux = {
        "load_balance_loss": e * torch.sum(probs.mean(0) * ce_frac),
        "router_z_loss": torch.mean(torch.logsumexp(masked, dim=-1) ** 2),
        "dropped_fraction": torch.mean((pos == d_out * c).float()),
    }
    return y, aux


def moe(
    p: common.Params, x: torch.Tensor, cfg, *, capacity: int | None = None, pcfg=None
) -> tuple[torch.Tensor, dict]:
    """Capacity-bounded top-k MoE: sort-based dispatch into ``(E, C, D)``
    slots, one grouped product per projection, a gather-combine.
    Overflowing rows drop; aux: load balance, router z-loss, dropped share."""

    if pcfg is not None and getattr(pcfg, "moe_dispatch", "global") == "per_row":
        return moe_per_row(p, x, cfg, pcfg)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    t = b * s
    xt = x.reshape(t, d)
    logits, probs, top_p, top_e = _route(p, xt, k)           # (t, k)
    if capacity is None:
        capacity = _round_up(int(cfg.capacity_factor * t * k / e) or 1, 8)
    c = min(capacity, t * k)
    slots, slot = _sort_dispatch(_repeat_rows(xt, k), top_e.reshape(-1), e, c)
    out_slots = _experts(p, slots, cfg.act).reshape(e * c, d)
    y = _combine(out_slots, slot, top_p.reshape(-1), k)
    if cfg.num_shared_experts:
        y = y + mlp(p["shared"], xt, cfg.act)
    if is_dtensor(y):
        # the token rows may be split over more ranks than the batch rows
        # divide: whole before the (b, s) split, then batch over data
        y = common.pin(y.redistribute(y.device_mesh, [Replicate()] * y.device_mesh.ndim)
                       .reshape(b, s, d), ("data", None, None), pcfg)
        return y, _aux(logits, probs, top_e, slot, e, c)
    return y.reshape(b, s, d), _aux(logits, probs, top_e, slot, e, c)
