"""Partition-ordered gradient synchronisation through ``repro_torch.core``
— :mod:`repro.optim.grad_sync` in PyTorch.

This is the explicit path for data-parallel replicas that average their
gradients themselves, and the home of the cross-pod tricks:

* **partitioned reduction** (MPI 4.0 partitioned communication): the
  gradient tree packs into one buffer per dtype group
  (:func:`repro_torch.core.datatypes.pack`), and each buffer is one
  partition of a :class:`~repro_torch.core.futures.PartitionedRequest`,
  marked ready (``MPI_Pready``) in any order and issued in index order, so
  every rank issues the same collectives in the same order whatever its
  ``pready_order``, and the result does not depend on it;
* **hierarchical reduction** (reduce-scatter inside ``inner``, all-reduce
  across ``outer``, all-gather inside ``inner``), so only 1/inner_size of
  the payload crosses the slow fabric;
* **int8 compression with error feedback** (EF-SGD, Karimireddy et al.):
  each rank compresses its message ``m = g + e`` in blocks of 256 (on the
  card, one launch each of the int8 row kernels a leaf), sends the
  compressed form, and carries ``e' = m - C(m)`` into the next step.

:func:`sync_gradients` is the functional entry point; long-lived callers
hold one :class:`PartitionedGradSync` and call it every step.  The port's
trainer, as the reference's, averages its gradients without it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core import collectives, datatypes, errors
from repro_torch.core.communicator import Communicator
from repro_torch.core.descriptors import Compression
from repro_torch.core.futures import PartitionedRequest, flatten, unflatten
from repro_torch.core.overlap import hierarchical_allreduce
from repro_torch.kernels.quant import ops as quant

Params = Any


@dataclasses.dataclass
class ErrorFeedbackState:
    residual: Params  # the gradients' tree, fp32 leaves

    @classmethod
    def init(cls, grads: Params) -> "ErrorFeedbackState":
        leaves, treedef = flatten(grads)
        return cls(residual=unflatten(treedef, [
            torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in leaves]))


def _compress_with_feedback(g: torch.Tensor, e: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """EF step for one leaf: (C(g + e) dequantized, the new residual)."""

    m = g.float() + e
    flat = m.reshape(-1)
    q, scale, pad = quant.quantize_int8(flat)
    cm = quant.dequantize_int8(q, scale, pad, flat.shape, torch.float32).reshape(m.shape)
    return cm, m - cm


class PartitionedGradSync:
    """Gradient all-reduce as a partitioned request over dtype buckets.

    One instance fixes the communicators and the compression; each call
    packs the gradient tree into per-dtype buckets, starts a
    :class:`PartitionedRequest` with one partition a bucket, marks each
    bucket ready in ``pready_order`` (any order gives the same result) and
    waits.
    """

    def __init__(
        self,
        inner: Communicator,
        outer: Communicator | None = None,
        *,
        compression: Compression = Compression.NONE,
        mean: bool = True,
    ):
        self.inner = inner
        self.outer = outer
        self.compression = compression
        self.mean = mean

    @classmethod
    def for_epoch(cls, epoch, *, compression: Compression = Compression.NONE,
                  mean: bool = True, key: str = "grad_sync") -> "PartitionedGradSync":
        """The epoch-derived sync: one instance per
        :class:`~repro_torch.core.epoch.CommEpoch`, held in the epoch's cache
        so a shrink or grow re-initialises the buckets against the
        successor's fabric on first use (the revoked epoch raises
        ``ERR_REVOKED`` instead of reducing over ranks that are gone)."""

        return epoch.cached(key, lambda ep: cls(ep.comm, compression=compression, mean=mean))

    def _reduce_bucket(self, index: int, buf: torch.Tensor) -> torch.Tensor:
        if self.outer is None:
            return collectives.allreduce(self.inner, buf)
        return hierarchical_allreduce(buf, self.inner, self.outer, compression=self.compression)

    def __call__(
        self,
        grads: Params,
        ef: ErrorFeedbackState | None = None,
        *,
        pready_order: Sequence[int] | None = None,
    ) -> tuple[Params, ErrorFeedbackState | None]:
        """All-reduce a gradient tree across the data-parallel ranks:
        (the synchronised gradients, the new error-feedback state).  With
        ``compression=INT8`` and ``ef``, each leaf is error-feedback
        compressed first (its synchronised gradient is then fp32, as in the
        reference)."""

        n_total = self.inner.size() * (self.outer.size() if self.outer is not None else 1)
        scale = 1.0 / n_total if self.mean else 1.0

        new_ef = ef
        if self.compression is Compression.INT8 and ef is not None:
            flat_g, treedef = flatten(grads)
            flat_e, e_def = flatten(ef.residual)
            errors.check(e_def == treedef, errors.ErrorClass.ERR_ARG,
                         "error-feedback residual and gradients differ in structure")
            pairs = [_compress_with_feedback(g, e) for g, e in zip(flat_g, flat_e)]
            grads = unflatten(treedef, [p[0] for p in pairs])
            new_ef = ErrorFeedbackState(residual=unflatten(treedef, [p[1] for p in pairs]))
            del pairs

        bufs, dtype_desc = datatypes.pack(grads)
        req = PartitionedRequest(self._reduce_bucket, len(bufs)).start()
        order = tuple(pready_order) if pready_order is not None else tuple(range(len(bufs)))
        errors.check(
            sorted(order) == list(range(len(bufs))),
            errors.ErrorClass.ERR_REQUEST,
            f"pready_order {order} is not a permutation of {len(bufs)} buckets",
        )
        for i in order:
            req.pready(i, bufs[i])
        del bufs
        synced = datatypes.unpack(req.wait(), dtype_desc)
        leaves, treedef = flatten(synced)
        out = unflatten(treedef, [(s.float() * scale).to(s.dtype) for s in leaves])
        return out, new_ef


def sync_gradients(
    grads: Params,
    inner: Communicator,
    outer: Communicator | None = None,
    *,
    compression: Compression = Compression.NONE,
    ef: ErrorFeedbackState | None = None,
    mean: bool = True,
    pready_order: Sequence[int] | None = None,
) -> tuple[Params, ErrorFeedbackState | None]:
    """Functional wrapper over :class:`PartitionedGradSync` (stable API)."""

    sync = PartitionedGradSync(inner, outer, compression=compression, mean=mean)
    return sync(grads, ef, pready_order=pready_order)
