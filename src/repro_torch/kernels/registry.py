"""The port's kernels as ``torch.library`` custom ops, and what the dry run
counts for each.

**Port-only choice: kernels as custom ops.**  Each hand-written kernel's
launch (the ``ctypes`` call on the current stream, ``kernel.py``) is the
CUDA implementation of an op of the ``repro_torch`` namespace
(:func:`define`), so that a trace over fake tensors
(:mod:`repro_torch.launch.dryrun`) goes through it: the op's fake
implementation gives the outputs' shapes and launches nothing, and its
flop formula
(``torch.utils.flop_counter.register_flop_formula``) and bytes formula
(:func:`register_bytes_formula`) give what the launch would do.  The flop
formulas count the TPU kernel's own work: its matmuls, tile by tile of its
Pallas blocks, with the tiles its causal test skips skipped
(:func:`attention_tiles`).  A fake call does not reach the real
implementation, so it adds nothing to a kernel's launch count
(``core.tool.launch_counter``).  A real call on a CPU tensor raises, as the
kernel's entry did: the plain versions live in the public wrappers
(``ops.py``), which pick by the device.

The ops are defined on a ``torch.library.Library`` with a schema, the launch
registered for the CPU and CUDA keys and nothing for autograd (each kernel's
``autograd.Function`` lies above its op): a call goes from the dispatcher
straight to the launch, 6–19 µs of host time over a direct call of the
launch on an H100 host; ``torch.library.custom_op``, with its Python
autograd and in-place layers, took 28–58 µs (``tools/wrapper_host_us.py``,
``PERF.md`` §6).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

#: the custom ops' namespace (``torch.ops.repro_torch.<kernel>``)
NAMESPACE = "repro_torch"

#: the library the kernels' ops are defined on
OPS = torch.library.Library(NAMESPACE, "FRAGMENT")


def define(name: str, schema: str, launch: Callable, fake: Callable):
    """Define ``torch.ops.repro_torch.<name>`` with ``schema`` (its
    arguments and returns, ``"(Tensor x) -> Tensor"``): ``launch`` runs for
    real tensors (CPU ones reach its checks, which raise), ``fake`` for
    fake ones.  Returns the op packet."""

    OPS.define(name + schema)
    for key in ("CPU", "CUDA"):
        OPS.impl(name, launch, key)
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=OPS)
    return getattr(getattr(torch.ops, NAMESPACE), name)


#: op packet → ``fn(args, kwargs, out) -> bytes`` of one launch: what the
#: dry run's counter charges the op in place of its inputs' and outputs'
#: sizes
BYTES_FORMULAS: dict[Any, Callable[..., int]] = {}


def register_bytes_formula(op) -> Callable:
    """Register ``fn(args, kwargs, out) -> int`` as the bytes one call of
    ``op`` (an op packet) moves to and from device memory."""

    def deco(fn: Callable[..., int]) -> Callable[..., int]:
        BYTES_FORMULAS[op] = fn
        return fn

    return deco


def tensor_bytes(tree: Any) -> int:
    """Bytes of every tensor in a nest of arguments or outputs."""

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(tensor_bytes(x) for x in tree.values())
    return 0


def read_once_write_once(args, kwargs, out) -> int:
    """Each input read once, each output written once."""

    return tensor_bytes(args) + tensor_bytes(kwargs) + tensor_bytes(out)


def attention_tiles(sq: int, sk: int, causal: bool, *, block_q: int = 512,
                    block_k: int = 512, q_offset: int = 0, k_offset: int = 0) -> int:
    """(q block, k block) pairs the reference's Pallas attention kernels
    compute: blocks of ``min(block, length)`` over the lengths padded to
    them, less, when causal, the pairs strictly in the q block's future
    (``k_offset + k_start > q_offset + q_start + block_q - 1``).  A window
    or a prefix skips no block there."""

    bq, bk = min(block_q, sq), min(block_k, sk)
    nq, nk = -(-sq // bq), -(-sk // bk)
    if not causal:
        return nq * nk
    return sum(1 for qi in range(nq) for ki in range(nk)
               if k_offset + ki * bk <= q_offset + qi * bq + bq - 1)
