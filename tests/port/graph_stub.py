"""A stand-in for CUDA graph capture on the CPU, so that the tests here can
drive :class:`repro_torch.core.futures.PersistentRequest`'s graph path — the
binding of buffers, the copies before each replay, recapture, release and
the launch counts — with no card.

:func:`install` lets a request capture CPU tensors and swaps
``futures._graph_capture`` for :func:`stub_capture`.  Like a capture, the
stub leaves the arguments as they were (it runs the step once to build its
outputs, then restores every tensor argument); like a replay, the stub's
``replay()`` runs the step again on the same argument buffers and writes
the results into the capture's outputs, which stay the same tensors."""

from __future__ import annotations

import torch

from repro_torch.core import futures
from repro_torch.core.futures import flatten, unflatten


class StubGraph:
    def __init__(self, fn, treedef, leaves, out):
        self.fn, self.treedef, self.leaves, self.out = fn, treedef, leaves, out
        self.replays = 0

    def replay(self) -> None:
        new = self.fn(*unflatten(self.treedef, self.leaves))
        with torch.no_grad():
            for static, fresh in zip(flatten(self.out)[0], flatten(new)[0]):
                if isinstance(static, torch.Tensor) and static is not fresh:
                    static.copy_(fresh)
        self.replays += 1


def stub_capture(fn, args):
    leaves, treedef = flatten(args)
    saved = [leaf.detach().clone() if isinstance(leaf, torch.Tensor) else None
             for leaf in leaves]
    out = fn(*args)
    with torch.no_grad():
        for leaf, copy in zip(leaves, saved):
            if copy is not None:
                leaf.copy_(copy)
    return StubGraph(fn, treedef, leaves, out), out


def install(monkeypatch) -> None:
    monkeypatch.setattr(futures, "_capturable", lambda leaf: isinstance(leaf, torch.Tensor))
    monkeypatch.setattr(futures, "_graph_capture", stub_capture)
