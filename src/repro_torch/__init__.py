"""repro_torch — the PyTorch/CUDA port of ``repro``.

Each module ``repro_torch/<path>`` mirrors ``repro/<path>`` with the same
public names, so a reader finds each counterpart.  The package imports
``torch``, numpy and the standard library only; framework-free code of the
reference (errors, descriptors, configs, the ``Group`` algebra) is copied.
Entry points run on a CUDA device unless the caller asks for the CPU
(``device="cpu"``); the hand-written kernels live under ``kernels/``.
"""

# The first import of ``torch._dynamo`` runs ``torch.fx.wrap``, whose frame
# holds a reference to itself: every frame below it stays alive until the
# cyclic collector runs.  torch imports it lazily, on the first call of any
# function it wraps with ``_disable_dynamo`` (``torch.utils.checkpoint``'s
# remat among them), so a trainer's first step pinned the trainer, its
# state and its CUDA graphs' memory pools after the trainer was dropped.
# Imported with the package, it pins only the importing frames.
import torch._dynamo  # noqa: E402,F401
