"""repro_torch — the PyTorch/CUDA port of ``repro``.

Each module ``repro_torch/<path>`` mirrors ``repro/<path>`` with the same
public names, so a reader finds each counterpart.  The package imports
``torch``, numpy and the standard library only; framework-free code of the
reference (errors, descriptors, configs, the ``Group`` algebra) is copied.
Entry points run on a CUDA device unless the caller asks for the CPU
(``device="cpu"``); the hand-written kernels live under ``kernels/``.
"""
