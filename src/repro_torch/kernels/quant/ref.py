"""Plain PyTorch versions of int8 block quantization: the CPU path, and the
oracle ``chip_smoke.py`` holds the CUDA kernels against.  Re-exports
:mod:`repro_torch.core.compress`, as the reference's ``ref.py`` re-exports
``repro.core.compress``, so the kernel, the KV cache and the flat payload
API share one definition.  The row functions take any width."""

from repro_torch.core.compress import (  # noqa: F401
    BLOCK,
    compression_error,
    dequantize_int8,
    dequantize_int8_rows,
    quantize_int8,
    quantize_int8_rows,
)
