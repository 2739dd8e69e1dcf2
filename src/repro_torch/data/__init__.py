"""Data pipeline: deterministic synthetic token streams, shard-aware
batching, and stateless resume (the loader state is just the step index)."""

from repro_torch.data.pipeline import TokenPipeline  # noqa: F401
