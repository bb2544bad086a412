"""Data substrate: deterministic sharded synthetic pipeline."""
from .pipeline import PipelineSpec, make_batch, spec_for

__all__ = ["PipelineSpec", "make_batch", "spec_for"]
