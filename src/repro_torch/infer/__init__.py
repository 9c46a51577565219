"""Storage-offloaded inference + embedding serving on the port.

- :class:`OffloadedInference`: layer-wise full-graph forward through the
  shared :class:`~repro_torch.runtime.forward.ForwardRunner` pipeline, with
  per-layer storage truncation and optional fp16 on-storage activations.
- :class:`EmbeddingServer`: batched original-id lookups against the final
  embedding table through a dedicated host cache, with hit/miss and
  latency-percentile telemetry (host-side, numpy).
"""
from repro_torch.infer.engine import OffloadedInference
from repro_torch.infer.server import EmbeddingServer
from repro_torch.infer.traffic import zipf_batches

__all__ = ["OffloadedInference", "EmbeddingServer", "zipf_batches"]
