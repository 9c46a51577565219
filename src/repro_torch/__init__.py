"""PyTorch/CUDA port of the GriNNder SSO system (storage-offloaded
full-graph GNN execution) for an NVIDIA Hopper card.

The package mirrors ``src/repro/`` module by module and imports neither JAX
nor anything of the JAX package: the numpy-only substrate (observability,
counters, storage, cache, graph tooling, pipeline queues) is carried as its
own copy. Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no device given and no CUDA device present they raise
(:func:`repro_torch.device.resolve_device`).

Ported so far: the serving slice — ``OffloadedInference`` +
``EmbeddingServer`` over the shared ``ForwardRunner`` pipeline — and the
training slice — ``SSOEngine`` (regather and snapshot), AdamW, atomic
checkpoints and the epoch-checkpointed loop — with all six GNN families;
the two-tower retrieval model (``models/recsys/``, serving and training,
with its example programs in ``examples/``); the dense LM's serving
(``models/lm/``); the micro-batch baseline (``core/microbatch.py``), the
neighbour sampler, the tier cost model (``core/costmodel.py``), the run
ledger, regression sentinel and live telemetry (``obs/``)
and the three GNN examples; and the hand-written CUDA kernels, every
Pallas kernel of the reference (``kernels/*/csrc/``).
"""
