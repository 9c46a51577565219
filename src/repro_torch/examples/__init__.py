"""End-to-end drivers of the port (counterparts of the repository's
``examples/``), run as ``python -m repro_torch.examples.<name>`` on the
card (``--device cpu`` for the CPU)."""
