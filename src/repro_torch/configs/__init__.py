"""Model configurations and workload shapes (the reference's ``configs/``).
Only what the ported paths run is here so far: the recsys shapes and FLOP
count (``base.py``) and the two-tower retrieval configuration."""
