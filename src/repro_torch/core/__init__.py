"""GriNNder core for the port: structured storage offloading
(cache/(re)gather/bypass) and the partition plan.

Unlike the reference package this ``__init__`` imports no engine: the
submodules are imported where they are used, so importing the storage or
cache substrate stays cheap and free of any compute framework.
"""
