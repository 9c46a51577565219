"""Distributed training steps and collectives over ``torch.distributed``
(the reference's ``distributed/``): the CAGNET full-graph, partitioned-halo,
sampled-MFG and batched-graph GNN steps (``gnn_parallel``) and split-KV
decoding (``collectives``)."""
