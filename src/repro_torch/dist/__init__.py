"""Distributed runtime: the decentralized trainer (every engine of the
registry, or the allreduce reference, over stacked model pytrees with codes
on the wire), the agents on one device or split over torch.distributed
ranks (sharding.py)."""
