"""Distributed runtime: the decentralized trainer (every engine of the
registry, or the allreduce reference, over stacked model pytrees with codes
on the wire), all agents on one device."""
