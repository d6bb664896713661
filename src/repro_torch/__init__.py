"""PyTorch/CUDA port of the LEAD system (src/repro is the JAX reference).

The layout mirrors ``src/repro``: ``kernels/`` (hand-written Hopper kernels
and their plain PyTorch versions), ``core/`` (topology, compression,
objectives, gossip, simulator) and ``core/engines/`` (the flat engine
family).  It imports torch and numpy, never jax and nothing of ``repro``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
