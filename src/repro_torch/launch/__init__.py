"""Drivers: ``train.py``, the decentralized training CLI (``train_lm.py``
its 8-rank example), ``serve.py``, the serving CLI, and ``mesh.py``, the
rank grids."""
