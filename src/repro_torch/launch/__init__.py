"""Drivers: ``train.py``, the decentralized training CLI."""
