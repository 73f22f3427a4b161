"""Optimizers of the LM training path (``optimizers.py``)."""
