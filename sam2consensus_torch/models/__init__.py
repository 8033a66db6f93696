"""The consensus caller as one module (``models/consensus.py``)."""
