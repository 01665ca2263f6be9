"""The training driver (port of ``repro/launch/train.py``)."""
