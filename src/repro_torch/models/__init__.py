"""The LM serving path of the model zoo, in PyTorch (port of
``repro.models``: ``common`` and the dense path of ``transformer``)."""
