"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: its LM
serving path on one card, driven by data (``BENCHMARK.json`` and the files
of this folder). See ``README.md`` here."""

import os
from pathlib import Path


def caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its CUDA libraries under ``root/build`` itself)."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv")
