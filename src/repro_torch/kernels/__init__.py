"""Hand-written CUDA kernels of the SPARQL query path, the LM serving path,
the recsys and GNN serving paths and the LM and recsys training paths
(the attention and embedding-bag backward), with their wrappers.

There is no interpret mode and no availability probe: the device of the
input decides. A CPU tensor runs the plain torch version in :mod:`.ref`;
a CUDA tensor launches the kernel (built on first use from the sources
of ``csrc/``, one library each) or raises.
"""

from ._build import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
