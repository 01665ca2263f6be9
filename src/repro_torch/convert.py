"""Carry the reference system's state over to the port.

The SPARQL system has no weights: its state is the triple store and the
term dictionary. :func:`from_reference` takes the numpy dicts the JAX
package's ``TripleStore.to_arrays()`` / ``ShardedTripleStore.to_arrays()``
and ``Dictionary.to_arrays()`` produce and rebuilds them as the port's
store and dictionary. :func:`lm_params_from_reference`,
:func:`recsys_params_from_reference` and :func:`gnn_params_from_reference`
turn the model zoo's LM (dense and MoE), Wide&Deep and GNN (GCN, PNA,
EGNN, NequIP) parameter trees, given as numpy arrays, into the port's
params, :func:`adamw_state_from_reference` an AdamW state (moments and
step), and :func:`system_params_from_reference` the cloud-edge system's
``SystemParams``. All read plain arrays only, so
they import nothing of the JAX package. :func:`local_shard` cuts a tree
carried across (params or a batch) into this rank's pieces of a mesh, by
the reference's layouts.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tree as _tree
from .device import resolve_device
from .launch import collectives as col

from .core.cost import SystemParams
from .rdf.dictionary import Dictionary
from .rdf.graph import TripleStore
from .rdf.sharding import ShardedTripleStore


def from_reference(store_arrays: dict[str, np.ndarray],
                   dict_arrays: dict[str, np.ndarray],
                   num_shards: int | None = None):
    """``(store, dictionary)`` of the port from the reference's arrays.

    ``store_arrays`` holds ``s``, ``p``, ``o`` and ``meta``
    (``[num_entities, num_predicates]``, plus ``num_shards`` for a sharded
    store). ``num_shards`` re-partitions the store; by default a sharded
    store keeps its shard count and a monolithic one stays monolithic.
    Term ids are preserved, so both sides answer with the same ids.
    """
    meta = [int(x) for x in store_arrays["meta"]]
    if num_shards is None and len(meta) > 2:
        num_shards = meta[2]
    s, p, o = store_arrays["s"], store_arrays["p"], store_arrays["o"]
    if num_shards is None:
        store = TripleStore(s, p, o, meta[0], meta[1])
    else:
        store = ShardedTripleStore(s, p, o, meta[0], meta[1],
                                   num_shards=int(num_shards))
    return store, Dictionary.from_arrays(dict_arrays)


# LM leaves the reference keeps in float32 whatever the weights' dtype: the
# norm scales and the MoE router (routing in bf16 would pick other experts)
_F32_LEAVES = {"final_norm", "ln_attn", "ln_mlp", "ln_attn_post",
               "ln_mlp_post", "q_norm", "k_norm", "router"}


def lm_params_from_reference(tree: dict, device=None,
                             dtype: torch.dtype = torch.bfloat16) -> dict:
    """The port's LM params from the JAX ``init_lm_params`` tree (dense or
    MoE), with its leaves as numpy arrays (float32 or bfloat16): same keys
    and layouts, norm scales and the router in float32 and every other
    leaf in ``dtype``, on ``device`` (``cuda`` by default)."""
    dev = resolve_device(device)

    def leaf(name, a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=torch.float32 if name in _F32_LEAVES
                    else dtype)

    return {k: ({kk: leaf(kk, vv) for kk, vv in v.items()}
                if isinstance(v, dict) else leaf(k, v))
            for k, v in tree.items()}


def _tensor(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)


def recsys_params_from_reference(tree: dict, device=None) -> dict:
    """The port's Wide&Deep params from the JAX ``init_recsys_params``
    tree, with its leaves as numpy arrays: same keys, dtypes and layouts
    (``mlp`` a list of ``{w, b}``), on ``device`` (``cuda`` by default)."""
    dev = resolve_device(device)
    out = {k: _tensor(v, dev) for k, v in tree.items() if k != "mlp"}
    out["mlp"] = [{"w": _tensor(layer["w"], dev),
                   "b": _tensor(layer["b"], dev)} for layer in tree["mlp"]]
    return out


def gnn_params_from_reference(tree: dict, device=None) -> dict:
    """The port's GNN params from the JAX ``gnn_init`` tree of any of the
    four models (``gcn_init``, ``pna_init``, ``egnn_init``,
    ``nequip_init``), with its leaves as numpy arrays: the same nesting
    (dicts, lists, ``(w, b)`` tuples), dtypes and layouts, on ``device``
    (``cuda`` by default)."""
    dev = resolve_device(device)

    def carry(node):
        if isinstance(node, dict):
            return {k: carry(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(carry(v) for v in node)
        return _tensor(node, dev)

    return carry(tree)


def adamw_state_from_reference(state: dict, device=None) -> dict:
    """The port's AdamW state from the JAX ``adamw_init`` /
    ``adamw_update`` state ``{"m", "v", "step"}`` with its leaves as numpy
    arrays: float32 moments of the params' nesting (dicts, lists,
    tuples), ``step`` a 0-dim int32 tensor, on ``device`` (``cuda`` by
    default); so both packages can take the same step from the same
    state."""
    dev = resolve_device(device)

    def carry(node):
        if isinstance(node, dict):
            return {k: carry(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(carry(v) for v in node)
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(dev)

    return {"m": carry(state["m"]), "v": carry(state["v"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}


def system_params_from_reference(ref_params) -> SystemParams:
    """The port's :class:`~repro_torch.core.cost.SystemParams` from the
    reference's: its numpy fields (``F``, ``r_edge``, ``r_cloud``,
    ``assoc``, ``r_backhaul``, ``F_cloud``) copied as they are, so both
    sides schedule on the same numbers."""
    bh = getattr(ref_params, "r_backhaul", None)
    return SystemParams(
        F=np.array(ref_params.F, dtype=np.float64),
        r_edge=np.array(ref_params.r_edge, dtype=np.float64),
        r_cloud=np.array(ref_params.r_cloud, dtype=np.float64),
        assoc=np.array(ref_params.assoc, dtype=bool),
        r_backhaul=None if bh is None else np.array(bh, dtype=np.float64),
        F_cloud=float(ref_params.F_cloud))


def local_shard(tree, specs: dict, mesh):
    """This rank's pieces of ``tree`` (params or a batch, whole) on
    ``mesh``, by the reference's layouts.

    ``specs`` maps a leaf's path (:func:`repro_torch.tree.path_key`, e.g.
    ``"layers/wi_gate"`` or ``"feat"``) to its layout, the reference's
    ``PartitionSpec`` written as a tuple: for each leading dim ``None``
    (whole), a mesh axis name or a tuple of names (cut into as many equal
    tiles as those axes hold ranks, this rank's tile kept, row-major over
    a tuple); dims past the tuple are whole. Leaves not in ``specs`` are
    replicated and kept as they are. Raises ``KeyError`` for a path that
    names no leaf and ``ValueError`` where a dim does not divide."""
    flat = _tree.flatten(tree)
    paths = {_tree.path_key(p) for p, _ in flat}
    unknown = sorted(set(specs) - paths)
    if unknown:
        raise KeyError(f"local_shard: no leaf at {unknown}")
    out = []
    for path, leaf in flat:
        spec = specs.get(_tree.path_key(path))
        for dim, axes in enumerate(spec or ()):
            if axes is None or axes == ():
                continue
            n = col.axis_size(mesh, axes)
            if leaf.shape[dim] % n:
                raise ValueError(f"local_shard: {_tree.path_key(path)} dim "
                                 f"{dim} ({leaf.shape[dim]}) does not divide "
                                 f"into {n} shards")
            size = leaf.shape[dim] // n
            leaf = leaf.narrow(dim, col.axis_index(mesh, axes) * size, size)
        out.append(leaf.contiguous() if spec else leaf)
    return _tree.unflatten(tree, out)


def gather_shards(tree, specs: dict, mesh):
    """The whole leaves of ``tree`` from every rank's pieces on ``mesh``
    (the inverse of :func:`local_shard`, a collective: every rank calls
    it): each dim a layout cuts all-gathered over its axes, in rank
    order. Leaves not in ``specs`` are taken as replicated and kept."""
    out = []
    for path, leaf in _tree.flatten(tree):
        for dim, axes in enumerate(specs.get(_tree.path_key(path)) or ()):
            if axes is not None and axes != ():
                leaf = col.all_gather(leaf, mesh, axes, dim=dim)
        out.append(leaf)
    return _tree.unflatten(tree, out)
