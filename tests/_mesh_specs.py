"""The cells' layouts on a mesh, the reference's and the port's, in one
form for comparison: ``{path: spec}`` per argument, a spec a tuple of
axis names (a one-name tuple as the name) without its trailing ``None``s,
replicated leaves left out.

:func:`reference_specs` runs in a process whose JAX has as many host
devices as the mesh (``XLA_FLAGS=--xla_force_host_platform_device_count``);
:func:`run_reference_specs` starts one.
"""

import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
AXES = ("data", "model")
# the LM archs and Wide&Deep: the families laid out by param_shardings,
# cache_shardings and recsys_param_shardings
ARCHS = ("phi3.5-moe-42b-a6.6b", "granite-moe-1b-a400m", "qwen3-0.6b",
         "qwen3-1.7b", "gemma2-2b", "wide-deep")


def strip(spec) -> tuple:
    """A layout without its trailing Nones, one-name tuples as the name
    (a ``PartitionSpec``'s form)."""
    spec = tuple(s[0] if isinstance(s, tuple) and len(s) == 1 else s
                 for s in spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def normal(specs: dict) -> dict:
    """``{path: stripped spec}`` with the replicated leaves left out."""
    out = {k: strip(v or ()) for k, v in specs.items()}
    return {k: v for k, v in out.items() if v}


def port_specs(cell) -> list:
    return [normal(s) for s in cell.in_specs]


def reference_specs(shape: tuple, archs=ARCHS) -> dict:
    """{(arch, shape name): [{path: spec} per argument]} of the
    reference's cells on a mesh of ``shape`` over the first devices."""
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import registry as jreg
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), AXES)

    def flat(tree) -> dict:
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
        out = {}
        for path, s in leaves:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            out[key] = tuple(s.spec)
        return normal(out)

    out = {}
    with mesh:
        for arch in archs:
            spec = jreg.get_spec(arch)
            for name in spec.shapes:
                cell = jreg.build_cell(spec, name, mesh)
                out[arch, name] = [flat(a) for a in cell.in_shardings]
    return out


def run_reference_specs(shape: tuple, archs=ARCHS) -> dict:
    """:func:`reference_specs` in a subprocess with as many host devices
    as the mesh holds."""
    n = 1
    for s in shape:
        n *= s
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n}",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "specs.pkl")
        code = ("import pickle, sys, _mesh_specs as m; "
                "pickle.dump(m.reference_specs(eval(sys.argv[1]), "
                "eval(sys.argv[2])), open(sys.argv[3], 'wb'))")
        run = subprocess.run([sys.executable, "-c", code, repr(tuple(shape)),
                              repr(tuple(archs)), out], env=env,
                             capture_output=True, text=True, timeout=600)
        assert run.returncode == 0, run.stderr[-4000:]
        with open(out, "rb") as f:
            return pickle.load(f)
