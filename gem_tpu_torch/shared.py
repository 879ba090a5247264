"""The JAX-free modules of gem_tpu, shared without importing jax.

`gem_tpu/config.py`, `io/pcd.py`, `utils/image.py`, `msgs.py`,
`sensors/catalog.py`, `global_map/octomap_io.py` and `native/__init__.py`
import only the standard library and NumPy, but importing any of them as `gem_tpu.x` runs
`gem_tpu/__init__.py`, which imports jax.  `load` executes one such file by
path instead: one source of truth, no copy.  While a file runs, its own
`from gem_tpu.config import ...` resolves to the shared config module.
"""

from __future__ import annotations

import importlib.util
import os
import sys

_GEM_TPU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "gem_tpu")


def load(relpath: str):
    """The module of `gem_tpu/<relpath>`, executed once per process under
    the name `gem_tpu_torch._shared.<relpath>`."""
    name = "gem_tpu_torch._shared." + relpath[:-3].replace("/", ".")
    if name in sys.modules:
        return sys.modules[name]
    alias = {} if relpath == "config.py" else {"gem_tpu.config":
                                                load("config.py")}
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_GEM_TPU, relpath))
    mod = importlib.util.module_from_spec(spec)
    # registered before exec: dataclasses resolves the module by name
    sys.modules[name] = mod
    saved = {k: sys.modules.get(k) for k in alias}
    sys.modules.update(alias)
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    return mod
