"""Hub — port of ``paddle_tpu/hub.py``: hubconf-based model discovery and
loading.

Parity anchor: python/paddle/hapi/hub.py (list at :185, help at :235,
load at :283) — a repo exposes entrypoints via a ``hubconf.py`` whose public
callables are the models; ``dependencies`` lists required import names.

This environment has no network egress, so ``source='local'`` (a directory
containing ``hubconf.py``) is fully supported; the github/gitee download path
raises a clear error instead of silently hanging.
"""

from __future__ import annotations

import importlib.util
import os
import sys

__all__ = ["list", "help", "load"]

MODULE_HUBCONF = "hubconf.py"
VAR_DEPENDENCY = "dependencies"


def _load_hubconf(repo_dir):
    path = os.path.join(os.path.expanduser(repo_dir), MODULE_HUBCONF)
    if not os.path.isfile(path):
        raise ValueError(f"no {MODULE_HUBCONF} found in {repo_dir}")
    spec = importlib.util.spec_from_file_location("hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.dirname(path))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.dirname(path))
    deps = getattr(mod, VAR_DEPENDENCY, [])
    missing = [d for d in deps if importlib.util.find_spec(d) is None]
    if missing:
        raise RuntimeError(f"hub repo requires missing packages: {missing}")
    return mod


def _check_source(source):
    if source not in ("github", "gitee", "local"):
        raise ValueError(
            f"source must be 'github', 'gitee' or 'local', got {source!r}")
    if source != "local":
        raise RuntimeError(
            "paddle_tpu_torch.hub: remote sources need network access, which "
            "this runtime does not use — clone the repo and use "
            "source='local'")


def list(repo_dir, source: str = "github", force_reload: bool = False,
         **kwargs):
    """All entrypoint names a hub repo exposes (hapi/hub.py:185)."""
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    return [k for k, v in vars(mod).items()
            if callable(v) and not k.startswith("_")]


def help(repo_dir, model: str, source: str = "github",
         force_reload: bool = False, **kwargs):
    """Docstring of one entrypoint (hapi/hub.py:235)."""
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    fn = getattr(mod, model, None)
    if fn is None or not callable(fn):
        raise RuntimeError(f"hub entrypoint {model!r} not found")
    return fn.__doc__


def load(repo_dir, model: str, source: str = "github",
         force_reload: bool = False, **kwargs):
    """Call an entrypoint and return its model (hapi/hub.py:283)."""
    _check_source(source)
    mod = _load_hubconf(repo_dir)
    fn = getattr(mod, model, None)
    if fn is None or not callable(fn):
        raise RuntimeError(f"hub entrypoint {model!r} not found")
    return fn(**kwargs)
