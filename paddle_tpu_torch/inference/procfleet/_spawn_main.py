"""Worker launch shim: ``python -m paddle_tpu_torch.inference.procfleet.
_spawn_main``.

A separate entry module (instead of ``-m ...worker``) so runpy never
executes a module the package ``__init__`` already imported — the child
imports the package once, then runs the CLI."""

from .worker import _cli

if __name__ == "__main__":
    _cli()
