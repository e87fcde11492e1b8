"""Lazy exports for a package (PEP 562).

    __getattr__, __dir__ = lazy(__name__, globals(), _EXPORTS)

`exports` maps a public name to the submodule (relative, as ".ops") that
defines it, or to None for a submodule exported under its own name. The
submodule is imported on first attribute access, so a package whose
stdlib-only modules a torch-free process reads (the runtime's root, the
simulator) does not import torch until a torch-backed name is asked for.
"""
import importlib


def lazy(package: str, namespace: dict, exports: dict):
    def __getattr__(name):
        if name not in exports:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        target = exports[name]
        if target is None:                # a submodule exported by name
            return importlib.import_module(f".{name}", package)
        return getattr(importlib.import_module(target, package), name)

    def __dir__():
        return sorted(set(namespace) | set(exports))

    return __getattr__, __dir__
