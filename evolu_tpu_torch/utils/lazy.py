"""A package's lazy attributes (PEP 562): each name imports its module on
first access, so that importing the package loads nothing else."""

from __future__ import annotations

import importlib
from typing import Dict, Tuple


def lazy_getattr(package: str, names: Dict[str, Tuple[str, str]]):
    """→ the package's `__getattr__` for `names`: {name: (module, attribute)}."""

    def __getattr__(name):
        if name in names:
            module, attr = names[name]
            return getattr(importlib.import_module(module), attr)
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    return __getattr__
