"""What may not be loaded in a benchmark process: JAX and the JAX package.

Names are compared by their top-level part (before the first dot), whole:
``unet_implementations_tpu_torch`` is the port and is allowed."""

from __future__ import annotations

import sys
from typing import Iterable, Set

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "unet_implementations_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names: Iterable[str]) -> Set[str]:
    """The forbidden top-level names among module names ``names``."""
    return {top_level(n) for n in names} & FORBIDDEN


def loaded_forbidden() -> Set[str]:
    return forbidden(list(sys.modules))
