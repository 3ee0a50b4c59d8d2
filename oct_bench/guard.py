"""The JAX-free guard: no run may load JAX or the JAX package.

Modules are compared by their whole top-level name, the part before the
first dot: the port, ``fdoct_tpu_torch``, begins with the JAX package's
name, ``fdoct_tpu``, and is not a match.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fdoct_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default ``sys.modules``)."""
    names = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & FORBIDDEN)
