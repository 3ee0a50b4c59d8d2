"""Load the JAX package's pure host modules by file path.

``fdoct_tpu/__init__.py`` imports :class:`fdoct_tpu.calibration.Calibration`,
which imports ``jax``, so any ``import fdoct_tpu.<module>`` loads JAX.  A few
of its modules import only the standard library and numpy
(``config.py``, ``sources/synthetic.py``, ``utils/profiling.py``); this port
shares them instead of copying them, by executing the file under a private
module name.  That keeps one schema for the configuration and keeps ``jax``
out of ``sys.modules``.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType

#: root of the JAX package, a sibling of this package
REFERENCE_ROOT = Path(__file__).resolve().parent.parent / "fdoct_tpu"

_PREFIX = "_fdoct_tpu_torch_shared."


def load_reference_module(relpath: str) -> ModuleType:
    """Execute ``fdoct_tpu/<relpath>`` as a standalone module and return it.

    The module is registered in ``sys.modules`` before it runs (``@dataclass``
    looks its own module up there), and loaded once per process.
    """
    name = _PREFIX + relpath.removesuffix(".py").replace("/", ".")
    module = sys.modules.get(name)
    if module is not None:
        return module
    path = REFERENCE_ROOT / relpath
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module
