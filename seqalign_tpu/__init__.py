"""The package's former import name, forwarding to :mod:`seqalign`.

Existing ``import`` lines and ``python -m <former name>.cli`` keep working:
every submodule imported under this name is the ``seqalign`` module itself,
not a second copy, so both names share one state.
"""

import importlib
import importlib.abc
import importlib.util
import sys

from seqalign import *  # noqa: F401,F403
from seqalign import __version__  # noqa: F401

_PREFIX = __name__ + "."


def _real(name: str) -> str:
    return "seqalign." + name[len(_PREFIX):]


class _Forward(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Imports ``<former name>.x`` as ``seqalign.x`` under both names."""

    def __init__(self):
        self._specs = {}

    def find_spec(self, name, path=None, target=None):
        if not name.startswith(_PREFIX):
            return None
        real = importlib.util.find_spec(_real(name))
        if real is None:
            return None
        return importlib.util.spec_from_loader(
            name, self, origin=real.origin,  # python -m sets argv[0] to it
            is_package=real.submodule_search_locations is not None,
        )

    def create_module(self, spec):
        module = importlib.import_module(_real(spec.name))
        self._specs[module.__name__] = module.__spec__
        return module

    def exec_module(self, module):
        # Already executed under its own name; the import machinery set
        # the forwarding spec on it, so give it its own back.
        module.__spec__ = self._specs.pop(module.__name__)

    def get_code(self, name):
        """The real module's code, for ``python -m``."""
        real = importlib.util.find_spec(_real(name))
        return real.loader.get_code(real.name)


if not any(isinstance(f, _Forward) for f in sys.meta_path):
    sys.meta_path.insert(0, _Forward())
