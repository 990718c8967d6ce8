"""The package's former name, kept as an alias of `kanodes`.

Importing any submodule under this name returns the very module object
`kanodes` holds (one copy of every class and registry), and
`python -m <this name> ...` runs the `kanodes` CLI. New code imports
`kanodes`.
"""

import importlib
import importlib.abc
import importlib.util
import sys

import kanodes

_OLD, _NEW = __name__, "kanodes"


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolve `<old>.x.y` to the already-importable `kanodes.x.y`."""

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(_OLD + ".") or \
                fullname == _OLD + ".__main__":
            return None
        return importlib.util.spec_from_loader(fullname, self)

    def create_module(self, spec):
        return importlib.import_module(_NEW + spec.name[len(_OLD):])

    def exec_module(self, module):
        pass


sys.meta_path.insert(0, _Alias())
sys.modules[_OLD] = kanodes
