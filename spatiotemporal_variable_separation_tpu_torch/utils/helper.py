"""Config I/O helpers (reference ``var_sep/utils/helper.py:54-78``).

The port's own copy of the JAX package's ``utils/helper.py``.  ``DotDict``
here raises ``AttributeError`` on a missing key where the reference returns
``None`` (``__getattr__ = dict.get``), the root of its ``xp_config.dt`` eval
bug; call ``.get(key)`` where a silent default is wanted.  ``yaml`` is
imported only by ``load_yaml``."""

from __future__ import annotations

import json


class DotDict(dict):
    """Dot-notation access to dictionary attributes (strict)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__


def load_json(path: str) -> DotDict:
    with open(path) as f:
        return DotDict(json.load(f))


def load_yaml(path: str) -> DotDict:
    import yaml

    with open(path) as f:
        return DotDict(yaml.safe_load(f))
