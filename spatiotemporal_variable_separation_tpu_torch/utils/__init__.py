"""Weight transfer from the JAX package's variables, profiling, config I/O
helpers and filmstrip rendering; the config helpers are exported here, as
the JAX package's ``utils/__init__.py`` does."""

from spatiotemporal_variable_separation_tpu_torch.utils.helper import (
    DotDict,
    load_json,
    load_yaml,
)

__all__ = ["DotDict", "load_json", "load_yaml"]
