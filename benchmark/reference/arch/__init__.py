"""One file an architecture, named as a configuration's ``architecture``
names it: ``spec(cfg)``, the leaves of its parameters in the order the
weights are drawn, and ``Model``, a ``models.Separable`` with its encoders,
decoder and Euler step."""
