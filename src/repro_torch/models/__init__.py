"""Language models of the port: the ``ssm`` (falcon-mamba), ``dense`` and
``moe`` families."""
from . import layers, lm, ssm  # noqa: F401
