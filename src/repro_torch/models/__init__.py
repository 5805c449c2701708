"""Language models of the port (the ``ssm`` family: falcon-mamba)."""
from . import layers, lm, ssm  # noqa: F401
