# analysis-virtual-path: models/mixer.py
"""LP003 bad: the port reaching into the JAX package or JAX itself — the
port imports nothing of either, in any subsystem."""
import jax  # FLAG: LP003
import jax.numpy as jnp  # FLAG: LP003
import repro  # FLAG: LP003
from repro.models import layers  # FLAG: LP003
from repro_torch.models import lm
from jax.sharding import PartitionSpec  # FLAG: LP003


def mix(x):
    return jax, jnp, repro, layers, lm, PartitionSpec, x
