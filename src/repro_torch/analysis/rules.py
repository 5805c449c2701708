"""Import-for-effect module: pulling this in registers the full rule
catalogue.  New rule modules get one line here and nowhere else."""
from . import (aliasing, layering, locks, retrace, stateshape,  # noqa: F401
               trace_safety)
