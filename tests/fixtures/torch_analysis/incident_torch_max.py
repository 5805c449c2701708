# analysis-virtual-path: engine/runtime.py
"""Incident fixture — per-result device reductions in a recorder event.

The reference's first cut of the engine instrumentation computed the
convergence gauge with ``jnp.max`` while building the recorder event, and
every recorded superstep dispatched a fresh single-op XLA computation
(its observability benchmark blew the 3% overhead budget).  The port's
first ``PendingResult.result`` did the same in torch: the batched lanes'
counters were reduced with ``torch.as_tensor(...).max()`` and ``.all()``
inside the ``engine.result`` event — two launches and two device reads
per served result.  The fix reduces host copies; TS001 must flag the
original forever."""
import torch

from repro_torch import obs as _obs


def result(steps, local_iters, converged, ex):
    rec = _obs.get()
    if rec.enabled:
        rec.event("engine.result", supersteps=steps,
                  local_iters=int(torch.as_tensor(local_iters).max()),  # FLAG: TS001
                  converged=bool(torch.as_tensor(converged).all()),
                  exchanged=steps * ex)
    return steps
