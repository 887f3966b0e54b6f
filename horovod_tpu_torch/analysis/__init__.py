"""Runtime analysis: the collective-schedule audit and the fleet trace.

The port's part of ``horovod_tpu/analysis``:

* :mod:`sched_audit`: every fused eager dispatch folds into a per-rank
  rolling schedule fingerprint, published through the rendezvous KV on
  the ``HOROVOD_AUDIT_STEPS`` cadence, so that the elastic driver flags
  a rank whose collective schedule diverges (reason
  ``sched_divergence``) before the mismatch hangs a collective;
* :mod:`trace_merge`: one skew-corrected timeline from every process's
  spans (``common/tracing.py``);
* :mod:`fx_parse` and :mod:`rules`: the collective-program audit, the
  counterpart of ``hlo_parse`` and ``rules``, over FX graphs of a
  compiled step or the eager calls ``testing/recorder.py`` records
  (``scripts/hlo_audit_torch.py`` runs its roster).

``sched_audit`` and ``trace_merge`` import the standard library only,
``fx_parse`` and ``rules`` torch as well, inside the functions that
need it.
"""

from . import fx_parse, rules, sched_audit, trace_merge

__all__ = ["fx_parse", "rules", "sched_audit", "trace_merge"]
