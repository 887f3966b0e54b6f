"""Runtime analysis: the collective-schedule audit and the fleet trace.

The port's part of ``horovod_tpu/analysis``:

* :mod:`sched_audit`: every fused eager dispatch folds into a per-rank
  rolling schedule fingerprint, published through the rendezvous KV on
  the ``HOROVOD_AUDIT_STEPS`` cadence, so that the elastic driver flags
  a rank whose collective schedule diverges (reason
  ``sched_divergence``) before the mismatch hangs a collective;
* :mod:`trace_merge`: one skew-corrected timeline from every process's
  spans (``common/tracing.py``).

The parser and rules over lowered programs (``hlo_parse``, ``rules``)
are not here: their counterpart, an audit of the recorded NCCL call
schedule over ``testing/recorder.py``, is queued (ROADMAP A16's
remainder). Both modules import the standard library only.
"""

from . import sched_audit, trace_merge

__all__ = ["sched_audit", "trace_merge"]
