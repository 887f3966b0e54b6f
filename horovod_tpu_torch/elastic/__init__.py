"""Elastic training: survive failures and changes of the world.

The counterpart of ``horovod_tpu/elastic/`` (the reference's Elastic
Horovod). As in the JAX package, a change of the world is a gang
restart: the driver (``driver.py``, started by ``python -m
horovod_tpu_torch.runner --host-discovery-script ...``) relaunches the
workers on the hosts that are left or new, and the training loop
resumes from its last commit (``checkpoint.DurableTorchState`` across
processes); a failure the process survives (the grad guard's
escalation, ``HorovodInternalError``) restores in place:

    import horovod_tpu_torch as hvd

    state = hvd.elastic.TorchState(model, opt, step=0)

    @hvd.elastic.run
    def train(state):
        while state.step < total_steps:
            ...
            state.step += 1
            state.commit()

    train(state)
"""

# Every public name, by the module that defines it: imported at first use
# (PEP 562), so the elastic launcher (``runner`` with
# ``--host-discovery-script``), which needs the driver alone, starts
# without torch.
_EXPORTS = {
    ".discovery": ("FixedHosts", "HostDiscovery", "HostDiscoveryScript",
                   "HostManager"),
    ".driver": ("ElasticDriver", "SlotAssignment"),
    ".state": ("ElasticSampler", "ObjectState", "State", "TorchState"),
    ".worker": ("WorkerNotificationManager", "WorkerNotificationService",
                "expert_loads", "notification_manager",
                "publish_expert_load", "rebalance_weight",
                "rebalance_weights", "run"),
}
_WHERE = {n: mod for mod, names in _EXPORTS.items() for n in names}
__all__ = sorted(_WHERE)


def __getattr__(name: str):
    """Import a public name at its first use."""
    import importlib

    if name not in _WHERE:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_WHERE[name], __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
