"""The port's exceptions, in a module that imports no torch, so that the
launcher and the elastic driver can raise and catch them without it
(``common/basics.py`` binds them under their usual names)."""


class NotInitializedError(RuntimeError):
    def __init__(self):
        super().__init__(
            "horovod_tpu_torch has not been initialized; call hvd.init() "
            "first."
        )


class HorovodInternalError(RuntimeError):
    """A collective or the training state failed in a way the elastic
    contract restores from (the grad guard's escalation raises it)."""


class HostsUpdatedInterrupt(Exception):
    """The world's membership changed and the current state is still
    good (the elastic contract, ``horovod/common/elastic.py``)."""
