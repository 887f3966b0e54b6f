"""Test aids that ship with the package: deterministic fault injection
(:mod:`.chaos`) and a recorder of the collectives handed to
``torch.distributed`` (:mod:`.recorder`)."""

from . import chaos, recorder  # noqa: F401
