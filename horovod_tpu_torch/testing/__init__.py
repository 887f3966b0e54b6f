"""Test aids that ship with the package: deterministic fault injection
(:mod:`.chaos`) and a recorder of the collectives handed to
``torch.distributed`` (:mod:`.recorder`, imported by name where it is
used: it imports torch, and the launcher imports :mod:`.chaos`)."""

from . import chaos  # noqa: F401
