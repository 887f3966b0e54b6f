"""The KV managers' slot queries (``owner``, ``active_slots``,
``length``, ``capacity_left``) of ``horovod_tpu_torch/serving/
kv_cache.py``, held against the JAX package's managers (oracle
tests/test_serving.py's allocator lifecycle and steady-state rounds):
one sequence of allocations, lengths and frees goes through both, on
the slab and on the paged pool, and every query agrees after every
operation."""

import numpy as np
import pytest
import torch

SLOTS, MAX_LEN, PAGE = 3, 16, 4


def _managers(paged):
    import jax.numpy as jnp

    from horovod_tpu.serving.kv_cache import create_kv_manager as jcreate
    from horovod_tpu_torch.serving.kv_cache import create_kv_manager

    def jfac(b, s):
        return [{"k": jnp.zeros((b, s, 2, 4)), "v": jnp.zeros((b, s, 2, 4))}]

    def tfac(b, s):
        return [{"k": torch.zeros((b, s, 2, 4)),
                 "v": torch.zeros((b, s, 2, 4))}]

    kw = dict(paged=paged, page_tokens=PAGE, num_pages=0,
              prefix_cache=False, watermark=-1)
    return (jcreate(jfac, SLOTS, MAX_LEN, **kw),
            create_kv_manager(tfac, SLOTS, MAX_LEN, **kw))


def _view(mgr):
    return {
        "active": list(mgr.active_slots()),
        "owners": [mgr.owner(s) for s in range(SLOTS)],
        "lengths": [mgr.length(s) for s in range(SLOTS)],
        "left": [mgr.capacity_left(s) for s in range(SLOTS)],
        "stats": mgr.stats()["slots_active"],
    }


def _ops():
    rng = np.random.default_rng(0)
    ops = []
    for i in range(24):
        kind = rng.choice(["alloc", "alloc", "set", "advance", "free"])
        ops.append((str(kind), f"r{i}", int(rng.integers(0, SLOTS)),
                    int(rng.integers(0, MAX_LEN + 1))))
    return ops


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_slot_queries_equal_the_reference(paged):
    jm, tm = _managers(paged)
    assert _view(jm) == _view(tm)
    for kind, owner, slot, n in _ops():
        if kind == "alloc":
            assert jm.alloc(owner) == tm.alloc(owner)
        elif kind == "free":
            jm.free(slot)
            tm.free(slot)
        elif slot in jm.active_slots():
            if kind == "set":
                jm.set_length(slot, n)
                tm.set_length(slot, n)
            elif jm.capacity_left(slot):
                assert jm.advance(slot) == tm.advance(slot)
        assert _view(jm) == _view(tm), (kind, owner, slot, n)


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_allocator_lifecycle(paged):
    """tests/test_serving.py::test_slot_allocator_lifecycle on the
    port's managers."""
    _, mgr = _managers(paged)
    a, b = mgr.alloc("r1"), mgr.alloc("r2")
    assert mgr.owner(a) == "r1" and mgr.owner(b) == "r2"
    mgr.set_length(a, 5)
    assert mgr.length(a) == 5 and mgr.capacity_left(a) == MAX_LEN - 5
    with pytest.raises(ValueError):
        mgr.set_length(a, MAX_LEN + 1)
    mgr.free(a)
    assert mgr.active_slots() == [b]
    assert mgr.length(a) == 0 and mgr.owner(a) is None
