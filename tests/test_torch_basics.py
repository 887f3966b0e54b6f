"""The port's world: ``init``/``shutdown`` on ``torch.distributed``, the
rank layout (rank, size, local and cross) in worlds of 1 and 2, the
process-set table, and the ``HOROVOD_*`` variables landing in the
configuration, against the JAX package's contract
(horovod_tpu/common/{basics,topology,process_sets,config}.py)."""

from pathlib import Path

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.config import TrainConfig
from horovod_tpu_torch.common.process_sets import ProcessSet, ProcessSetTable
from horovod_tpu_torch.common.topology import discover, stage_ranks

from test_torch_collectives import _run, file_store

_LAUNCHER_VARS = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                  "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
                  "HOROVOD_CROSS_SIZE", "HOROVOD_INTRA_SIZE")


@pytest.fixture
def clean_env(monkeypatch):
    for name in _LAUNCHER_VARS:
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    hvd.shutdown()


def test_world_of_one_and_reinit(clean_env):
    """No launcher variables: a world of one from an in-process store;
    ``init(); shutdown(); init()`` works."""
    with pytest.raises(hvd.NotInitializedError):
        hvd.rank()
    for _ in range(2):
        hvd.init(device="cpu")
        hvd.init(device="cpu")  # idempotent
        assert hvd.is_initialized()
        assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
                hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
        assert hvd.global_process_set().ranks == [0]
        x = torch.arange(4.0)
        assert torch.equal(hvd.allreduce(x), x)
        assert torch.equal(hvd.allgather(x), x)
        hvd.shutdown()
        assert not hvd.is_initialized()
        assert not torch.distributed.is_initialized()


def test_default_device_is_the_card(clean_env):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        hvd.init()
    assert not hvd.is_initialized()


def test_env_lands_in_config(clean_env):
    env = {"HOROVOD_FUSION_THRESHOLD": "4096", "HOROVOD_CYCLE_TIME": "3.5",
           "HOROVOD_HIERARCHICAL_ALLREDUCE": "1", "HOROVOD_INTRA_SIZE": "4",
           "HOROVOD_RANK": "0", "HOROVOD_SIZE": "1",
           "HOROVOD_GLOO_RENDEZVOUS_ADDR": "127.0.0.1",
           "HOROVOD_GLOO_RENDEZVOUS_PORT": "29555"}
    for k, v in env.items():
        clean_env.setenv(k, v)
    cfg = TrainConfig.from_env()
    assert (cfg.fusion_threshold_bytes, cfg.cycle_time_ms,
            cfg.hierarchical_allreduce, cfg.intra_size, cfg.rank, cfg.size,
            cfg.rendezvous_addr, cfg.rendezvous_port) == (
        4096, 3.5, True, 4, 0, 1, "127.0.0.1", 29555)
    assert TrainConfig().fusion_threshold_bytes == 64 * 1024 * 1024
    hvd.init(device="cpu")  # a world of one opens no port
    state = basics.state()
    assert state.fusion.threshold_bytes == 4096
    assert state.config.cycle_time_ms == 3.5
    assert hvd.local_size() == 1  # intra 4 degrades to gcd(4, 1)
    clean_env.setenv("HOROVOD_FUSION_THRESHOLD", "lots")
    with pytest.raises(ValueError, match="HOROVOD_FUSION_THRESHOLD"):
        TrainConfig.from_env()


def test_topology_intra_override_and_gcd():
    topo = discover(5, 6, TrainConfig(intra_size=4))  # gcd(4, 6) = 2
    assert (topo.local_size, topo.local_rank, topo.cross_rank,
            topo.cross_size) == (2, 1, 2, 3)
    topo = discover(6, 8, TrainConfig(local_size=4, local_rank=2))
    assert (topo.local_rank, topo.cross_rank, topo.cross_size) == (2, 1, 2)
    assert discover(1, 2, TrainConfig()).local_size == 2  # one node
    with pytest.raises(ValueError, match="HOROVOD_SIZE=3"):
        discover(1, 2, TrainConfig(size=3))
    with pytest.raises(ValueError, match="HOROVOD_LOCAL_RANK"):
        discover(5, 8, TrainConfig(local_size=4, local_rank=0))
    intra, inter = stage_ranks(8, 4)
    assert intra == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert inter == [[0, 4], [1, 5], [2, 6], [3, 7]]


def test_process_set_table():
    made = []
    table = ProcessSetTable(4, new_group=lambda ranks: made.append(ranks)
                            or tuple(ranks))
    assert table.global_set.process_set_id == 0 and made == []
    ps = table.register(ProcessSet([2, 0]))
    assert (ps.process_set_id, ps.ranks, ps.group) == (1, [0, 2], (0, 2))
    assert table.register(ProcessSet([0, 2])) is ps  # dedupe by ranks
    assert ps.rank_in_set(2) == 1 and not ps.included(1)
    with pytest.raises(ValueError, match="out of range"):
        table.register(ProcessSet([0, 4]))
    with pytest.raises(ValueError, match="duplicate"):
        ProcessSet([1, 1])
    with pytest.raises(ValueError, match="global"):
        table.remove(table.global_set)
    table.remove(ps)
    assert table.ids() == [0] and ps.process_set_id is None


def _world_worker(rank, n, outdir):
    import torch.distributed as dist

    out = {}
    for cycle in range(2):  # init; shutdown; init in a world of 2
        hvd.init(device="cpu",
                 store=file_store(Path(outdir) / f"c{cycle}", n))
        out[cycle] = (hvd.rank(), hvd.size(), hvd.local_rank(),
                      hvd.local_size(), hvd.cross_rank(), hvd.cross_size())
        state = basics.state()
        x = torch.full((2,), float(rank + 1))
        intra, inter = x.clone(), x.clone()
        dist.all_reduce(intra, group=state.intra_group)
        dist.all_reduce(inter, group=state.inter_group)
        out[f"groups{cycle}"] = (intra, inter)
        hvd.shutdown()
    torch.save(out, Path(outdir) / f"rank{rank}.pt")


@pytest.mark.parametrize("local_size", [1, 2])
def test_world_of_two(tmp_path, local_size):
    """Two ranks as two nodes of one (HOROVOD_LOCAL_SIZE=1) or one node
    of two: the layout and the two-level groups follow."""
    for c in range(2):
        (tmp_path / f"c{c}").mkdir()
    outs = _run(tmp_path, 2, Path(__file__), "_world_worker", 180,
                {"HOROVOD_LOCAL_SIZE": str(local_size)})
    for r, o in enumerate(outs):
        for cycle in range(2):
            assert o[cycle] == (r, 2, r % local_size, local_size,
                                r // local_size, 2 // local_size)
            intra, inter = o[f"groups{cycle}"]
            if local_size == 1:  # intra is the rank alone
                assert torch.equal(intra, torch.full((2,), r + 1.0))
                assert torch.equal(inter, torch.full((2,), 3.0))
            else:
                assert torch.equal(intra, torch.full((2,), 3.0))
                assert torch.equal(inter, torch.full((2,), r + 1.0))
