"""`parallel/multihost.py` and the process-aware `split_between_processes`
of the port, on the CPU with gloo.

The two-process case starts two interpreters on a port the OS hands out,
each with a timeout of its own (`tools.multiprocess_dryrun.spawn`), so a
hung rank fails the test in seconds."""

import datetime
import json
import os
import sys

import pytest
import torch
import torch.distributed as dist

from reflecting_reality_tpu_torch.parallel import multihost
from reflecting_reality_tpu_torch.parallel.mesh import split_between_processes
from reflecting_reality_tpu_torch.tools.multiprocess_dryrun import free_port, spawn
from tests.test_torch_helpers import one_thread_env, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_launcher_env(monkeypatch):
    for k in multihost.LAUNCH_ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(k, raising=False)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_initialize_is_a_no_op_in_one_process(no_launcher_env):
    multihost.initialize(device="cpu")
    assert not dist.is_initialized()
    assert multihost.rank_and_world() == (0, 1) and multihost.is_main_process()
    multihost.barrier("alone")                   # no group: returns at once
    t = torch.arange(4.0)
    multihost.all_reduce_mean([t])
    multihost.broadcast_from_main([t])
    assert torch.equal(t, torch.arange(4.0))
    assert multihost.local_device("cuda") == torch.device("cuda")
    assert split_between_processes(list(range(5))) == list(range(5))


def test_initialize_from_the_launcher_env_and_again(no_launcher_env, monkeypatch):
    """torchrun's environment for one process starts a group (gloo for the
    CPU); a second call leaves it as it is."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    multihost.initialize(device="cpu")
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    group = dist.group.WORLD
    multihost.initialize(device="cpu")
    assert dist.group.WORLD is group and multihost.rank_and_world() == (0, 1)
    multihost.barrier("one")
    multihost.barrier("one")                     # a name used twice takes a new key


@pytest.mark.parametrize("how", ["init_method", "env"])
def test_a_launch_that_cannot_start_raises(no_launcher_env, monkeypatch, how):
    """Rank 1 of 2 with nobody at the address: it must raise, never carry
    on as one process."""
    timeout = datetime.timedelta(seconds=2)
    if how == "env":
        monkeypatch.setenv("RANK", "1")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(free_port()))
        kw = dict(timeout=timeout)
    else:
        kw = dict(init_method=f"tcp://127.0.0.1:{free_port()}", rank=1, world_size=2,
                  timeout=timeout)
    with pytest.raises(Exception):
        multihost.initialize(device="cpu", **kw)
    assert not dist.is_initialized()


WORKER = """
import json, sys, datetime, torch
from reflecting_reality_tpu_torch.parallel import multihost
from reflecting_reality_tpu_torch.parallel.mesh import split_between_processes
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
multihost.initialize(backend="gloo", device="cpu", init_method=f"tcp://127.0.0.1:{port}",
                     rank=rank, world_size=2, timeout=datetime.timedelta(seconds=60))
grads = [torch.full((3,), float(rank + 1)), torch.arange(5.0) * (rank + 1)]
multihost.all_reduce_mean(grads)
params = [torch.full((2,), float(10 + rank))]
multihost.broadcast_from_main(params)
multihost.barrier("written")
json.dump({"rank_world": list(multihost.rank_and_world()),
           "main": multihost.is_main_process(),
           "split": split_between_processes(list(range(7))),
           "split_explicit": split_between_processes(list(range(7)), 0, 3),
           "shard": multihost.local_shard("abcde"),
           "grads": [g.tolist() for g in grads], "params": params[0].tolist()},
          open(f"{out}/r{rank}.json", "w"))
multihost.barrier("done")
"""


def test_two_processes_split_reduce_and_broadcast(tmp_path):
    port = str(free_port())
    spawn([[sys.executable, "-c", WORKER, str(r), port, str(tmp_path)] for r in range(2)],
          [str(tmp_path / f"log{r}.txt") for r in range(2)], timeout_s=90, env=one_thread_env(),
          cwd=ROOT)
    r0, r1 = (json.load(open(tmp_path / f"r{r}.json")) for r in range(2))
    assert (r0["rank_world"], r1["rank_world"]) == ([0, 2], [1, 2])
    assert r0["main"] and not r1["main"]
    # the group's rank picks the rows; explicit arguments still win
    assert (r0["split"], r1["split"]) == ([0, 1, 2, 3], [4, 5, 6])
    assert r0["split_explicit"] == r1["split_explicit"] == [0, 1, 2]
    assert (r0["shard"], r1["shard"]) == (["a", "b", "c"], ["d", "e"])
    for r in (r0, r1):
        assert r["grads"] == [[1.5] * 3, [0.0, 1.5, 3.0, 4.5, 6.0]]
        assert r["params"] == [10.0, 10.0]
