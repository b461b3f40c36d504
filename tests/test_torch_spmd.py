"""One device's program of a grid (``launch/spmd.py``,
``sharding/rules.py``'s placements, ``cost_utils.StepCounter``'s
``per_device`` mode): the fake process group's lifetime, placement by
the sharding rules, the counter on hand cases, and the exact cases of
the dry run: a (1, 1) grid counts what one controller counts, and a
(4, 1) grid splits a dense train step's products four ways and reduces
its gradients.

The comparison with XLA's partitioned programs is in
``tests/test_torch_dryrun.py``, which builds the reference once.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun, spmd
from repro_torch.launch.cost_utils import (StepCounter, collective_bytes,
                                           shape_bytes, shard_bytes)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_step
from repro_torch.models import moe
from repro_torch.sharding.rules import (NamedSharding, P, constrain,
                                        local_over, place, placements)
from repro_torch.tree import flat_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

META = torch.device("meta")

# pairs whose per-device count on a (1, 1) grid is held to the
# one-controller count (a family each; train steps cut to one layer)
ONE_BY_ONE = [("qwen2_1_5b", "train_4k", 1), ("whisper_medium", "train_4k", 1),
              ("dbrx_132b", "train_4k", 1), ("minicpm3_4b", "decode_32k", 0),
              ("rwkv6_3b", "long_500k", 0),
              ("recurrentgemma_2b", "decode_32k", 0),
              ("dbrx_132b", "decode_32k", 0)]
KEYS = ("flops", "bytes", "transcendentals", "peak_bytes", "temp_bytes",
        "arg_bytes", "out_bytes", "alias_bytes")


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_fake_grid_lives_only_inside_its_block():
    assert not dist.is_initialized()
    with spmd.fake_grid((4, 2), ("data", "model")) as grid:
        assert dist.is_initialized() and dist.get_world_size() == 8
        assert grid.mesh_dim_names == ("data", "model")
        assert tuple(grid.shape) == (4, 2)
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with spmd.grid_of(make_host_mesh(2, 2, device=META)):
            raise ValueError("inside")
    assert not dist.is_initialized()


def test_fake_grid_refuses_a_group_already_up():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=2, store=FakeStore())
    try:
        with pytest.raises(RuntimeError, match="already up"):
            with spmd.fake_grid((2,), ("data",)):
                pass
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_placements_from_specs():
    from torch.distributed.tensor import Replicate, Shard
    with spmd.fake_grid((4, 2, 1), ("data", "model", "pod")) as grid:
        def pl(*spec):
            return placements(NamedSharding(None, P(*spec)), grid)
        assert pl() == [Replicate()] * 3
        assert pl("data", "model") == [Shard(0), Shard(1), Replicate()]
        assert pl(None, ("data", "model")) == [Shard(1), Shard(1),
                                               Replicate()]
        # an axis of one device, or one the grid lacks, replicates
        assert pl(("pod", "data")) == [Shard(0), Replicate(), Replicate()]
        assert pl("expert") == [Replicate()] * 3


@pytest.mark.parametrize("arch,shape", [("qwen2_1_5b", "train_4k"),
                                        ("minicpm3_4b", "decode_32k"),
                                        ("recurrentgemma_2b", "prefill_32k")])
def test_placed_local_bytes_equal_shard_bytes(arch, shape):
    """Each argument leaf placed by the rules holds, as its local tensor,
    exactly ``shard_bytes`` of it: the dry run's per-device argument
    bytes are the local tensors' bytes."""
    mesh = make_host_mesh(4, 2, device=META)
    built = build_step(arch, shape, mesh, cfg=get_reduced(arch))
    with spmd.grid_of(mesh) as grid:
        placed = place(built["args"], built["in_shardings"], grid)
        n = 0
        for got, leaf, sh in _zip(placed, built["args"],
                                  built["in_shardings"]):
            if isinstance(leaf, torch.Tensor):
                local = got.to_local()
                assert shape_bytes(local.shape, local.dtype) == \
                    shard_bytes(leaf, sh)
                assert tuple(got.shape) == tuple(leaf.shape)
                n += 1
        assert n > 10


def _zip(a, b, c):
    if isinstance(a, dict):
        for k in a:
            yield from _zip(a[k], b[k], c[k])
    elif isinstance(a, (tuple, list)):
        for x, y, z in zip(a, b, c):
            yield from _zip(x, y, z)
    elif a is not None:
        yield a, b, c


def test_counter_counts_local_ops_and_collectives_in_dispatch():
    """Trap 1: DTensor ops reach the counter at global shapes; the
    counter counts the local products instead. Trap 2: the collective
    DTensor issues inside an op's dispatch (a contracted ``Shard`` gives
    a ``Partial``, resolved when it is read whole) is counted."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with spmd.fake_grid((4, 2), ("data", "model")) as grid:
        a = DTensor.from_local(_m(32, 64), grid, [Shard(0), Shard(1)],
                               run_check=False)         # (128, 128)
        w = DTensor.from_local(_m(64, 96), grid, [Replicate(), Shard(0)],
                               run_check=False)         # (128, 96)
        c = StepCounter(a, w, per_device=True)
        c.run(lambda a, w: (a @ w).redistribute(
            grid, [Shard(0), Replicate()]), a, w)
        assert c.flops == 2 * 32 * 64 * 96              # the local product
        # the (32, 96) partial sums over model, reduced once
        assert c.collective_counts["all-reduce"] == 1
        assert c.collectives["all-reduce"] == 32 * 96 * 4
        assert c.base_bytes == (32 * 64 + 64 * 96) * 4
        assert c.out.to_local().shape == (32, 96)
        assert c.fallbacks == {}


def test_op_without_strategy_runs_replicated_and_is_named():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with spmd.fake_grid((4, 2), ("data", "model")) as grid:
        keys = DTensor.from_local(_m(16, dtype=torch.int64), grid,
                                  [Shard(0), Replicate()], run_check=False)
        c = StepCounter(keys, per_device=True)
        c.run(lambda k: torch.searchsorted(k, k), keys)
        assert c.fallbacks == {"aten.searchsorted.Tensor": 1}
        assert c.collectives["all-gather"] >= 64 * 8
        assert tuple(c.out.placements) == (Replicate(), Replicate())
        assert c.out.to_local().shape == (64,)


def test_sharding_sites_are_no_ops_on_one_controller():
    x = torch.randn(4, 3, 8)
    assert constrain(x, P(("data", "model"), None, None)) is x
    assert local_over(torch.cumsum, (x, 1), ("btc", ""), "btc", "bc") \
        .equal(torch.cumsum(x, 1))


def test_local_over_runs_each_devices_shard():
    """On a grid, ``fn`` runs on the device's batch shard (a recurrence
    along time, whole there): the batch's split over ``data`` kept, and
    the ``model`` axis, which splits nothing, splitting the batch too
    (a local chunk, no exchange)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = torch.randn(8, 5, 3)
    with spmd.fake_grid((4, 2), ("data", "model")) as grid:
        xd = DTensor.from_local(x[:2].clone(), grid, [Shard(0), Replicate()],
                                run_check=False)
        c = StepCounter(xd, per_device=True)
        y = c.run(lambda xd: local_over(lambda t: torch.cumsum(t, 1), (xd,),
                                        ("btc",), "btc", "b"), xd)
        assert tuple(y.placements) == (Shard(0), Shard(0))
        assert torch.equal(y.to_local(), torch.cumsum(x[:1], 1))
        assert collective_bytes(c)["total"] == 0
        z = constrain(xd, P(("data", "model"), None, None))
        assert tuple(z.placements) == (Shard(0), Shard(0))
        assert z.to_local().shape == (1, 5, 3)


@pytest.mark.parametrize("arch,shape,n_layers", ONE_BY_ONE)
def test_one_by_one_grid_counts_what_one_controller_counts(arch, shape,
                                                           n_layers):
    cfg = get_reduced(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    mesh = make_host_mesh(1, 1, device=META)
    _, pd = dryrun.count_step(arch, shape, mesh, cfg=cfg, per_device=True)
    _, whole = dryrun.count_step(arch, shape, mesh, cfg=cfg)
    for k in KEYS:
        assert pd[k] == whole[k], (k, pd[k], whole[k])
    assert pd["collectives"]["total"] == whole["collectives"]["total"] == 0
    assert pd["fallbacks"] == {}


def test_data_parallel_grid_splits_the_step_and_reduces_gradients():
    """A dense train step on a (4, 1) grid: every product a quarter of
    the whole step's; the gradients of the replicated params all-reduced
    (their bytes, in their dtype, and the loss's 4), but the embedding's,
    whose scatter from the batch-sharded tokens DTensor splits over the
    hidden dim (an all-to-all of the token gradients, the tokens
    gathered) and reduces as a reduce-scatter and an all-gather."""
    cfg = get_reduced("qwen2_1_5b").replace(n_layers=1)
    mesh = make_host_mesh(4, 1, device=META)
    built, pd = dryrun.count_step("qwen2_1_5b", "train_4k", mesh, cfg=cfg,
                                  per_device=True)
    _, whole = dryrun.count_step("qwen2_1_5b", "train_4k", mesh, cfg=cfg)
    assert pd["flops"] * 4 == whole["flops"]
    params = flat_params(built["args"][0])
    grads = {k: shape_bytes(v.shape, v.dtype) for k, v in params.items()}
    embed = grads.pop("embed")
    c = pd["collectives"]
    assert c["all-reduce"] == sum(grads.values()) + 4
    assert c["reduce-scatter"] == embed // 4
    B, S = built["args"][2]["tokens"].shape
    assert c["all-gather"] == embed + B * S * 8
    assert c["all-to-all"] == B * S * cfg.d_model * 2 // 4


def test_moe_exchanges_one_devices_share():
    """``moe_apply_ep`` on a (2, 2) grid runs one device's body: its
    chunks' four all-to-alls each, a partial sum over the ff axis a
    chunk and the aux loss's mean over the token axis; each exchange
    one device's share of what one controller counts over the mesh."""
    cfg = get_reduced("dbrx_132b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_chunks=2))
    m, D, T = cfg.moe, cfg.d_model, 32
    E, F = m.n_experts, m.d_ff
    params = {"w_router": _m(D, E), "w_gate": _m(E, D, F),
              "w_up": _m(E, D, F), "w_down": _m(E, F, D)}
    x = _m(T, D)
    mesh = make_host_mesh(2, 2, device=META)
    whole = StepCounter(params, x)
    with torch.no_grad():
        whole.run(lambda p, x: moe.moe_apply_ep(p, x, cfg, mesh), params, x)
    sh = {"w_router": P(), "w_gate": P("data", None, "model"),
          "w_up": P("data", None, "model"), "w_down": P("data", "model")}
    with spmd.grid_of(mesh) as grid:
        pp = place(params, {k: NamedSharding(mesh, v) for k, v in sh.items()},
                   grid)
        xd = place(x, NamedSharding(mesh, P("data")), grid)
        c = StepCounter(pp, xd, per_device=True)
        with torch.no_grad():
            c.run(lambda p, x: moe.moe_apply_ep(p, x, cfg, mesh), pp, xd)
        y, aux = c.out
        assert y.to_local().shape == (T // 2, D) and tuple(y.shape) == (T, D)
    got, one = collective_bytes(c), collective_bytes(whole)
    dp, chunks = 2, 2
    assert got["counts"]["all-to-all"] == 4 * chunks
    assert got["all-to-all"] * dp == one["all-to-all"]
    assert got["counts"]["all-reduce"] == chunks + 1
    assert (got["all-reduce"] - 4) * dp == one["all-reduce"]
    assert c.fallbacks == {}
    # each device computes its token shard's products once; the router's
    # too, which both ff shards of a token shard run
    assert c.flops * 4 == whole.flops + 2 * T * D * E
