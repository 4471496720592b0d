"""PyTorch port, data-parallel plumbing (parallel/mesh.py,
parallel/multihost.py, tools/entry.dryrun_multichip), on gloo ranks spawned
as OS processes: the tree collectives (one flat buffer, sums and means in
each leaf's type, a subgroup of the first ranks), rank 0's tree broadcast
bit for bit, `ema_update` with a group against the JAX package's
`axis_name` psum over its virtual data mesh (the test of
tests/test_multichip.py), the toy step over 4 ranks against one device,
the dry run over 2, and the failure rules (no world: the identity; a rank
without its card raises; a dead rank stops every rank at once).  Every
spawn has its own deadline, far below the suite's."""

import time

import numpy as np
import pytest
import torch

from indextts_tpu_torch.models import dvae
from indextts_tpu_torch.parallel import mesh, multihost

DEADLINE_S = 120.0


def _collectives(device, payload):
    """One rank's share of the collective checks (run in a gloo world of 4)."""
    r, n = mesh.rank(), mesh.world()
    group = mesh.data_group()
    tree = {"b": [torch.full((3,), float(r + 1)), torch.tensor([r, 10 * r], dtype=torch.int32)],
            "a": torch.arange(4, dtype=torch.bfloat16) * (r + 1),
            "const": "kept"}
    summed = mesh.all_reduce_tree(tree, group=group)
    mean = mesh.all_reduce_tree(tree, "mean", group)
    gen = torch.Generator().manual_seed(100 + r)
    mine = {"w": torch.randn(5, 3, generator=gen), "step": torch.tensor(7 + r, dtype=torch.int32),
            "h": torch.randn(4, generator=gen).bfloat16()}
    got = mesh.broadcast_tree(mine)
    sub = mesh.subgroup(2)
    sub_sum = (mesh.all_reduce_tree(torch.tensor([float(r + 1)]), group=sub)
               if r < 2 else None)
    rows = slice(r * 16, (r + 1) * 16)
    cb = {k: torch.from_numpy(v) for k, v in payload["codebook"].items()}
    z = torch.from_numpy(payload["z"][rows])
    ema = dvae.ema_update(cb, z, torch.from_numpy(payload["codes"][rows]), group=group)
    return {"summed": summed, "mean": mean, "bcast": got,
            "bcast_sum": multihost.tree_checksum(got), "sub_sum": sub_sum,
            "ema": {k: v.numpy() for k, v in ema.items()},
            "gathered": mesh.all_gather_host([r, 2 * r], group), "world": n,
            "info": mesh.device_info(), "toy": multihost._toy_report(device)}


@pytest.fixture(scope="module")
def ema_inputs():
    rng = np.random.default_rng(0)
    embed = rng.standard_normal((8, 16)).astype(np.float32)
    cb = {"embed": embed, "cluster_size": rng.uniform(0.5, 2.0, 16).astype(np.float32),
          "embed_avg": embed * 1.5}
    z = rng.standard_normal((64, 8)).astype(np.float32)
    codes = dvae.quantize_indices({k: torch.from_numpy(v) for k, v in cb.items()},
                                  torch.from_numpy(z)).numpy()
    return {"codebook": cb, "z": z, "codes": codes}


@pytest.fixture(scope="module")
def four(ema_inputs):
    return multihost.run_ranks("tests.test_torch_parallel:_collectives", 4, ema_inputs,
                               timeout=DEADLINE_S)


def test_tree_collectives_over_four_ranks(four):
    for r, out in enumerate(four):
        assert out["world"] == 4 and out["info"]["process_index"] == r
        assert out["info"]["backend"] == "gloo" and out["info"]["platform"] == "cpu"
        s, m = out["summed"], out["mean"]
        assert s["const"] == "kept" and list(s) == ["a", "b", "const"]
        assert s["a"].dtype == torch.bfloat16 and s["b"][1].dtype == torch.int32
        torch.testing.assert_close(s["a"], torch.arange(4, dtype=torch.bfloat16) * 10,
                                   rtol=0, atol=0)
        torch.testing.assert_close(s["b"][0], torch.full((3,), 10.0), rtol=0, atol=0)
        assert s["b"][1].tolist() == [6, 60]
        torch.testing.assert_close(m["b"][0], torch.full((3,), 2.5), rtol=0, atol=0)
        assert out["gathered"] == [[float(k), 2.0 * k] for k in range(4)]
        assert out["sub_sum"] is None if r >= 2 else out["sub_sum"].tolist() == [3.0]


def test_broadcast_is_rank_0s_tree_bit_for_bit(four):
    gen = torch.Generator().manual_seed(100)
    want = {"w": torch.randn(5, 3, generator=gen), "h": torch.randn(4, generator=gen).bfloat16()}
    for out in four:
        assert torch.equal(out["bcast"]["w"], want["w"]) and torch.equal(out["bcast"]["h"],
                                                                         want["h"])
        assert out["bcast"]["h"].dtype == torch.bfloat16 and int(out["bcast"]["step"]) == 7
        assert out["bcast_sum"] == four[0]["bcast_sum"]
    flipped = {k: v.clone() for k, v in four[0]["bcast"].items()}
    flipped["w"].view(torch.int32)[2, 1] ^= 1
    assert multihost.tree_checksum(flipped) != four[0]["bcast_sum"]


def test_ema_update_with_a_group_matches_jax_psum(four, ema_inputs):
    """Four ranks of 16 rows each against the JAX package's `ema_update`
    under shard_map with axis_name="data" over 4 virtual devices, and
    against the port's one-device update of all 64 rows: 1e-4 relative and
    1e-5 absolute, the tolerance of the JAX package's own psum test."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from indextts_tpu.models import dvae as jax_dvae
    from indextts_tpu.parallel.mesh import make_mesh

    jmesh = make_mesh((("data", 4),), devices=jax.devices()[:4])
    jcb = {k: jnp.asarray(v) for k, v in ema_inputs["codebook"].items()}
    fn = shard_map(lambda c, zz, cc: jax_dvae.ema_update(c, zz, cc, axis_name="data"),
                   mesh=jmesh, in_specs=(P(), P("data"), P("data")), out_specs=P())
    want = fn(jcb, jnp.asarray(ema_inputs["z"]), jnp.asarray(ema_inputs["codes"]))
    one = dvae.ema_update({k: torch.from_numpy(v) for k, v in ema_inputs["codebook"].items()},
                          torch.from_numpy(ema_inputs["z"]),
                          torch.from_numpy(ema_inputs["codes"]))
    for out in four:
        for k in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(out["ema"][k], np.asarray(want[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
            np.testing.assert_allclose(out["ema"][k], one[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            np.testing.assert_array_equal(out["ema"][k], four[0]["ema"][k])


def test_no_world_means_no_collective(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.initialize_distributed("cpu") == torch.device("cpu")
    assert not mesh.is_initialized() and mesh.data_group() is None and mesh.subgroup(1) is None
    assert (mesh.rank(), mesh.world(), mesh.is_main()) == (0, 1, True)
    tree = {"a": torch.ones(2)}
    assert mesh.all_reduce_tree(tree, "mean", None) is tree
    assert mesh.broadcast_tree(tree) is tree
    assert mesh.all_reduce_host([1.5, 2]) == [1.5, 2.0]
    mesh.barrier()
    with pytest.raises(ValueError, match="op"):
        mesh.all_reduce_tree(tree, "max", None)


def test_a_rank_without_its_card_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 3 names no visible card"):
        mesh.initialize_distributed("cuda")
    assert not mesh.is_initialized()


def _dies_on_rank_1(device):
    if mesh.rank() == 1:
        raise SystemExit(3)
    mesh.all_reduce_tree(torch.ones(1), group=mesh.data_group())   # waits for rank 1
    return "unreachable"


def test_a_dead_rank_stops_every_rank_at_once():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 rc=3"):
        multihost.run_ranks("tests.test_torch_parallel:_dies_on_rank_1", 2, timeout=DEADLINE_S)
    assert time.monotonic() - t0 < DEADLINE_S / 2


def test_toy_step_over_four_ranks_matches_one_device(four):
    """launch_check's report, over 4 gloo ranks, against the same global
    batch on one device: 1e-5 relative (fp32, summation order only)."""
    reports = [out["toy"] for out in four]
    assert [r["rank"] for r in reports] == list(range(4))
    assert all(r["world"] == 4 and r["device"] == "cpu" for r in reports)
    one = multihost.run_toy_step(world=4, device="cpu")
    for r in reports:
        assert abs(r["loss"] - one) <= 1e-5 * abs(one)


def test_toy_batch_is_the_jax_packages():
    from indextts_tpu.parallel import multihost as jax_multihost

    for got, want in zip(multihost.toy_batch(4), jax_multihost.toy_batch(4)):
        np.testing.assert_array_equal(got, want)
    assert multihost.TOY == jax_multihost.TOY


def test_dryrun_multichip_on_two_gloo_ranks(capsys):
    from indextts_tpu_torch.tools import entry

    out = entry.dryrun_multichip(2, "cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2) OK: loss=")
    assert f"tp_forward_msq={out['tp_forward_msq']:.4f} tp_decode_codes=8" in line
    assert "dp_pool_ok=None" in line and out["tp_ok"]
    assert out["loss_equal_1rank"] and out["multihost_ok"] and len(out["rank_losses"]) == 2
