"""The port's process-group helpers (`clibd_tpu_torch/parallel/mesh.py`) on
two gloo ranks on the CPU (`tests/torch_ranks.py`, started once for the
file): the all-gather's forward and gradient, `all_hosts_agree`,
`broadcast_from_main` of a nest of params, optimizer state and numbers,
`all_reduce_grads`, a rank's shard; in this process `pad_to_multiple`
against the JAX package's, the backend chosen by the device, and the
rendezvous read from torchrun's environment.  Every input is drawn here from
a seeded generator.
"""

import numpy as np
import pytest
import torch

from clibd_tpu.parallel import mesh as jax_mesh
from clibd_tpu_torch import parallel
from clibd_tpu_torch.parallel import mesh as port_mesh
from tests.torch_ranks import run_ranks

W, B, D = 2, 3, 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(31)
    data = {"x": rng.standard_normal((W, B, D)).astype(np.float32),
            "w": rng.standard_normal((W, W * B, D)).astype(np.float32)}
    return data, run_ranks(W, ["parallel"], data, tmp_path_factory.mktemp("parallel"))


def test_ranks_run_gloo_on_the_cpu(ranks):
    _, out = ranks
    assert [o["parallel"]["backend"] for o in out] == ["gloo"] * W
    assert [(o["parallel"]["rank"], o["parallel"]["world"]) for o in out] == [(0, W), (1, W)]


def test_all_gather_with_grad_forward_and_gradient(ranks):
    """Forward: every rank's rows in rank order.  Backward: rank r's rows of
    the gradient summed over the ranks (lax.all_gather's transpose)."""
    data, out = ranks
    want = np.concatenate(list(data["x"]))
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["parallel"]["gathered"].numpy(), want)
        grad = sum(w[r * B:(r + 1) * B] for w in data["w"])
        np.testing.assert_allclose(o["parallel"]["x_grad"].numpy(), grad, rtol=1e-6)


@pytest.mark.parametrize("case,want", [("agree_all", True), ("agree_one_false", False)])
def test_all_hosts_agree(ranks, case, want):
    assert [o["parallel"][case] for o in ranks[1]] == [want] * W


def test_broadcast_from_main_is_exact_and_keeps_the_types(ranks):
    got = ranks[1][1]["parallel"]["broadcast"]
    main = ranks[1][0]["parallel"]["broadcast"]
    assert torch.equal(got["params"]["qkv"], torch.full((3, 2), 0.5))
    assert torch.equal(got["params"]["ids"], torch.arange(4))
    assert got["params"]["ids"].dtype == torch.int64
    assert isinstance(got["opt"]["mu"], np.ndarray) and got["opt"]["mu"].dtype == np.float32
    np.testing.assert_array_equal(got["opt"]["mu"], np.zeros(5, np.float32))
    assert got["opt"]["count"].dtype == np.int32 and int(got["opt"]["count"]) == 7
    assert got["ints"] == [1, (2, 3)] and got["metric"] == 0.25 and got["flag"] is False
    assert torch.equal(main["params"]["qkv"], got["params"]["qkv"]) and main["ints"] == [1, (2, 3)]


@pytest.mark.parametrize("op", ["mean", "sum"])
def test_all_reduce_grads(ranks, op):
    scale = 1.5 if op == "mean" else 3.0  # (1 + 2) / 2 or 1 + 2
    for o in ranks[1]:
        g0, g1, g2 = o["parallel"]["reduced"][op]
        assert torch.equal(g0, torch.full((3,), scale))
        assert torch.equal(g1, torch.arange(4.0).view(2, 2) * scale)
        assert g2 is None


def test_local_shard_is_the_ranks_block(ranks):
    for r, o in enumerate(ranks[1]):
        np.testing.assert_array_equal(o["parallel"]["shard"]["a"],
                                      np.arange(8).reshape(4, 2)[2 * r:2 * r + 2])


@pytest.mark.parametrize("multiple", [1, 3, 4, 8])
def test_pad_to_multiple_matches_jax(multiple):
    rng = np.random.default_rng(multiple)
    batch = {"image": rng.random((5, 2, 2, 3), dtype=np.float32),
             "language": {"input_ids": rng.integers(0, 9, (5, 4)).astype(np.int32)}}
    got, n = port_mesh.pad_to_multiple(batch, multiple)
    want, n_jax = jax_mesh.pad_to_multiple(batch, multiple)
    assert n == n_jax == 5
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["language"]["input_ids"], want["language"]["input_ids"])


def test_the_backend_follows_the_requested_device(monkeypatch):
    """NCCL for "cuda", gloo for "cpu" or where the caller names it; the
    card is selected from LOCAL_RANK before the group starts; nothing
    starts without torchrun's environment or with
    CLIBD_DISABLE_DISTRIBUTED."""
    assert parallel.backend_for("cuda") == "nccl" and parallel.backend_for("cuda:1") == "nccl"
    assert parallel.backend_for("cpu") == "gloo"
    calls = []
    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(port_mesh.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw["rank"],
                                                            kw["world_size"])))
    monkeypatch.setattr(port_mesh.torch.cuda, "set_device", lambda i: calls.append(("card", i)))
    for k in ("WORLD_SIZE", "CLIBD_MULTIHOST", "CLIBD_DISABLE_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert not parallel.maybe_initialize_distributed("cuda") and calls == []
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert parallel.maybe_initialize_distributed("cuda")
    assert parallel.maybe_initialize_distributed("cpu")
    assert parallel.maybe_initialize_distributed("cuda", backend="gloo")
    assert calls == [("card", 1), ("nccl", 3, 4), ("gloo", 3, 4), ("card", 1), ("gloo", 3, 4)]
    monkeypatch.setenv("CLIBD_DISABLE_DISTRIBUTED", "1")
    assert not parallel.maybe_initialize_distributed("cuda") and len(calls) == 5


def test_meshes_outside_a_group():
    """Without a group: create_mesh is the one device, a list of devices
    is a local mesh (one device may be named twice), and the collectives
    are the identity."""
    mesh = parallel.create_mesh(device="cpu")
    assert mesh.size == 1 and mesh.group is None and not parallel.mesh_is_multiprocess(mesh)
    two = parallel.create_mesh(["cpu", "cpu"])
    assert two.size == 2 and two.devices == (torch.device("cpu"),) * 2
    assert parallel.local_mesh("cpu").devices == (torch.device("cpu"),)
    x = torch.ones(2, 3, requires_grad=True)
    assert parallel.all_gather_with_grad(x) is x
    assert parallel.all_hosts_agree(False) is False
    tree = {"a": np.ones(2), "n": 3}
    assert parallel.broadcast_from_main(tree) is tree
    assert parallel.host_id() == 0 and parallel.num_hosts() == 1 and parallel.is_main_process()


def _rows(split):
    """{index: that row's image, DNA ids and text ids} over a split's batches."""
    out = {}
    for b in split.batches():
        for j, i in enumerate(b["index"]):
            out.setdefault(int(i), []).append((b["image"][j], b["dna"][j],
                                               b["language"]["input_ids"][j]))
    return out


@pytest.mark.parametrize("n,world,drop_last", [(25, 2, False), (26, 3, False), (3, 4, False),
                                               (25, 2, True), (40, 4, True)])
def test_synthetic_split_shards_like_bioscan_loader(n, world, drop_last):
    """SyntheticSplit(host_id=, num_hosts=): each rank's rows are those
    `shard_indices` names (strided g::W, wrap-padded to equal counts, or cut
    to whole batches with drop_last), with the unsharded split's content;
    the shards are disjoint but for the padding and cover the split."""
    from clibd_tpu_torch.data import SyntheticSplit
    from clibd_tpu_torch.data.pipeline import shard_indices
    from tests.torch_tiny import port_tiny_cfg

    cfg = port_tiny_cfg()
    whole = _rows(SyntheticSplit("all_keys", n, cfg, seed=4, batch_size=4))
    seen = []
    for g in range(world):
        split = SyntheticSplit("all_keys", n, cfg, seed=4, batch_size=4, host_id=g,
                               num_hosts=world, drop_last=drop_last)
        order = [int(i) for b in split.batches() for i in b["index"]]
        assert order == list(shard_indices(n, 0, g, world, 4, shuffle=False,
                                           drop_last=drop_last))
        assert all(len(b["index"]) == 4 for b in split.batches()) or not drop_last
        assert len(split) == -(-len(order) // 4)
        assert len(split.label_dicts()) == len(split.ids()) == n
        for i, copies in _rows(split).items():
            for got in copies:
                for a, b in zip(got, whole[i][0]):
                    np.testing.assert_array_equal(a, b)
        seen.append(order)
    flat = [i for order in seen for i in order]
    if drop_last:
        assert len(set(flat)) == len(flat)
        assert len({len(o) for o in seen}) == 1
    else:
        assert set(flat) == set(range(n))
        assert len({len(o) for o in seen}) == 1
        strided = [i for g in range(world) for i in range(g, n, world)]
        assert sorted(strided) == list(range(n))
