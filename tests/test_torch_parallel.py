"""The port's ``parallel/mesh.py`` (``torch.distributed``) and the draws that
make a data-parallel step independent of the world size.

* ``initialize_distributed``: the single-process no-op cases, the flags read
  from torchrun's environment, an id out of range, and a coordinator that no
  rank serves raising within its short timeout (nothing left initialised);
* two ranks over gloo (spawned CPU processes, one spawn): ``replicate``,
  ``mean_reduce_metrics``, ``any_rank``, ``shard_batch``,
  ``all_reduce_gradients`` over two dtypes, a second ``initialize`` a no-op;
  the dropout generators of two ranks draw different masks;
* the data loader's ``p::P`` stride against JAX's ``DataLoader`` at P = 2;
* ``RowDraws``: rank r's rows of a draw for the global batch equal rows
  ``[offset, offset + b)`` of one process's draw, for k-means (its centers and
  assignments) and for ``get_random_mask``;
* ``step_generators``: world size 1 draws what a single process drew before
  data parallelism; with more ranks the anchors stay and the dropout differs.
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from disentangledcolorization_tpu.train import data as jdata
from disentangledcolorization_tpu_torch.ops import hints, kmeans
from disentangledcolorization_tpu_torch.parallel import mesh
from disentangledcolorization_tpu_torch.train import data, steps
from disentangledcolorization_tpu_torch.utils.seeding import RowDraws
from torch_ddp_workers import run_ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("coordinator, num_processes", [(None, None), (None, 1)])
def test_initialize_distributed_single_process_is_a_no_op(coordinator, num_processes):
    assert mesh.initialize_distributed(coordinator, num_processes, 0, device="cpu") is False
    assert not dist.is_initialized()
    assert (mesh.world_size(), mesh.process_index(), mesh.is_main()) == (1, 0, True)
    assert mesh.mean_reduce_metrics({"a": torch.tensor(2.0)})["a"] == 2.0
    assert mesh.any_rank(True, "cpu") and not mesh.any_rank(False, "cpu")
    assert mesh.rank_device("cpu") == torch.device("cpu")
    assert mesh.local_devices("cpu") == [torch.device("cpu")]


def test_initialize_distributed_flags_and_torchrun_environment(monkeypatch):
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="--process_id"):
        mesh.initialize_distributed(None, 2, None, device="cpu")
    with pytest.raises(ValueError, match="--num_processes"):
        mesh.initialize_distributed("127.0.0.1:1", None, 0, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "2")
    with pytest.raises(ValueError, match="out of range"):
        mesh.initialize_distributed("127.0.0.1:1", None, None, device="cpu")
    assert not dist.is_initialized()


def test_initialize_distributed_bad_coordinator_raises():
    """Rank 1 of 2 at a port no rank 0 serves: the rendezvous times out and
    raises, and no group is left behind (no fallback to one process)."""
    with pytest.raises(RuntimeError):
        mesh.initialize_distributed(f"127.0.0.1:{_free_port()}", 2, 1, device="cpu", timeout=2)
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("ranks"), [("collectives", None), ("dropout_masks", None)])


def test_collectives_over_two_ranks(two_ranks):
    (a, _), (b, _) = two_ranks
    assert a["rank"] == (0, 2, True) and b["rank"] == (1, 2, False)
    torch.manual_seed(0)
    rank0 = torch.nn.Linear(3, 2).state_dict()
    for k in ("weight", "bias"):
        assert torch.equal(a["state"][k], rank0[k]) and torch.equal(b["state"][k], rank0[k])
    assert torch.equal(b["state"]["stat"], torch.zeros(2))  # buffers too
    assert a["metrics"] == b["metrics"] == {"a": 1.5, "b": 1.0}
    assert a["any"] == b["any"] == (True, False)
    assert torch.equal(a["rows"], torch.arange(4)) and torch.equal(b["rows"], torch.arange(4, 8))
    for out in (a, b):
        assert torch.equal(out["grads"][0], torch.full((3,), 1.5))
        assert torch.equal(out["grads"][1], torch.full((2,), 6.0, dtype=torch.bfloat16))
        assert out["again"] is False


def test_ranks_draw_different_dropout_masks(two_ranks):
    (_, masks_a), (_, masks_b) = two_ranks
    for ma, mb in zip(masks_a, masks_b):
        assert ma.any() and mb.any() and not torch.equal(ma, mb)


def test_shard_batch_splits_rows():
    batch = {"x": torch.arange(12).reshape(6, 2)}
    assert torch.equal(mesh.shard_batch(batch, rank=2, world=3)["x"], batch["x"][4:6])
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(batch["x"], rank=0, world=4)


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.array(i)}


@pytest.mark.parametrize("drop_last", [True, False])
def test_dataloader_stride_matches_jax(drop_last):
    """P = 2: each rank's batches, over two epochs, are JAX's for that process."""
    for p in (0, 1):
        kw = dict(batch_size=2, shuffle=True, seed=4, num_workers=1, drop_last=drop_last, process_id=p,
                  num_processes=2)
        ours, ref = data.DataLoader(_Indices(11), **kw), jdata.DataLoader(_Indices(11), **kw)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            a, b = [x["i"].tolist() for x in ours], [x["i"].tolist() for x in ref]
            assert a == b and len(a) == len(ours) == len(ref) > 0


def test_row_draws_kmeans_rows_equal_the_global_draw():
    """Two ranks of 3 images each against one process on all 6: the centers
    and assignments of each rank's images equal the one-process ones."""
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(6, 40, 4)).astype(np.float32))
    assign, centers = kmeans.kmeans(x, 3, generator=torch.Generator().manual_seed(9))
    for r in range(2):
        rows = slice(3 * r, 3 * r + 3)
        draws = RowDraws(torch.Generator().manual_seed(9), 3 * r, 6)
        a, c = kmeans.kmeans(x[rows], 3, generator=draws)
        assert torch.equal(a, assign[rows]) and torch.equal(c, centers[rows])
    # a plain generator draws as one process on the batch it is given
    again = kmeans.kmeans(x, 3, generator=RowDraws(torch.Generator().manual_seed(9), 0, 6))
    assert torch.equal(again[1], centers)


def test_row_draws_random_mask_rows_equal_the_global_draw():
    full = hints.get_random_mask(6, 4, 5, 2, 6, torch.Generator().manual_seed(1))
    for r in range(3):
        part = hints.get_random_mask(2, 4, 5, 2, 6, RowDraws(torch.Generator().manual_seed(1), 2 * r, 6))
        assert torch.equal(part, full[2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="outside a batch"):
        hints.get_random_mask(4, 4, 5, 2, 6, RowDraws(torch.Generator().manual_seed(1), 4, 6))


def test_kmeans_pp_draws_by_inverse_cdf():
    """The D^2 draw never picks a point of zero weight: with one point per
    distinct location and k equal to the locations, every center differs."""
    x = torch.tensor([[[0.0], [0.0], [5.0], [5.0], [9.0]]]).expand(4, 5, 1).contiguous()
    centers = kmeans._kmeans_pp_init(x, 3, RowDraws(torch.Generator().manual_seed(2)))
    for c in centers:
        assert sorted(c[:, 0].tolist()) == [0.0, 5.0, 9.0]


def test_step_generators_world_one_draws_as_before_and_ranks_fold_dropout():
    def before(*entropy):  # the single-process seeding, unchanged by data parallelism
        seeds = np.random.SeedSequence(list(entropy)).generate_state(2, dtype=np.uint64)
        return [torch.Generator().manual_seed(int(s) & (2**63 - 1)) for s in seeds]

    draw = lambda g: torch.rand(8, generator=g)  # noqa: E731
    ref = [draw(g) for g in before(3, 5, 1)]
    one = [draw(g) for g in steps.step_generators("cpu", 3, 5, 1)]
    assert all(torch.equal(a, b) for a, b in zip(one, ref))
    r0, r1 = ([draw(g) for g in steps.step_generators("cpu", 3, 5, 1, rank=r, world=2)] for r in (0, 1))
    assert torch.equal(r0[0], ref[0]) and torch.equal(r1[0], ref[0])  # anchors: one global draw
    assert not torch.equal(r0[1], r1[1]) and not torch.equal(r0[1], ref[1])
