"""The port's checkpoints, optimizer state, stage-1 -> stage-2 hand-over and
xavier re-initialisation.

* ``CheckpointManager`` save -> restore is bit-exact: parameters, BatchNorm
  statistics, spectral-norm u and v, Adam's moments and step, the update
  count, the train step, the epoch, the best loss and the plateau state;
* a failed write leaves the previous checkpoint whole and no temporary file;
* a run resumes across a ``--grad_clip`` change (the clip is not state);
* a stage-1 checkpoint (the port's run dir, a reference-layout ``.pth.tar``,
  or the JAX converter's numpy ``.pkl``) loads as stage 2's segnet, and a
  pickle that needs any other class raises;
* a stage-2 checkpoint loads into ``api.Colorizer(checkpoint=...)`` with its
  spectral norm folded by the reference formula, and ``load_train_variables``
  folds by the unfolded model's own (the JAX package's) formula;
* ``xavier_reinit_params`` re-draws exactly the tensors of two or more dims
  (the leaves JAX's ``xavier_reinit_params`` re-draws, mapped by the weight
  bridge), within xavier's bound
  sqrt(6 / (fan_in + fan_out)).
"""

import pickle
import warnings

import jax
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.tools import convert_torch as cvt
from disentangledcolorization_tpu_torch.cli.train_colorizer import load_spixel_state_dict
from disentangledcolorization_tpu_torch.models import AnchorColorProb, SpixelSeg, xavier_reinit_params
from disentangledcolorization_tpu_torch.tools.convert import fold_spectral_norm, grads_from_jax
from disentangledcolorization_tpu_torch.train import checkpoint, losses, optim, state, steps
from test_torch_bridge import random_state_dict, to_jax_variables

SIZE = 32


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"gray": torch.from_numpy(rng.uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(np.float32)),
            "color": torch.from_numpy(rng.uniform(-0.5, 0.5, (2, SIZE, SIZE, 2)).astype(np.float32))}


def _trained_state(grad_clip=0.0, seed=1, n_enc_layers=2):
    """A colorizer state after one Adam step (moments nonzero)."""
    torch.manual_seed(seed)
    model = AnchorColorProb(n_clusters=2, n_enc_layers=n_enc_layers)
    st = state.TrainState.create(model, name="adam", schedule=1e-3, grad_clip=grad_clip)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loss = losses.AnchorColorProbLoss(enhanced=True)
    steps.make_colorizer_train_step(loss)(st, _batch(), seed=2)
    return st, loss


@pytest.fixture(scope="module")
def trained():
    return _trained_state()


def _assert_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["count"] == ob["count"] and a.step == b.step
    for i, s in oa["optimizer"]["state"].items():
        t = ob["optimizer"]["state"][i]
        assert sorted(s) == sorted(t) == ["exp_avg", "exp_avg_sq", "step"]
        assert all(torch.equal(s[k], t[k]) for k in s)


def test_save_restore_is_bit_exact(tmp_path, trained):
    st, _ = trained
    plateau = optim.PlateauState(best=0.25, bad_epochs=2, scale=0.5)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "checkpts"))
    assert not mgr.exists("last")
    mgr.save("last", st, epoch=3, best_loss=0.125, plateau=plateau)
    assert mgr.exists("last") and mgr.path("last").endswith("model_last.pth.tar")
    fresh, _ = _trained_state(seed=9)
    fresh_plateau = optim.PlateauState()
    epoch, best = mgr.restore("last", fresh, fresh_plateau)
    assert (epoch, best) == (3, 0.125) and fresh_plateau == plateau
    _assert_states_equal(st, fresh)
    payload = torch.load(mgr.path("last"), weights_only=True)
    assert {"epoch", "state_dict", "best_loss", "optimizer", "step", "plateau"} <= set(payload)
    assert any(k.endswith("weight_u") for k in payload["state_dict"])


def test_failed_write_keeps_the_previous_checkpoint(tmp_path, monkeypatch, trained):
    st, _ = trained
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save("last", st, 1, 1.0)
    before = open(mgr.path("last"), "rb").read()

    def broken_save(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", broken_save)
    with pytest.raises(OSError, match="disk full"):
        mgr.save("last", st, 2, 0.5)
    assert open(mgr.path("last"), "rb").read() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["model_last.pth.tar"]


@pytest.mark.parametrize("clip_before, clip_after", [(0.0, 1.0), (1.0, 0.0)])
def test_resume_across_a_grad_clip_change(tmp_path, clip_before, clip_after):
    st, loss = _trained_state(grad_clip=clip_before)
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save("last", st, 1, 1.0)
    torch.manual_seed(5)
    resumed = state.TrainState.create(AnchorColorProb(n_clusters=2, n_enc_layers=2), name="adam", schedule=1e-3,
                                      grad_clip=clip_after)
    mgr.restore("last", resumed)
    _assert_states_equal(st, resumed)
    assert resumed.optimizer.grad_clip == clip_after
    metrics = steps.make_colorizer_train_step(loss)(resumed, _batch(1), seed=3)
    assert np.isfinite(float(metrics["totalLoss"])) and resumed.optimizer.count == 2


def test_stage_one_checkpoint_loads_as_segnet(tmp_path):
    torch.manual_seed(3)
    sp = SpixelSeg()
    sd = {k: torch.from_numpy(v) for k, v in random_state_dict(sp, seed=3).items()}
    sp.load_state_dict(sd)
    st = state.TrainState.create(sp, name="adam", schedule=2e-4)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "run" / "checkpts"))
    mgr.save("last", st, 1, 2.0)
    reference = tmp_path / "reference.pth.tar"
    torch.save({"epoch": 1, "state_dict": {"module." + k: v for k, v in sd.items()}}, reference)
    jvars = cvt.convert_spixelseg_state_dict({k: v.numpy() for k, v in sd.items()})
    pkl = tmp_path / "spixel.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(jvars, f)
    for path in (tmp_path / "run", tmp_path / "run" / "checkpts", mgr.path("last"), reference, pkl):
        model = AnchorColorProb(n_clusters=2, n_enc_layers=2)
        model.segnet.load_state_dict(load_spixel_state_dict(str(path)))  # strict
        got = model.segnet.state_dict()
        assert all(torch.equal(got[k], sd[k]) for k in sd), path
    bad = tmp_path / "bad.pkl"
    with open(bad, "wb") as f:
        pickle.dump({"params": {"w": jax.numpy.zeros(3)}}, f)
    with pytest.raises(pickle.UnpicklingError, match="only dicts of numpy arrays"):
        load_spixel_state_dict(str(bad))


def test_stage_two_checkpoint_loads_into_colorizer(tmp_path):
    from disentangledcolorization_tpu_torch.api import Colorizer

    st, _ = _trained_state(n_enc_layers=6)  # the serving model's depth
    mgr = checkpoint.CheckpointManager(str(tmp_path / "checkpts"))
    mgr.save("best", st, 1, 1.0)
    col = Colorizer(checkpoint=mgr.path("best"), n_clusters=2, device="cpu")
    folded = fold_spectral_norm(st.model.state_dict())
    loaded = col.model.state_dict()
    assert sorted(loaded) == sorted(folded)
    assert all(torch.equal(loaded[k], folded[k]) for k in folded)
    img = np.random.default_rng(0).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    out = col.colorize(img)
    assert out.shape == (32, 32, 3) and out.dtype == np.uint8


def test_load_train_variables_folds_like_the_unfolded_forward(tmp_path, trained):
    st, _ = trained
    mgr = checkpoint.CheckpointManager(str(tmp_path / "checkpts"))
    mgr.save("last", st, 1, 1.0)
    folded = checkpoint.load_train_variables(str(tmp_path))
    for name, m in st.model.named_modules():
        if hasattr(m, "weight_orig") and hasattr(m, "weight_u"):
            torch.testing.assert_close(folded[f"{name}.weight_orig"], m.weight(train=False).detach(), rtol=1e-6, atol=0)
    raw = checkpoint.load_train_variables(str(tmp_path), fold_spectral=False)
    assert all(torch.equal(raw[k], v) for k, v in st.model.state_dict().items())


def test_xavier_reinit_params_matches_jax_set_and_bound():
    torch.manual_seed(2)
    model = AnchorColorProb(n_clusters=2, n_enc_layers=2)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    xavier_reinit_params(model, torch.Generator().manual_seed(7))
    changed = set()
    for k, p in model.named_parameters():
        if p.ndim >= 2:
            fan_in, fan_out = torch.nn.init._calculate_fan_in_and_fan_out(p)
            bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
            assert not torch.equal(p, before[k]) and float(p.abs().max()) <= bound * (1 + 1e-6), k
            if p.numel() >= 500:
                assert float(p.abs().max()) >= 0.95 * bound, k
            changed.add(k)
        else:
            assert torch.equal(p, before[k]), k
    again = AnchorColorProb(n_clusters=2, n_enc_layers=2)
    xavier_reinit_params(again, torch.Generator().manual_seed(7))
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), again.parameters()))
    # the leaves JAX's xavier_reinit_params re-draws (params of ndim >= 2,
    # JAX models/disco.py:309), mapped to port names by the weight bridge
    params = to_jax_variables(random_state_dict(model, seed=2), False)["params"]
    flags = jax.tree_util.tree_map(lambda a: np.full(np.shape(a), float(np.ndim(a) >= 2), np.float32), params)
    jax_changed = {k for k, v in grads_from_jax(flags).items() if float(v.max()) == 1.0}
    assert jax_changed == changed
