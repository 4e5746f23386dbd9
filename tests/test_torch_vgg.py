"""The port's VGG19 perceptual term against the JAX package's.

One seeded random-init VGG19 npz in the torchvision layout (the port's
``make_random_vgg19_npz``, which writes the arrays of
``tools/make_random_vgg.py``) feeds both packages: JAX through
``load_vgg19_params``, the port through ``load_vgg19``. oneDNN is off, as in
``tests/test_torch_train.py``. Held against JAX:
  * ``VGG19Features`` for the 'liu', 'lei' and 'lpips' slices at (2,64,64,3):
    every slice within 1e-5 of its largest entry;
  * the perceptual term (relative 1e-5) and its gradient with respect to the
    predicted colours (1e-4 of its largest entry) against ``jax.value_and_grad``
    of ``AnchorColorProbLoss._perceptual`` at (2,32,32). Not at 64x64: the two packages' Lab->RGB chains round a few
    1e-6 apart, and in a few 2x2 max-pool windows of the 64x64 stack the two
    largest inputs lie closer than that, so the other package's pool passes
    the gradient to the other input. That moves the gradient by up to 4% of
    its largest entry (measured); at 32x32 (relu5_1 at 2x2) no window is that
    close and the gradients agree within 2.2e-6;
  * one stage-2 train step with the VGG term, on the bridged weights and
    pinned anchors of ``tests/test_torch_train.py`` at 32x32: the four losses
    (relative 1e-5) and every trainable gradient (1e-4 of its largest entry).
    The VGG's conv biases are conditioned first on the step's predicted RGB
    (``chip_smoke.condition_vgg``, ReLU inputs at least 1e-3 std from 0): the
    two packages' predictions differ by about 1e-6, and a VGG ReLU input
    within that of 0 takes the other side in the other package (measured:
    gradients 1e-3 of their max apart unconditioned, 8e-5 conditioned).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.models import AnchorColorProb as JAnchorColorProb
from disentangledcolorization_tpu.models.vgg import VGG19Features as JVGG19Features
from disentangledcolorization_tpu.models.vgg import load_vgg19_params
from disentangledcolorization_tpu.train import losses as jlosses
from disentangledcolorization_tpu.train import steps as jsteps
from disentangledcolorization_tpu_torch.models import AnchorColorProb
from disentangledcolorization_tpu_torch.models import anchor as tanchor
from disentangledcolorization_tpu_torch.models.vgg import VGG19Features, load_vgg19, make_random_vgg19_npz
from disentangledcolorization_tpu_torch.tools.convert import from_jax_variables, grads_from_jax
from disentangledcolorization_tpu_torch.train import losses, state, steps
from chip_smoke import condition_vgg
from disentangledcolorization_tpu_torch.utils.color import lab2rgb
from test_torch_bridge import REPO, random_state_dict, to_jax_variables
from test_torch_train import LOSSES, SIZE, _conditioned, _quiet


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return make_random_vgg19_npz(str(tmp_path_factory.mktemp("vgg") / "vgg19.npz"), seed=0)


@pytest.fixture(autouse=True)
def native_f32_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def test_make_random_vgg19_npz_equals_the_tool(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import make_random_vgg
    finally:
        sys.path.pop(0)
    make_random_vgg.main(["--out", str(tmp_path / "tool.npz"), "--seed", "3"])
    ours, tool = np.load(make_random_vgg19_npz(str(tmp_path / "ours.npz"), 3)), np.load(tmp_path / "tool.npz")
    assert sorted(ours.files) == sorted(tool.files) and len(ours.files) == 32
    for k in tool.files:
        assert ours[k].dtype == tool[k].dtype and np.array_equal(ours[k], tool[k]), k


@pytest.mark.parametrize("feat_type", ["liu", "lei", "lpips"])
def test_vgg_features_match_jax(npz, feat_type):
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = JVGG19Features(feat_type=feat_type).apply(load_vgg19_params(npz), jnp.asarray(x))
    vgg = load_vgg19(npz, feat_type, device="cpu")
    assert not any(p.requires_grad for p in vgg.parameters())
    ours = vgg(torch.from_numpy(x))
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * np.abs(b).max(), rtol=0)


def test_load_vgg19_without_weights_is_none():
    assert load_vgg19("/nonexistent/vgg19.npz", device="cpu") is None or os.path.exists(
        os.path.join(REPO, "checkpoints", "vgg19.npz"))
    assert isinstance(VGG19Features("lei"), torch.nn.Module)


def test_perceptual_term_and_gradient_match_jax(npz, size=32):
    rng = np.random.default_rng(2)
    gray = rng.uniform(-0.8, 0.8, (2, size, size, 1)).astype(np.float32)
    gt, pred = (rng.uniform(-0.4, 0.4, (2, size, size, 2)).astype(np.float32) for _ in range(2))
    bundle = jlosses.AnchorColorProbLoss(enhanced=True, vgg_variables=load_vgg19_params(npz))
    val, grad = jax.jit(jax.value_and_grad(lambda p: bundle._perceptual(jnp.asarray(gray), jnp.asarray(gt), p)))(
        jnp.asarray(pred))
    ours_bundle = losses.AnchorColorProbLoss(enhanced=True, vgg=load_vgg19(npz, device="cpu"))
    p = torch.from_numpy(pred).requires_grad_()
    ours = ours_bundle.perceptual(torch.from_numpy(gray), torch.from_numpy(gt), p)
    ours.backward()
    np.testing.assert_allclose(float(ours.detach()), float(val), rtol=1e-5, atol=0)
    g = np.asarray(grad)
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(p.grad.numpy(), g, atol=1e-4 * np.abs(g).max(), rtol=0)


def test_no_fallback_warning_with_vgg(npz, recwarn):
    losses.AnchorColorProbLoss(enhanced=True, vgg=load_vgg19(npz, device="cpu"))
    assert not [w for w in recwarn if "falls back to pixel L1" in str(w.message)]
    with pytest.warns(UserWarning, match="falls back to pixel L1"):
        losses.AnchorColorProbLoss(enhanced=True)


def test_train_step_with_vgg_matches_jax(npz, monkeypatch, tmp_path):
    rng = np.random.default_rng(5)
    gray = rng.uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(np.float32)
    color = rng.uniform(-0.5, 0.5, (2, SIZE, SIZE, 2)).astype(np.float32)
    torch.manual_seed(4)
    sd = _conditioned(random_state_dict(AnchorColorProb(n_clusters=2, n_enc_layers=2), seed=4), gray, color)
    variables = to_jax_variables(sd, False)
    model = AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=False, dropout=0.0)
    model.load_state_dict(from_jax_variables(variables, sn_folded=False))
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad():
        pred = model(torch.from_numpy(gray), torch.from_numpy(color), test_mode=False, train=True)["pred_colors"]
    model.load_state_dict({**model.state_dict(), **buffers})
    vgg = load_vgg19(npz, "lpips", device="cpu")
    condition_vgg(vgg, lab2rgb(torch.cat([torch.from_numpy(gray), pred], dim=-1)), gap=1e-3)
    npz = str(tmp_path / "conditioned.npz")
    np.savez(npz, **{k: v.numpy() for k, v in vgg.state_dict().items()})

    jm = JAnchorColorProb(sp_size=16, n_clusters=2, n_enc_layers=2, enhanced=True, dropout=0.0)
    jloss = jlosses.AnchorColorProbLoss(enhanced=True, vgg_variables=load_vgg19_params(npz))
    anchor_key, dropout_key = jax.random.split(jax.random.fold_in(jax.random.key(6), 0))
    g, c = jnp.asarray(gray), jnp.asarray(color)
    hint = jax.jit(lambda v: jm.apply(v, g, c, False, 0, True, rngs={"anchor": anchor_key, "dropout": dropout_key},
                                      mutable=["batch_stats", "spectral"])[0]["hint_mask"])(variables)
    grads, metrics, _ = jax.jit(jsteps.make_micro_grads(jm, jloss))(
        variables["params"], variables["batch_stats"], variables["spectral"], g, c, anchor_key, dropout_key)
    ref_grads = grads_from_jax(jax.tree_util.tree_map(np.asarray, grads))

    monkeypatch.setattr(tanchor, "clustering_hint_mask", lambda *a, **k: (torch.from_numpy(np.asarray(hint)), None))
    st = state.TrainState.create(model, name="sgd", schedule=0.0, momentum=0.0)
    ours_grads, apply = {}, st.optimizer.step
    st.optimizer.step = lambda: ours_grads.update(
        {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}) or apply()
    bundle = losses.AnchorColorProbLoss(enhanced=True, vgg=load_vgg19(npz, device="cpu"))
    ours = steps.make_colorizer_train_step(bundle)(st, {"gray": torch.from_numpy(gray), "color": torch.from_numpy(color)})
    for k in LOSSES:
        np.testing.assert_allclose(float(ours[k]), float(metrics[k]), rtol=1e-5, atol=0, err_msg=k)
    assert float(ours["recLoss"]) > 0
    assert sorted(ours_grads) == sorted(k for k in ref_grads if not k.startswith("segnet."))
    for k, v in ours_grads.items():
        r = ref_grads[k].numpy()
        np.testing.assert_allclose(v.numpy(), r, atol=1e-4 * np.abs(r).max(), rtol=0, err_msg=k)
