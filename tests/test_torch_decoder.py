"""The port's TransformerDecoder and spectral-norm blocks against the JAX package, on the CPU.

* ``TransformerDecoder`` (2 layers, d_model 32, 4 heads, 64 FFN units) on
  weights bridged from the flax decoder by ``tools/convert.py::
  decoder_from_jax_variables`` (LayerNorm and bias leaves perturbed so the
  bridge sees non-default values), 24 target tokens over 40 memory tokens
  (the cross-attention's T_q != T_k), with and without both padding masks,
  with dense positions and without: the eval forward, and the train forward
  with dropout 0.1 whose masks (the port's, drawn from a ``torch.Generator``
  in flax's order of the dropout layers) are handed to flax by intercepting
  each ``nn.Dropout``; in train mode also the gradients of every parameter
  and of both inputs against ``jax.vjp``. Tolerance 1e-4 absolute through two
  post-norm layers (as ``test_torch_attention.py``'s encoder), 2e-4 for the
  gradients.
* ``ResidualBlockSN`` and ``UpsampleBlockSN`` (with and without BatchNorm,
  ``conv_num`` 2 and 3) on weights bridged by ``sn_block_from_jax_variables``:
  eval forwards (one power step from the stored u, running statistics) within
  1e-5 absolute of flax's.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.models import layers as jlayers
from disentangledcolorization_tpu.models import transformer as jtr
from disentangledcolorization_tpu_torch.models import TransformerDecoder
from disentangledcolorization_tpu_torch.models import layers as tlayers
from disentangledcolorization_tpu_torch.models import transformer as ttr
from disentangledcolorization_tpu_torch.tools import convert

N, TQ, TK, D, NHEAD, DFF, RATE = 2, 24, 40, 32, 4, 64, 0.1
FWD_TOL, GRAD_TOL = 1e-4, 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rng):
    return jax.tree_util.tree_map(lambda x: np.asarray(x) + rng.normal(size=x.shape).astype(np.float32) * 0.1, tree)


@pytest.fixture(scope="module", params=[True, False], ids=["dense_pos", "pos_once"])
def decoders(request):
    rng = np.random.default_rng(0)
    tgt, tpos = (rng.normal(size=(N, TQ, D)).astype(np.float32) for _ in range(2))
    mem, mpos = (rng.normal(size=(N, TK, D)).astype(np.float32) for _ in range(2))
    jdec = jtr.TransformerDecoder(2, D, NHEAD, DFF, RATE, request.param)
    params = _perturb(jdec.init(jax.random.key(0), *map(jnp.asarray, (tgt, mem, tpos, mpos)))["params"], rng)
    tdec = TransformerDecoder(2, D, NHEAD, DFF, RATE, request.param)
    tdec.load_state_dict(convert.decoder_from_jax_variables({"params": params}))
    tmask = np.zeros((N, TQ), bool)
    tmask[0, 3:7] = True
    mmask = rng.uniform(size=(N, TK)) < 0.25
    return jdec, params, tdec, (tgt, mem, tpos, mpos), (tmask, mmask)


def _recording_keep(monkeypatch):
    """The port's dropout masks, in the order it draws them."""
    drawn, real = [], ttr._keep
    monkeypatch.setattr(ttr, "_keep", lambda *a: drawn.append(real(*a)) or drawn[-1])
    return drawn


def _replaying(masks):
    """A flax interceptor that applies ``masks`` in order to each nn.Dropout."""
    left = [jnp.asarray(m.numpy()) for m in masks]

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and not kwargs.get("deterministic", True):
            return jnp.where(left.pop(0), args[0] / (1.0 - context.module.rate), 0.0)
        return next_fun(*args, **kwargs)

    return interceptor, left


@pytest.mark.parametrize("masked", [False, True])
def test_decoder_eval_matches_flax(decoders, masked):
    jdec, params, tdec, xs, (tmask, mmask) = decoders
    masks = (tmask, mmask) if masked else (None, None)
    ref, _ = jdec.apply({"params": params}, *map(jnp.asarray, xs), *(None if m is None else jnp.asarray(m) for m in masks))
    with torch.no_grad():
        ours = tdec(*map(torch.from_numpy, xs), *(None if m is None else torch.from_numpy(m) for m in masks))
    assert ours.shape == (N, TQ, D)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_decoder_train_matches_flax_with_gradients(decoders, masked, monkeypatch):
    jdec, params, tdec, xs, (tmask, mmask) = decoders
    masks = (tmask, mmask) if masked else (None, None)
    tm = [None if m is None else torch.from_numpy(m) for m in masks]
    jm = [None if m is None else jnp.asarray(m) for m in masks]
    rng = np.random.default_rng(5)
    cot = rng.normal(size=(N, TQ, D)).astype(np.float32)

    drawn = _recording_keep(monkeypatch)
    tdec.zero_grad()
    txs = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = tdec(*txs, *tm, train=True, generator=torch.Generator().manual_seed(3))
    (out * torch.from_numpy(cot)).sum().backward()
    # per layer: self-attention weights, dropout1, cross-attention weights, dropout2, FFN hidden, dropout3
    assert len(drawn) == 12 and drawn[2].shape == (N, NHEAD, TQ, TK) and drawn[0].shape == (N, NHEAD, TQ, TQ)

    interceptor, left = _replaying(drawn)

    def fwd(p, *x):
        with fnn.intercept_methods(interceptor):
            return jdec.apply({"params": p}, *x, *jm, deterministic=False)[0]

    ref, vjp = jax.vjp(fwd, params, *map(jnp.asarray, xs))
    assert not left
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=FWD_TOL, rtol=0)
    grads = vjp(jnp.asarray(cot))
    ref_params = convert.decoder_grads_from_jax(jax.tree_util.tree_map(np.asarray, grads[0]))
    ours = dict(tdec.named_parameters())
    assert sorted(ref_params) == sorted(ours)
    for name, g in ref_params.items():
        np.testing.assert_allclose(ours[name].grad.numpy(), g.numpy(), atol=GRAD_TOL, rtol=0, err_msg=name)
    for t, g in zip(txs, grads[1:]):
        if t.grad is not None or np.abs(np.asarray(g)).max() > 0:
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=GRAD_TOL, rtol=0)


def test_decoder_layer_state_dict_uses_flax_names():
    keys = set(ttr.DecoderLayer(D, NHEAD, DFF).state_dict())
    assert {"self_attn.in_proj_weight", "corr_attn.in_proj_bias", "corr_attn.out_proj.weight", "norm3.weight",
            "linear2.bias"} <= keys


def _sn_variables(module, rng, *inputs):
    v = module.init(jax.random.key(1), *map(jnp.asarray, inputs))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v["params"] = _perturb(v["params"], rng)
    if "batch_stats" in v:  # non-default running statistics
        v["batch_stats"] = jax.tree_util.tree_map(lambda x: x + np.abs(rng.normal(size=x.shape)).astype(np.float32) * 0.5,
                                                  v["batch_stats"])
    return v


@pytest.mark.parametrize("use_norm", [False, True])
def test_residual_block_sn_matches_flax(use_norm):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 12, 10, 16)).astype(np.float32)
    jblk = jlayers.ResidualBlockSN(16, use_norm=use_norm)
    v = _sn_variables(jblk, rng, x)
    ref = jblk.apply(v, jnp.asarray(x))
    blk = tlayers.ResidualBlockSN(16, use_norm=use_norm)
    blk.load_state_dict(convert.sn_block_from_jax_variables(v))
    with torch.no_grad():
        ours = blk(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("conv_num,use_norm", [(2, False), (3, True)])
def test_upsample_block_sn_matches_flax(conv_num, use_norm):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 6, 5, 24)).astype(np.float32)
    skip = rng.normal(size=(2, 12, 10, 8)).astype(np.float32)
    jblk = jlayers.UpsampleBlockSN(16, conv_num=conv_num, use_norm=use_norm)
    v = _sn_variables(jblk, rng, x, skip)
    ref = jblk.apply(v, jnp.asarray(x), jnp.asarray(skip))
    blk = tlayers.UpsampleBlockSN(24, 8, 16, conv_num=conv_num, use_norm=use_norm)
    blk.load_state_dict(convert.sn_block_from_jax_variables(v))
    with torch.no_grad():
        ours = blk(*(torch.from_numpy(a).permute(0, 3, 1, 2) for a in (x, skip))).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
