"""The modules of the model options against the JAX package, on the CPU.

* ``sine_position_encoding`` in bf16 (the full-resolution code of
  ``spix_pos`` in bf16 serving): bit for bit (0 ulps) at the token grid and at
  256x256; in f32 within 6e-8 (one rounding of the last sin/cos);
* ``PositionEmbeddingLearned`` on JAX's tables: equal, [x | y] order;
* ``TransformerEncoder(use_dense_pos=False)`` against flax's: 1e-5;
* ``get_random_mask``'s contract (torch's generator cannot give
  ``jax.random``'s bits): each count in [min, max], distinct positions, the
  same generator state the same mask, the counts spread over the range;
  ``random_hint_mask`` with its all-zero cluster mask;
* ``detect_correlation`` against JAX at (2,16,16,64): 1e-5 on features
  built so that some anchors are cosine-close;
* the bridge (``from_jax_variables``, ``grads_from_jax``,
  ``fold_spectral_norm``) for each new parameter layout: ``pos_enc`` tables,
  the (d+3)-wide ``trg_word_emb`` and 2-wide ``trg_word_prj``, no
  ``enhanceNet``, d_model 128: loads strict, round trip exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.models import anchor as janchor
from disentangledcolorization_tpu.models.position import PositionEmbeddingLearned as JPositionEmbeddingLearned
from disentangledcolorization_tpu.models.position import sine_position_encoding as jsine
from disentangledcolorization_tpu.models.transformer import TransformerEncoder as JTransformerEncoder
from disentangledcolorization_tpu_torch.models import AnchorColorProb, anchor
from disentangledcolorization_tpu_torch.models.position import PositionEmbeddingLearned, sine_position_encoding
from disentangledcolorization_tpu_torch.models.transformer import TransformerEncoder
from disentangledcolorization_tpu_torch.ops import hints
from disentangledcolorization_tpu_torch.tools import convert
from disentangledcolorization_tpu_torch.tools.convert import fold_spectral_norm, from_jax_variables, grads_from_jax
from test_torch_bridge import random_state_dict, to_jax_variables


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one intra-op thread: the suite's parallel workers, each with
    a thread per core, would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("h,w,f", [(2, 2, 32), (16, 16, 32), (16, 16, 64), (256, 256, 32), (256, 256, 64)])
def test_sine_code_bf16_bit_for_bit(h, w, f):
    ref = np.asarray(jsine(h, w, f, dtype=jnp.bfloat16)).view(np.int16)
    ours = sine_position_encoding(h, w, f, dtype=torch.bfloat16)
    assert ours.dtype == torch.bfloat16 and ours.shape == (h, w, 2 * f)
    np.testing.assert_array_equal(ours.view(torch.int16).numpy(), ref)
    np.testing.assert_allclose(sine_position_encoding(h, w, f).numpy(), np.asarray(jsine(h, w, f)), atol=6e-8, rtol=0)


def test_learned_positions_match_jax():
    rng = np.random.default_rng(0)
    rows, cols = rng.normal(size=(3, 8)).astype(np.float32), rng.normal(size=(5, 8)).astype(np.float32)
    params = {"params": {"row_embed": {"embedding": rows}, "col_embed": {"embedding": cols}}}
    ref = JPositionEmbeddingLearned(n_pos_x=5, n_pos_y=3, num_pos_feats=8).apply(params, 3, 4)
    m = PositionEmbeddingLearned(n_pos_x=5, n_pos_y=3, num_pos_feats=8)
    m.load_state_dict({"row_embed.weight": torch.from_numpy(rows), "col_embed.weight": torch.from_numpy(cols)})
    ours = m(3, 4)
    assert ours.shape == (3, 4, 16)
    np.testing.assert_array_equal(ours.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ours[1, 2, :8].detach().numpy(), cols[2])  # x first


def test_encoder_without_dense_positions_matches_flax():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(2, 16, 32)).astype(np.float32)
    pos = rng.normal(size=(2, 16, 32)).astype(np.float32)
    jm = JTransformerEncoder(2, 32, 4, 64, 0.0, use_dense_pos=False)
    variables = jm.init(jax.random.key(0), jnp.asarray(src), jnp.asarray(pos))
    ref, _ = jm.apply(variables, jnp.asarray(src), jnp.asarray(pos))
    dense, _ = JTransformerEncoder(2, 32, 4, 64, 0.0, use_dense_pos=True).apply(
        variables, jnp.asarray(src), jnp.asarray(pos))
    sb = convert._StateDictBuilder({"params": {"enc": variables["params"]}}, sn_folded=False)
    convert._encoder(sb, "", ("enc",))
    ours = TransformerEncoder(2, 32, 4, 64, 0.0, use_dense_pos=False)
    ours.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sb.sd.items()})
    out = ours(torch.from_numpy(src), torch.from_numpy(pos))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert np.abs(np.asarray(ref) - np.asarray(dense)).max() > 1e-2  # the two position modes differ


def test_random_mask_contract():
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    masks = hints.get_random_mask(64, 4, 5, 2, 6, g)
    assert masks.shape == (64, 4, 5, 1) and masks.dtype == torch.float32
    assert set(masks.unique().tolist()) <= {0.0, 1.0}
    counts = masks.sum(dim=(1, 2, 3))
    assert counts.min() >= 2 and counts.max() <= 6 and len(set(counts.tolist())) == 5  # every count drawn
    g.set_state(state)
    assert torch.equal(hints.get_random_mask(64, 4, 5, 2, 6, g), masks)
    assert not torch.equal(hints.get_random_mask(64, 4, 5, 2, 6, g), masks)  # the state moved on
    exact = hints.get_random_mask(8, 16, 16, 8, 8, torch.Generator().manual_seed(0))
    assert (exact.sum(dim=(1, 2, 3)) == 8).all()
    hint, cluster = anchor.random_hint_mask(8, 16, 16, 8, torch.Generator().manual_seed(0))
    assert torch.equal(hint, exact) and cluster.shape == (8, 16, 16, 8) and not cluster.any()
    # as JAX's: exactly n_anchors ones per image
    jhint, _ = janchor.random_hint_mask(jax.random.key(0), 8, 16, 16, 8)
    assert (np.asarray(jhint).sum(axis=(1, 2, 3)) == 8).all()


def test_detect_correlation_matches_jax():
    rng = np.random.default_rng(2)
    data = rng.normal(size=(2, 16, 16, 64)).astype(np.float32)
    data[:, 4:8, 4:8] = data[:, 4:5, 4:5] + 0.05 * rng.normal(size=(2, 4, 4, 64)).astype(np.float32)  # close anchors
    probs = rng.dirichlet(np.ones(313), size=(2, 16, 16)).astype(np.float32)
    mask = (rng.uniform(size=(2, 16, 16, 1)) < 0.1).astype(np.float32)
    mask[:, 4:8, 4:8] = 1.0
    ref = janchor.detect_correlation(jnp.asarray(data), jnp.asarray(probs), jnp.asarray(mask))
    ours = anchor.detect_correlation(torch.from_numpy(data), torch.from_numpy(probs), torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    merged = np.abs(np.asarray(ref) - probs).max(axis=-1) > 1e-4
    assert merged[:, 4:8, 4:8].all() and not merged[mask[..., 0] == 0].any()


LAYOUTS = {
    "learning_pos": dict(learning_pos=True, token_grid=(2, 2)),
    "hint2regress": dict(hint2regress=True),
    "not_enhanced": dict(enhanced=False),
    "d128": dict(d_model=128, d_mlp=512),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_bridge_carries_each_layout(name, folded):
    torch.manual_seed(0)
    model = AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=folded, **LAYOUTS[name])
    sd = random_state_dict(model, seed=0)
    variables = to_jax_variables(sd, folded)
    back = from_jax_variables(variables, sn_folded=folded)
    model.load_state_dict(back)  # strict: every key of the layout, no other
    shapes = {k: tuple(v.shape) for k, v in back.items()}
    d = LAYOUTS[name].get("d_model", 64)
    assert shapes["trg_word_emb.weight"] == (d, d + (3 if name == "hint2regress" else 314))
    assert shapes["trg_word_prj.weight"] == ((2 if name == "hint2regress" else 313), d)
    assert any(k.startswith("enhanceNet.") for k in back) == (name != "not_enhanced")
    if name == "learning_pos":
        assert shapes["pos_enc.row_embed.weight"] == shapes["pos_enc.col_embed.weight"] == (2, 32)
    if not folded:
        for k, v in sd.items():
            if not k.endswith(("weight_u", "weight_v", "num_batches_tracked")):
                np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
        grads = grads_from_jax(jax.tree_util.tree_map(np.asarray, variables["params"]))
        assert sorted(grads) == sorted(k for k, _ in model.named_parameters())
        for k in grads:
            np.testing.assert_array_equal(grads[k].numpy(), sd[k], err_msg=k)
        folded_sd = fold_spectral_norm({k: torch.from_numpy(v) for k, v in sd.items()})
        AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=True, **LAYOUTS[name]).load_state_dict(folded_sd)
