"""The model options and anchor modes of the serving forward against the JAX package.

One random port ``state_dict`` per option set goes through
``convert_disco_state_dict`` (``test_torch_bridge.to_jax_variables``, which
adds the learned position tables) and back through ``from_jax_variables``;
both models then run the test-mode forward at 32x32, 2+2 encoder layers,
batch 2, 2 clusters, on the same inputs:

* the anchor modes on the recipe's model: ``sampled_T`` = -1 (the
  ground-truth superpixel colors), 0 and 2 (diverse: the batch tiled x3 with
  T = 0, 1, 2);
* each option at ``sampled_T=2``, so that the tiling meets it: ``spix_pos``
  (kernel A at C = 2d + 2), ``learning_pos``, ``hint2regress``, ``use_mask``,
  ``enhanced=False``, d_model 128 / d_mlp 512 (head width 16), d_model 32 /
  d_mlp 128 (head width 4, which kernel D lacks: the CPU runs it),
  ``use_dense_pos=False`` and ``random_hint``.

In f32 the anchors come from the port's own code with the k-means (or random)
mask pinned to JAX's, as ``test_torch_train.py`` pins it: logits and
predicted colors within 1e-4 absolute (f32 through ~60 convs and 4 encoder
layers summed in another order, as ``test_torch_disco.py``), the sampled
anchor colors (bin centers), sizes, labels and hint masks equal, the
ground-truth anchor colors (``sampled_T=-1``) within 1e-6.

In bf16 both the hint mask and the anchor colors are pinned (3N of them for
``sampled_T=2``): a bf16 flip can move an argmax. Tolerances as
``test_torch_bf16.py``'s whole forward (about 4x the port's gap there; they
cannot see a missed rounding point, the layer tests there do): affinity_map
6e-3 and pred_colors 2.5e-2 absolute, pal_logit 1e-2 and ref_logit 3e-3 of the
largest entry; sizes within 4/256; ``spix_pos``'s bf16 sine code is held bit
for bit in ``test_torch_options_modules.py``.
"""

import ctypes
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.models import AnchorColorProb as JAnchorColorProb
from disentangledcolorization_tpu_torch.models import AnchorColorProb
from disentangledcolorization_tpu_torch.models import anchor as tanchor
from disentangledcolorization_tpu_torch.tools.convert import from_jax_variables
from test_torch_bridge import random_state_dict, to_jax_variables

SIZE, N, LAYERS = 32, 2, 2
HC = SIZE // 16
OPTIONS = {
    "recipe": {},
    "spix_pos": dict(spix_pos=True),
    "learning_pos": dict(learning_pos=True),
    "hint2regress": dict(hint2regress=True),
    "use_mask": dict(use_mask=True),
    "not_enhanced": dict(enhanced=False),
    "d128": dict(d_model=128, d_mlp=512),
    "d32": dict(d_model=32, d_mlp=128),
    "sparse_pos": dict(use_dense_pos=False),
    "random_hint": dict(random_hint=True),
}
CASES = [("recipe", -1), ("recipe", 0), ("recipe", 2)] + [(k, 2) for k in OPTIONS if k != "recipe"]
ATOL = 1e-4
BF16_ATOL = {"affinity_map": 6e-3, "pred_colors": 2.5e-2}
BF16_RTOL = {"pal_logit": 1e-2, "ref_logit": 3e-3}
BF16_SIZE_TOL = 4 / 256


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one intra-op thread: the suite's parallel workers, each with
    a thread per core, would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def release_memory():
    """At the module's end, drop its cached weights and outputs and JAX's
    compiled executables, and hand the freed heap back to the system: a
    worker of the parallel suite otherwise holds 11.5 GB after this module
    for the rest of its life (1.0 GB with this), and the suite's peak comes
    near the machine's memory (a 22 GB JAX test was killed so)."""
    yield
    for cached in (bridged, f32_case, bf16_case):
        cached.cache_clear()
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


def port_kwargs(options: dict) -> dict:
    kw = dict(options)
    if kw.get("learning_pos"):
        kw["token_grid"] = (HC, HC)
    return kw


def inputs(seed: int = 0, n: int = N, size: int = SIZE):
    rng = np.random.default_rng(seed)
    grays = rng.uniform(-1, 1, (n, size, size, 1)).astype(np.float32)
    colors = rng.uniform(-0.5, 0.5, (n, size, size, 2)).astype(np.float32)
    return grays, colors


@functools.lru_cache(maxsize=None)
def bridged(name: str, folded: bool = False):
    """(port model's state_dict, JAX variables) for an option set, seeded."""
    torch.manual_seed(11)
    model = AnchorColorProb(n_clusters=2, n_enc_layers=LAYERS, **port_kwargs(OPTIONS[name]))
    sd = random_state_dict(model, seed=11)
    if OPTIONS[name].get("use_mask"):
        sd["segnet.net.pred_mask0.bias"][1] += 4.0  # pixels join the cell above: the bottom row's keys are masked
    variables = to_jax_variables(sd, folded)
    return from_jax_variables(variables, sn_folded=folded), variables


def jax_model(name: str, bf16: bool = False, folded: bool = False):
    return JAnchorColorProb(sp_size=16, n_clusters=2, n_enc_layers=LAYERS, sn_folded=folded, dropout=0.0,
                            compute_dtype=jnp.bfloat16 if bf16 else jnp.float32, **OPTIONS[name])


def port_model(name: str, bf16: bool = False, folded: bool = False):
    model = AnchorColorProb(n_clusters=2, n_enc_layers=LAYERS, sn_folded=folded, dropout=0.0,
                            compute_dtype=torch.bfloat16 if bf16 else torch.float32, **port_kwargs(OPTIONS[name]))
    model.load_state_dict(bridged(name, folded)[0])
    return model.eval()


def _np(x):
    return None if x is None else np.asarray(jnp.asarray(x, jnp.float32)) if not torch.is_tensor(x) else x.float().numpy()


@functools.lru_cache(maxsize=None)
def f32_case(name: str, T: int):
    """JAX's forward and the port's with JAX's anchors pinned inside the port."""
    grays, colors = inputs()
    ref = jax_model(name).apply(bridged(name)[1], jnp.asarray(grays), jnp.asarray(colors), True, T, False,
                                rngs={"anchor": jax.random.key(3)})
    pinned = torch.from_numpy(_np(ref["hint_mask"])[:N].copy())
    patch = "random_hint_mask" if OPTIONS[name].get("random_hint") else "clustering_hint_mask"
    real = getattr(tanchor, patch)
    setattr(tanchor, patch, lambda *a, **k: (pinned, None))
    try:
        out = port_model(name)(torch.from_numpy(grays), torch.from_numpy(colors), sampled_T=T)
    finally:
        setattr(tanchor, patch, real)
    return {k: _np(v) for k, v in ref.items()}, {k: _np(v) for k, v in out.items()}


@pytest.mark.parametrize("name,T", CASES, ids=[f"{k}-T{t}" for k, t in CASES])
def test_f32_forward_matches_jax(name, T):
    ref, out = f32_case(name, T)
    n_out = 3 * N if T > 0 else N
    assert set(out) == set(ref)
    for key in ("pal_logit", "ref_logit", "pred_colors", "affinity_map"):
        if ref[key] is None:
            assert key == "pred_colors" and out[key] is None and not OPTIONS[name].get("enhanced", True)
            continue
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(out[key], ref[key], atol=ATOL, rtol=0, err_msg=key)
    assert out["ref_logit"].shape[0] == n_out and out["ref_logit"].shape[-1] == (2 if name == "hint2regress" else 313)
    np.testing.assert_array_equal(out["hint_mask"], ref["hint_mask"])
    np.testing.assert_array_equal(out["spixel_sizes"], ref["spixel_sizes"])
    np.testing.assert_array_equal(out["token_labels"], ref["token_labels"])
    if T < 0:
        np.testing.assert_allclose(out["spix_colors"], ref["spix_colors"], atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(out["spix_colors"], ref["spix_colors"])


def test_diverse_tiles_three_samplings():
    """sampled_T=2 gives T = 0, 1, 2 one after the other: its first N
    images are the T=0 forward's (within 1e-5: a batch of 3N is summed in
    other blocks), and the three samplings differ."""
    _, out0 = f32_case("recipe", 0)
    _, out2 = f32_case("recipe", 2)
    np.testing.assert_array_equal(out2["spix_colors"][:N], out0["spix_colors"])
    for key in ("ref_logit", "pred_colors"):
        np.testing.assert_allclose(out2[key][:N], out0[key], atol=1e-5, rtol=0, err_msg=key)
    assert not np.array_equal(out2["spix_colors"][N:2 * N], out2["spix_colors"][:N])
    np.testing.assert_array_equal(out2["hint_mask"], np.concatenate([out0["hint_mask"]] * 3))


def test_use_mask_masks_small_superpixels():
    """The key-padding mask is neither empty nor full on these inputs (the
    use_mask weights' head favours one direction), so kernel D's masked path is
    what the use_mask case holds."""
    ref, out = f32_case("use_mask", 2)
    masked = out["spixel_sizes"] < 25.0 / 256
    assert masked.any() and not masked.all()


@functools.lru_cache(maxsize=None)
def bf16_case(name: str, T: int):
    grays, colors = inputs()
    rng = np.random.default_rng(5)
    n_out = 3 * N if T > 0 else N
    mask = np.zeros((N, HC, HC, 1), np.float32)
    mask[0, 0, 1] = mask[1, 1, 0] = mask[1, 1, 1] = 1.0
    anchors = rng.uniform(-0.5, 0.5, (n_out, HC, HC, 2)).astype(np.float32)
    ref = jax_model(name, bf16=True, folded=True).apply(
        bridged(name, True)[1], jnp.asarray(grays), jnp.asarray(colors), True, T, False,
        hint_mask_override=jnp.asarray(mask), anchor_colors_override=jnp.asarray(anchors),
        rngs={"anchor": jax.random.key(3)})
    out = port_model(name, bf16=True, folded=True)(
        torch.from_numpy(grays), torch.from_numpy(colors), hint_mask_override=torch.from_numpy(mask),
        anchor_colors_override=torch.from_numpy(anchors), sampled_T=T)
    return {k: _np(v) for k, v in ref.items()}, {k: _np(v) for k, v in out.items()}, out


BF16_CASES = [("recipe", -1), ("recipe", 2)] + [(k, 2) for k in OPTIONS if k not in ("recipe", "d32", "random_hint")]


@pytest.mark.parametrize("name,T", BF16_CASES, ids=[f"{k}-T{t}" for k, t in BF16_CASES])
def test_bf16_forward_matches_jax(name, T):
    ref, out, raw = bf16_case(name, T)
    for key in ("affinity_map", "pal_logit", "ref_logit", "pred_colors"):
        if ref[key] is None:
            assert out[key] is None
            continue
        assert out[key].shape == ref[key].shape and raw[key].dtype == torch.float32, key
        tol = BF16_ATOL[key] if key in BF16_ATOL else BF16_RTOL[key] * np.abs(ref[key]).max()
        assert np.abs(out[key] - ref[key]).max() <= tol, (key, float(np.abs(out[key] - ref[key]).max()), tol)
    np.testing.assert_array_equal(out["hint_mask"], ref["hint_mask"])
    np.testing.assert_array_equal(out["spix_colors"], ref["spix_colors"])
    # sizes are counts over 256: a winner flip between near-equal bf16-fed
    # affinities moves a pixel (3 measured on these weights, 2 at 64x64 in
    # test_torch_bf16.py)
    assert np.abs(out["spixel_sizes"] - ref["spixel_sizes"]).max() <= BF16_SIZE_TOL
