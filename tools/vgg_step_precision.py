"""Why the stage-2 step with the VGG19 term misses JAX at one torch thread: the port in float64 against JAX.

Builds the step of ``tests/test_torch_vgg.py::test_train_step_with_vgg_matches_jax``
(2+2 layers, batch 2, 32x32, bridged random weights with the data-dependent
conv biases of ``tests/test_torch_train.py``, pinned anchors, the VGG19 biases
conditioned on the step's predicted RGB, oneDNN off) and prints one JSON line:
the largest gradient difference, relative to each tensor's largest entry, of

  * the port in f32 at 1 torch thread and at 4 threads, JAX's f32 step,
    JAX's step in float64 where its modules do not fix float32 (``jax_f64``:
    the attention and loss softmaxes, the batch norms' training statistics,
    the pooled tokens and the tanh stay f32) and JAX's step in float64 with
    those casts to float32 made casts to float64 too (``jax_f64_no_f32_casts``:
    ``jnp.float32`` is bound to ``jnp.float64`` in that child process before
    the JAX package is imported; no file of the JAX package changes), each
    against the port in float64 (its f32 casts, constants and positions made
    float64 too; f32 is left only in the two packages' constant tables, the
    313 bins and their class weights);
  * the port in float64 and the port in f32 at 1 and 4 threads against JAX
    (the test's comparison, tolerance 1e-4).

If the float64 port stands within 1e-4 of JAX, the port and JAX compute the
same function and the one-thread miss is f32 summation order. The float64
port against ``jax_f64_no_f32_casts`` separates the two readings where it
does not: near f64's rounding, the two packages compute one function and
JAX's distance is the rounding of its fixed f32 casts; far from it, they
differ, and ``farthest`` names the tensors. CPU only:

    JAX_PLATFORMS=cpu python tools/vgg_step_precision.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

if sys.argv[1:2] == ["--jax-f64"]:  # a child process: x64 before JAX makes an array
    jax.config.update("jax_enable_x64", True)
    if "no_f32_casts" in sys.argv[3:]:
        # before the JAX package is imported: its modules also take jnp.float32 as a default argument and as a
        # field's default (the position code's dtype, the model's compute dtype), read once at import
        jnp.float32 = jnp.float64
import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import condition_vgg  # noqa: E402
from disentangledcolorization_tpu.models import AnchorColorProb as JAnchorColorProb  # noqa: E402
from disentangledcolorization_tpu.models.vgg import load_vgg19_params  # noqa: E402
from disentangledcolorization_tpu.train import losses as jlosses  # noqa: E402
from disentangledcolorization_tpu.train import steps as jsteps  # noqa: E402
from disentangledcolorization_tpu_torch.models import AnchorColorProb  # noqa: E402
from disentangledcolorization_tpu_torch.models import anchor as tanchor  # noqa: E402
from disentangledcolorization_tpu_torch.models import disco  # noqa: E402
from disentangledcolorization_tpu_torch.models.vgg import load_vgg19, make_random_vgg19_npz  # noqa: E402
from disentangledcolorization_tpu_torch.ops import superpixel  # noqa: E402
from disentangledcolorization_tpu_torch.tools.convert import from_jax_variables, grads_from_jax  # noqa: E402
from disentangledcolorization_tpu_torch.train import losses, state, steps  # noqa: E402
from disentangledcolorization_tpu_torch.utils.color import lab2rgb  # noqa: E402
from test_torch_bridge import random_state_dict, to_jax_variables  # noqa: E402
from test_torch_train import SIZE, _gap_conditioned  # noqa: E402


def setup(tmp: str) -> dict:
    """The test's weights, batch, pinned anchors, conditioned VGG npz and JAX's gradients."""
    npz = make_random_vgg19_npz(os.path.join(tmp, "vgg19.npz"), seed=0)
    rng = np.random.default_rng(5)
    gray = rng.uniform(-1, 1, (2, SIZE, SIZE, 1)).astype(np.float32)
    color = rng.uniform(-0.5, 0.5, (2, SIZE, SIZE, 2)).astype(np.float32)
    torch.manual_seed(4)
    sd = random_state_dict(AnchorColorProb(n_clusters=2, n_enc_layers=2), seed=4)
    jm = JAnchorColorProb(sp_size=16, n_clusters=2, n_enc_layers=2, enhanced=True, dropout=0.0)
    anchor_key, dropout_key = jax.random.split(jax.random.fold_in(jax.random.key(6), 0))
    g, c = jnp.asarray(gray), jnp.asarray(color)
    hint = np.asarray(jax.jit(lambda v: jm.apply(v, g, c, False, 0, True, rngs={"anchor": anchor_key,
                                                                                "dropout": dropout_key},
                                                 mutable=["batch_stats", "spectral"])[0]["hint_mask"])(
        to_jax_variables(sd, False)))
    variables = to_jax_variables(_gap_conditioned(sd, gray, color, [hint], microbatches=False), False)
    model = AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=False, dropout=0.0)
    model.load_state_dict(from_jax_variables(variables, sn_folded=False))
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    tanchor.clustering_hint_mask = lambda *a, **k: (torch.from_numpy(hint), None)
    torch.set_num_threads(1)
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        pred = model(torch.from_numpy(gray), torch.from_numpy(color), test_mode=False, train=True)["pred_colors"]
    vgg = load_vgg19(npz, "lpips", device="cpu")
    condition_vgg(vgg, lab2rgb(torch.cat([torch.from_numpy(gray), pred], dim=-1)), gap=1e-3)
    npz = os.path.join(tmp, "conditioned.npz")
    np.savez(npz, **{k: v.numpy() for k, v in vgg.state_dict().items()})
    jloss = jlosses.AnchorColorProbLoss(enhanced=True, vgg_variables=load_vgg19_params(npz))
    grads, _, _ = jax.jit(jsteps.make_micro_grads(jm, jloss))(
        variables["params"], variables["batch_stats"], variables["spectral"], g, c, anchor_key, dropout_key)
    jax_grads = {k: v.double() for k, v in grads_from_jax(jax.tree_util.tree_map(np.asarray, grads)).items()}
    return {"variables": variables, "buffers": buffers, "gray": gray, "color": color, "npz": npz, "jax": jax_grads,
}


def jax_f64_grads(ref: dict, tmp: str, no_f32_casts: bool = False) -> dict:
    """JAX's step in float64 (``jax_enable_x64``, every leaf and input cast
    to float64), in a child process: x64 must be set before JAX makes an
    array. Where the flax modules fix float32 (softmax casts, batch-norm
    statistics, pooled tokens, tanh), those steps stay f32, unless
    ``no_f32_casts``."""
    import pickle
    import subprocess

    path = os.path.join(tmp, f"f64_{int(no_f32_casts)}.pkl")
    with open(path, "wb") as f:
        pickle.dump({k: ref[k] for k in ("variables", "gray", "color", "npz")}, f)
    subprocess.run([sys.executable, os.path.abspath(__file__), "--jax-f64", path, *(["no_f32_casts"] if no_f32_casts
                                                                                    else [])], check=True)
    with open(path + ".grads", "rb") as f:
        return {k: torch.from_numpy(v).double() for k, v in pickle.load(f).items()}


def _jax_f64_child(path: str) -> None:
    import pickle

    with open(path, "rb") as f:
        ref = pickle.load(f)
    f64 = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x), jnp.float64), tree)  # noqa: E731
    jm = JAnchorColorProb(sp_size=16, n_clusters=2, n_enc_layers=2, enhanced=True, dropout=0.0)
    anchor_key, dropout_key = jax.random.split(jax.random.fold_in(jax.random.key(6), 0))
    jloss = jlosses.AnchorColorProbLoss(enhanced=True, vgg_variables=f64(load_vgg19_params(ref["npz"])))
    v = f64(ref["variables"])
    grads, _, _ = jax.jit(jsteps.make_micro_grads(jm, jloss))(
        v["params"], v["batch_stats"], v["spectral"], f64(ref["gray"]), f64(ref["color"]), anchor_key, dropout_key)
    out = {k: t.double().numpy() for k, t in grads_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64), grads)).items()}
    with open(path + ".grads", "wb") as f:
        pickle.dump(out, f)


def port_grads(ref: dict, dtype: torch.dtype, threads: int) -> dict:
    model = AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=False, dropout=0.0)
    model.load_state_dict({**from_jax_variables(ref["variables"], sn_folded=False), **ref["buffers"]})
    model.to(dtype)
    model.compute_dtype = dtype
    vgg = load_vgg19(ref["npz"], device="cpu").to(dtype)
    for name in ("mean", "std"):  # ImageNet's statistics as both packages hold them: f32 constants
        getattr(vgg, name).copy_(getattr(vgg, name).to(torch.float32).to(dtype))
    st = state.TrainState.create(model, name="sgd", schedule=0.0, momentum=0.0)
    grads, apply = {}, st.optimizer.step
    st.optimizer.step = lambda: grads.update(
        {k: p.grad.double().clone() for k, p in model.named_parameters() if p.grad is not None}) or apply()
    bundle = losses.AnchorColorProbLoss(enhanced=True, vgg=vgg)
    torch.set_num_threads(threads)
    with torch.backends.mkldnn.flags(enabled=False):
        steps.make_colorizer_train_step(bundle)(st, {"gray": torch.from_numpy(ref["gray"]).to(dtype),
                                                     "color": torch.from_numpy(ref["color"]).to(dtype)})
    return grads


def worst(grads: dict, against: dict) -> float:
    return max(float((grads[k] - against[k]).abs().max() / against[k].abs().max()) for k in grads)


def worst_tensors(grads: dict, against: dict, n: int = 3) -> list:
    """The ``n`` tensors farthest apart, with their distance."""
    d = {k: float((grads[k] - against[k]).abs().max() / against[k].abs().max()) for k in grads}
    return sorted(d.items(), key=lambda kv: -kv[1])[:n]


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        ref = setup(tmp)
        jax64, jax64_full = jax_f64_grads(ref, tmp), jax_f64_grads(ref, tmp, no_f32_casts=True)
        f32_1, f32_4 = port_grads(ref, torch.float32, 1), port_grads(ref, torch.float32, 4)
        torch.Tensor.float = lambda self: self  # the port's f32 casts keep float64
        torch.set_default_dtype(torch.float64)
        # and its f32 constants and positions become float64: the attention scale 1/sqrt(hd), the sine code
        tensor, position = torch.tensor, disco.sine_position_encoding
        torch.tensor = lambda data, *a, dtype=None, **k: tensor(
            data, *a, dtype=torch.float64 if dtype == torch.float32 else dtype, **k)
        disco.sine_position_encoding = lambda *a, dtype=None, **k: position(*a, dtype=torch.float64, **k)
        pool = superpixel.pool_shift_add  # pooling's outputs in float64, not its f32 output type
        superpixel.pool_shift_add = lambda feat, prob, *a, dtype=torch.float32, **k: pool(
            feat, prob, *a, dtype=torch.float64 if feat.dtype == torch.float64 else dtype, **k)
        f64 = port_grads(ref, torch.float64, 1)
    print(json.dumps({
        "size": SIZE, "tensors": len(f64),
        "against_port_f64": {"port_f32_1_thread": worst(f32_1, f64), "port_f32_4_threads": worst(f32_4, f64),
                             "jax_f32": worst({k: ref["jax"][k] for k in f64}, f64),
                             "jax_f64": worst({k: jax64[k] for k in f64}, f64),
                             "jax_f64_no_f32_casts": worst({k: jax64_full[k] for k in f64}, f64)},
        "against_jax_f32": {"port_f64": worst(f64, ref["jax"]), "port_f32_1_thread": worst(f32_1, ref["jax"]),
                            "port_f32_4_threads": worst(f32_4, ref["jax"])},
        "test_tolerance": 1e-4,
        "farthest": {"jax_f64_vs_port_f64": worst_tensors({k: jax64[k] for k in f64}, f64),
                     "jax_f64_no_f32_casts_vs_port_f64": worst_tensors({k: jax64_full[k] for k in f64}, f64),
                     "jax_f64_no_f32_casts_vs_jax_f64": worst_tensors({k: jax64_full[k] for k in f64},
                                                                      {k: jax64[k] for k in f64}),
                     "port_f32_4_threads_vs_port_f64": worst_tensors(f32_4, f64),
                     "port_f32_1_thread_vs_jax_f32": worst_tensors(f32_1, {k: ref["jax"][k] for k in f32_1})},
    }), flush=True)


if __name__ == "__main__":
    np.seterr(all="ignore")
    if sys.argv[1:2] == ["--jax-f64"]:
        _jax_f64_child(sys.argv[2])
    else:
        main()
