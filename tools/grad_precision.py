"""How far f32 training gradients are from exact, for the port and for JAX.

Runs the colorizer training step of ``tests/test_torch_train.py`` (2+2
layers, batch 2, bridged random weights with its data-dependent conv biases,
pinned anchors) at each ``--sizes`` and prints one JSON line per size: the
largest gradient error, relative to each tensor's largest entry, of

  * the port in f32 with oneDNN's CPU convolutions, and without them,
  * the JAX package's f32 step (``make_micro_grads``),

each against the port run in float64. CPU only; no card needed:

    JAX_PLATFORMS=cpu python tools/grad_precision.py [--sizes 32 64]

The float64 run patches ``torch.Tensor.float`` to keep float64 (the port
casts its inputs to f32) and sets float64 as torch's default dtype; it runs
last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_train as ttrain  # noqa: E402


class _Patch:
    def setattr(self, obj, name, value):
        setattr(obj, name, value)


def _grads(ref, dtype, onednn: bool) -> dict:
    kmeans = ttrain.tanchor.clustering_hint_mask
    model, st, batch, loss = ttrain._port(ref, _Patch(), ref["hint1"])
    model.to(dtype)
    model.compute_dtype = dtype  # the f32 casts of the forward follow it
    st = ttrain.state.TrainState.create(model, name="sgd", schedule=ttrain.LR, momentum=0.0)
    grads, apply = {}, st.optimizer.step
    st.optimizer.step = lambda: grads.update(
        {k: p.grad.double().clone() for k, p in model.named_parameters() if p.grad is not None}) or apply()
    with torch.backends.mkldnn.flags(enabled=onednn):
        ttrain.steps.make_colorizer_train_step(loss)(st, {k: v.to(dtype) for k, v in batch.items()}, seed=0)
    ttrain.tanchor.clustering_hint_mask = kmeans
    return grads


def _worst(grads: dict, exact: dict) -> float:
    return max(float((grads[k].double() - exact[k]).abs().max() / exact[k].abs().max()) for k in exact)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[32, 64])
    args = ap.parse_args()
    runs = []
    for size in args.sizes:
        ttrain.SIZE = size
        ref = getattr(ttrain.ref, "_fixture_function", None) or ttrain.ref.__wrapped__  # pytest 8.4+ or older
        ref = ref()
        runs.append((size, ref, _grads(ref, torch.float32, True), _grads(ref, torch.float32, False)))
    torch.Tensor.float = lambda self: self
    torch.set_default_dtype(torch.float64)
    for size, ref, onednn, native in runs:
        exact = _grads(ref, torch.float64, False)
        print(json.dumps({
            "size": size,
            "port_f32_onednn": _worst(onednn, exact),
            "port_f32_native_convs": _worst(native, exact),
            "jax_f32": _worst({k: v.double() for k, v in ref["grads"].items()}, exact),
            "tensors": len(exact),
        }), flush=True)


if __name__ == "__main__":
    np.seterr(all="ignore")
    main()
