"""Print the CPU parity of the PyTorch port against the JAX package as one JSON line.

Runs the comparisons of ``tests/test_torch_*.py`` on the same seeded inputs
and reports each one's max |difference| (the tests assert the tolerances;
this script gives the numbers). CPU only; no card needed:

    JAX_PLATFORMS=cpu python tools/port_parity.py
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from disentangledcolorization_tpu.api import Colorizer as JColorizer  # noqa: E402
from disentangledcolorization_tpu.models import AnchorColorProb as JAnchorColorProb  # noqa: E402
from disentangledcolorization_tpu.ops import pallas_affinity as pa  # noqa: E402
from disentangledcolorization_tpu.ops import pallas_attention as pat  # noqa: E402
from disentangledcolorization_tpu.ops import pallas_superpixel as psp  # noqa: E402
from disentangledcolorization_tpu.ops import superpixel as sp  # noqa: E402
from disentangledcolorization_tpu_torch.api import Colorizer  # noqa: E402
from disentangledcolorization_tpu_torch.models import AnchorColorProb  # noqa: E402
from disentangledcolorization_tpu_torch.ops import affinity, attention  # noqa: E402
from disentangledcolorization_tpu_torch.ops import superpixel as tsp  # noqa: E402
from disentangledcolorization_tpu_torch.tools.convert import from_jax_variables  # noqa: E402
from test_torch_bridge import random_state_dict, to_jax_variables  # noqa: E402
from test_torch_superpixel import _inputs as sp_inputs  # noqa: E402


def err(a, b) -> float:
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a.astype(np.float64) - np.asarray(b, np.float64)).max())


def main() -> None:
    res = {}
    feat, prob = sp_inputs(0, 2, 64, 64, 66)
    tf, tp, jf, jp = torch.from_numpy(feat), torch.from_numpy(prob), jnp.asarray(feat), jnp.asarray(prob)
    ours = tsp.pool_and_sizes(tf, tp, 16, 16)
    res["pool_and_sizes_vs_xla"] = max(err(a, b) for a, b in zip(ours, sp.pool_and_sizes(jf, jp, 16, 16, backend="xla")))
    res["pool_and_sizes_vs_pallas"] = max(err(a, b) for a, b in zip(ours, psp.pool_and_sizes(jf, jp, 16, 16)))
    tok = np.random.default_rng(3).normal(size=(2, 4, 4, 64)).astype(np.float32)
    res["upfeat_vs_pallas"] = err(tsp.upfeat(torch.from_numpy(tok), tp, 16, 16), psp.upfeat(jnp.asarray(tok), jp, 16, 16))

    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 24, 16)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 16, 9)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(9,)) * 0.1).astype(np.float32)
    res["affinity_head_vs_pallas"] = err(
        affinity.affinity_head(*map(torch.from_numpy, (x, k, b))), pa.fused_affinity_head(*map(jnp.asarray, (x, k, b)))
    )
    q, kk, v = (rng.normal(size=(2, 16, 64)).astype(np.float32) for _ in range(3))
    res["attention_core_vs_pallas"] = err(
        attention.attention(*map(torch.from_numpy, (q, kk, v)), 8), pat.fused_attention(*map(jnp.asarray, (q, kk, v)), 8)
    )

    torch.manual_seed(1)
    sd = random_state_dict(AnchorColorProb(n_clusters=2, n_enc_layers=2), seed=1)
    grays = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 1)).astype(np.float32)
    colors = np.random.default_rng(0).uniform(-0.5, 0.5, (2, 64, 64, 2)).astype(np.float32)
    mask = np.zeros((2, 4, 4, 1), np.float32)
    mask[0, 1, 1] = mask[0, 2, 3] = mask[1, 0, 2] = mask[1, 3, 0] = 1.0
    for folded in (False, True):
        variables = to_jax_variables(sd, folded)
        model = AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=folded).eval()
        model.load_state_dict(from_jax_variables(variables, sn_folded=folded))
        jm = JAnchorColorProb(sp_size=16, n_clusters=2, n_enc_layers=2, sn_folded=folded)
        ref = jm.apply(variables, jnp.asarray(grays), jnp.asarray(colors), True, 0, False,
                       hint_mask_override=jnp.asarray(mask), rngs={"anchor": jax.random.key(0)})
        out = model(torch.from_numpy(grays), torch.from_numpy(colors), hint_mask_override=torch.from_numpy(mask))
        tag = "folded" if folded else "unfolded"
        for key in ("pal_logit", "ref_logit", "pred_colors", "spixel_sizes"):
            res[f"anchorcolorprob_{tag}_{key}"] = err(out[key], ref[key])

    torch.manual_seed(2)
    sd6 = random_state_dict(AnchorColorProb(n_clusters=2), seed=2)
    variables = to_jax_variables(sd6, sn_folded=True)
    with tempfile.TemporaryDirectory() as td:
        pkl = os.path.join(td, "bridged.pkl")
        with open(pkl, "wb") as f:
            pickle.dump(variables, f)
        jcol = JColorizer(checkpoint=pkl, n_clusters=2, compute_dtype="float32")
    col = Colorizer(n_clusters=2, device="cpu", state_dict=from_jax_variables(variables, sn_folded=True))
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
    hm = np.zeros((4, 3), np.float32)
    hm[0, 0] = hm[2, 1] = hm[3, 2] = 1.0
    ab = rng.uniform(-0.5, 0.5, (4, 3, 2)).astype(np.float32)
    res["colorize_hints_uint8_max_gap"] = err(col.colorize(img, hints=(hm, ab)), jcol.colorize(img, hints=(hm, ab)))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
