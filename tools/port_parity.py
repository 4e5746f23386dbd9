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
from disentangledcolorization_tpu.ops import colorlabel as jcl  # noqa: E402
from disentangledcolorization_tpu.ops import pallas_affinity as pa  # noqa: E402
from disentangledcolorization_tpu.ops import pallas_attention as pat  # noqa: E402
from disentangledcolorization_tpu.ops import pallas_colorlabel as pcl  # noqa: E402
from disentangledcolorization_tpu.ops import pallas_superpixel as psp  # noqa: E402
from disentangledcolorization_tpu.ops import superpixel as sp  # noqa: E402
from disentangledcolorization_tpu_torch.api import Colorizer  # noqa: E402
from disentangledcolorization_tpu_torch.models import AnchorColorProb  # noqa: E402
from disentangledcolorization_tpu_torch.ops import affinity, attention, colorlabel  # noqa: E402
from disentangledcolorization_tpu_torch.ops import superpixel as tsp  # noqa: E402
from disentangledcolorization_tpu_torch.tools.convert import from_jax_variables  # noqa: E402
from test_torch_bridge import random_state_dict, to_jax_variables  # noqa: E402
from test_torch_superpixel import _inputs as sp_inputs  # noqa: E402
import test_torch_attention_grad as agrad  # noqa: E402
import test_torch_bf16 as tbf16  # noqa: E402
import test_torch_colorlabel as tcl  # noqa: E402
import test_torch_spixel_train as tspixel  # noqa: E402
import test_torch_train as ttrain  # noqa: E402


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
    col = Colorizer(n_clusters=2, device="cpu", state_dict=from_jax_variables(variables, sn_folded=True),
                    compute_dtype="float32")
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
    hm = np.zeros((4, 3), np.float32)
    hm[0, 0] = hm[2, 1] = hm[3, 2] = 1.0
    ab = rng.uniform(-0.5, 0.5, (4, 3, 2)).astype(np.float32)
    res["colorize_hints_uint8_max_gap"] = err(col.colorize(img, hints=(hm, ab)), jcol.colorize(img, hints=(hm, ab)))
    res.update(training_parity())
    res.update(spixel_parity())
    res.update(bf16_parity(sd, sd6))
    print(json.dumps(res))


def bf16_parity(sd: dict, sd6: dict) -> dict:
    """bf16 serving (``tests/test_torch_bf16.py``): the kernel-bearing modules
    on bf16 inputs, the 2+2-layer forward with pinned anchors (the logits
    relative to their largest entry), the 6-layer Colorizer with hints, and
    the uint8 wire's ab codes in f32."""
    res, bf = {}, torch.bfloat16
    rng = np.random.default_rng(7)
    x, xj = tbf16._bf16(rng.normal(size=(2, 16, 24, 16)).astype(np.float32))
    k = (rng.normal(size=(3, 3, 16, 9)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(9,)) * 0.1).astype(np.float32)
    res["bf16_affinity_head_vs_xla"] = err(affinity.affinity_head(x, torch.from_numpy(k), torch.from_numpy(b)),
                                           pa._xla_affinity_head(xj, jnp.asarray(k), jnp.asarray(b)))
    feat, prob = sp_inputs(0, 2, 64, 64, 66)
    ft, fj = tbf16._bf16(feat)
    ours, ref = tsp.pool_and_sizes(ft, torch.from_numpy(prob), 16, 16), sp.pool_and_sizes(fj, jnp.asarray(prob), 16, 16)
    res["bf16_pool_and_sizes_vs_xla"] = max(err(a.float(), jnp.asarray(r).astype(jnp.float32)) for a, r in zip(ours, ref))
    tok, tokj = tbf16._bf16(np.random.default_rng(3).normal(size=(2, 4, 4, 64)).astype(np.float32))
    res["bf16_upfeat_vs_xla"] = err(tsp.upfeat(tok, torch.from_numpy(prob), 16, 16).float(),
                                    sp.upfeat_auto(tokj, jnp.asarray(prob), 16, 16).astype(jnp.float32))
    grays, colors, mask, anchors = tbf16._forward_inputs()
    for folded in (True, False):
        variables = to_jax_variables(sd, folded)
        model = AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=folded, compute_dtype=bf).eval()
        model.load_state_dict(from_jax_variables(variables, sn_folded=folded))
        jm = JAnchorColorProb(sp_size=16, n_clusters=2, n_enc_layers=2, sn_folded=folded, compute_dtype=jnp.bfloat16)
        ref = jm.apply(variables, jnp.asarray(grays), jnp.asarray(colors), True, 0, False,
                       hint_mask_override=jnp.asarray(mask), anchor_colors_override=jnp.asarray(anchors),
                       rngs={"anchor": jax.random.key(0)})
        with torch.no_grad():
            out = model(torch.from_numpy(grays), torch.from_numpy(colors), hint_mask_override=torch.from_numpy(mask),
                        anchor_colors_override=torch.from_numpy(anchors))
        tag = "folded" if folded else "unfolded"
        for key in ("affinity_map", "pal_logit", "ref_logit", "pred_colors", "spixel_sizes"):
            scale = float(np.abs(np.asarray(ref[key])).max()) if key.endswith("logit") else 1.0
            res[f"bf16_anchorcolorprob_{tag}_{key}"] = err(out[key], ref[key]) / scale
    variables = to_jax_variables(sd6, sn_folded=True)
    state = from_jax_variables(variables, sn_folded=True)
    img, hints = tbf16._hinted_request()
    with tempfile.TemporaryDirectory() as td:
        pkl = os.path.join(td, "bridged.pkl")
        with open(pkl, "wb") as f:
            pickle.dump(variables, f)
        jcol = JColorizer(checkpoint=pkl, n_clusters=2, compute_dtype="bfloat16")
        jwire = JColorizer(checkpoint=pkl, n_clusters=2, compute_dtype="float32", wire_dtype="uint8")
    res["bf16_colorize_hints_uint8_max_gap"] = err(Colorizer(n_clusters=2, device="cpu", state_dict=state).colorize(img, hints=hints),
                                                   jcol.colorize(img, hints=hints))
    wire = Colorizer(n_clusters=2, device="cpu", state_dict=state, compute_dtype="float32", wire_dtype="uint8")
    gray, _ = wire._prep(img)
    m, h = torch.from_numpy(hints[0])[None, ..., None], torch.from_numpy(hints[1])[None]
    with torch.no_grad():
        pred = wire.model(wire._wire_in(gray), hint_mask_override=m, anchor_colors_override=h)["pred_colors"]
    codes = torch.clamp(torch.round((pred + 1.0) * 127.5), 0, 255).to(torch.uint8)
    ref = jwire._forward(0, True)(jwire.variables, jwire._wire_in(gray.numpy()), jax.random.key(0), jnp.asarray(m.numpy()),
                                  jnp.asarray(h.numpy()))
    res["uint8_wire_ab_code_max_gap"] = err(codes.int(), np.asarray(ref).astype(np.int64))
    return res


def training_parity() -> dict:
    """The training slice's comparisons: soft labels, K6, the autograd functions' gradients
    and one training step, on the tests' inputs."""
    res = {}
    ab = tcl._ab()
    ours = colorlabel.encode_ab2ind(torch.from_numpy(ab))
    res["encode_ab2ind_vs_xla"] = err(ours, jcl.encode_ab2ind(jnp.asarray(ab), backend="xla"))
    res["encode_ab2ind_vs_pallas"] = err(ours, pcl.encode_ab2ind(jnp.asarray(ab)))
    feat, prob = sp_inputs(0, 2, 64, 64, 66)
    jp, tp = jnp.asarray(prob), torch.from_numpy(prob)
    tok = np.random.default_rng(3).normal(size=(2, 4, 4, 66)).astype(np.float32)
    res["upfeat_fused_vs_pallas"] = err(tsp.upfeat_fused(torch.from_numpy(tok), tp, 16, 16),
                                        psp.upfeat_fused(jnp.asarray(tok), jp, 16, 16))
    f = torch.from_numpy(feat).requires_grad_()
    (tsp.pool_and_sizes(f, tp, 16, 16)[0] * torch.from_numpy(tok)).sum().backward()
    res["pool_feature_grad_vs_jax"] = err(f.grad, jax.grad(
        lambda x: jnp.sum(sp.pool_and_sizes(x, jp, 16, 16, backend="xla")[0] * jnp.asarray(tok)))(jnp.asarray(feat)))
    t = torch.from_numpy(tok).requires_grad_()
    (tsp.upfeat(t, tp, 16, 16) * torch.from_numpy(feat)).sum().backward()
    res["upfeat_token_grad_vs_jax"] = err(t.grad, jax.grad(
        lambda x: jnp.sum(sp.upfeat(x, jp, 16, 16) * jnp.asarray(feat)))(jnp.asarray(tok)))
    q, k, v, g, mask = agrad._inputs(0, 2, 16, 64)
    ours = agrad._torch_grads(lambda a, b, c: attention.attention(a, b, c, 8, torch.from_numpy(mask)), q, k, v, g)
    res["attention_grads_masked_vs_jax"] = max(err(a, b) for a, b in zip(ours, agrad._jax_core_grads(q, k, v, g, 8, mask)))
    mask[0] = True  # every key of image 0 masked; the backward reads the saved statistics (max -1e9, sum T)
    ours = agrad._torch_grads(lambda a, b, c: attention.attention(a, b, c, 8, torch.from_numpy(mask)), q, k, v, g)
    res["attention_grads_fully_masked_image_vs_jax"] = max(
        err(a, b) for a, b in zip(ours, agrad._jax_core_grads(q, k, v, g, 8, mask)))

    class _Patch:
        def setattr(self, obj, name, value):
            setattr(obj, name, value)

    ref = ttrain.ref.__wrapped__()
    with torch.backends.mkldnn.flags(enabled=False):
        model, st, batch, loss = ttrain._port(ref, _Patch(), ref["hint1"])
        grads, apply = {}, st.optimizer.step
        st.optimizer.step = lambda: grads.update(
            {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}) or apply()
        metrics = ttrain.steps.make_colorizer_train_step(loss)(st, batch, seed=0)
    res["train_step_losses_max_rel"] = max(abs(float(metrics[n]) - ref["metrics"][n]) / abs(ref["metrics"][n])
                                           for n in ttrain.LOSSES)
    res["train_step_grads_max_rel_to_max"] = max(
        err(grads[n], ref["grads"][n]) / float(ref["grads"][n].abs().max()) for n in grads)
    return res


def spixel_parity() -> dict:
    """Stage 1's comparisons: the affinity map's gradients of pooling and
    unpooling (kernel G's function), the head's gradients, and one stage-1
    step, on the tests' inputs; gradients relative to their largest entry."""
    res = {}
    feat, prob, tok = sp_inputs(0, 2, 64, 64, 4)[:2] + (np.random.default_rng(3).normal(size=(2, 4, 4, 4)).astype(np.float32),)
    p = torch.from_numpy(prob).requires_grad_()
    (tsp.poolfeat(torch.from_numpy(feat), p, 16, 16) * torch.from_numpy(tok)).sum().backward()
    ref = jax.grad(lambda q: jnp.sum(sp.poolfeat(jnp.asarray(feat), q, 16, 16) * jnp.asarray(tok)))(jnp.asarray(prob))
    res["poolfeat_prob_grad_vs_jax_rel"] = err(p.grad, ref) / float(np.abs(np.asarray(ref)).max())
    p = torch.from_numpy(prob).requires_grad_()
    (tsp.upfeat(torch.from_numpy(tok), p, 16, 16) * torch.from_numpy(feat)).sum().backward()
    ref = jax.grad(lambda q: jnp.sum(sp.upfeat(jnp.asarray(tok), q, 16, 16) * jnp.asarray(feat)))(jnp.asarray(prob))
    res["upfeat_prob_grad_vs_jax_rel"] = err(p.grad, ref) / float(np.abs(np.asarray(ref)).max())
    rng = np.random.default_rng(7)
    x, k = rng.normal(size=(2, 16, 24, 16)).astype(np.float32), (rng.normal(size=(3, 3, 16, 9)) * 0.2).astype(np.float32)
    b, g = (rng.normal(size=(9,)) * 0.1).astype(np.float32), rng.normal(size=(2, 16, 24, 9)).astype(np.float32)
    xs = [torch.from_numpy(a).requires_grad_() for a in (x, k, b)]
    ours = torch.autograd.grad(affinity.affinity_head(*xs), xs, torch.from_numpy(g))
    _, vjp = jax.vjp(pa._xla_affinity_head, jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    res["affinity_head_grads_vs_jax_rel"] = max(err(a, r) / float(np.abs(np.asarray(r)).max())
                                                for a, r in zip(ours, vjp(jnp.asarray(g))))
    with torch.backends.mkldnn.flags(enabled=False):
        ref = tspixel.ref.__wrapped__()
        port = tspixel.port.__wrapped__(ref)
    res["spixel_step_losses_max_rel"] = max(abs(float(port["metrics"][n]) - ref["metrics"][n]) / abs(ref["metrics"][n])
                                            for n in tspixel.LOSSES)
    res["spixel_step_grads_max_rel_to_max"] = max(
        err(port["grads"][n], ref["grads"][n]) / float(ref["grads"][n].abs().max()) for n in ref["grads"])
    sd = port["model"].state_dict()
    res["spixel_step_running_stats"] = max(err(sd[n], ref["after"][n]) for n in ref["after"]
                                           if n.endswith(("running_mean", "running_var")))
    return res


if __name__ == "__main__":
    main()
