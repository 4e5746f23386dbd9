"""Weight bridge, import hygiene and CPU routing of the port.

* ``from_jax_variables(convert_disco_state_dict(sd, sn_folded=False))`` gives
  back ``sd`` on every key the converter reads (``weight_v`` is rebuilt as
  normalize(W^T u), the port's own initial value: 1e-6).
* No port module (nor ``chip_smoke.py``) imports jax, flax, cv2 or the JAX
  package.
* On CPU tensors every kernel wrapper runs its plain version and counts no
  launch.

The helpers here build random port weights and bridge them to JAX variables;
``test_torch_disco.py`` uses them too.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.tools import convert_torch as cvt
from disentangledcolorization_tpu_torch import resolve_device
from disentangledcolorization_tpu_torch.models import AnchorColorProb
from disentangledcolorization_tpu_torch.ops import affinity, attention, colorlabel, kernels, quant, superpixel
from disentangledcolorization_tpu_torch.tools.convert import from_jax_variables
from torch_fixtures import one_thread, tmp_path  # noqa: F401 (one thread; tmp_path removed if passed)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """The model's (seeded) weights as numpy, with BN statistics, BN/LN
    scales and every bias randomized so no leaf keeps a default value."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        v = v.detach().numpy().copy()
        if k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith(("running_mean", "bias")):
            v = rng.normal(size=v.shape) * 0.1
        elif k.endswith(".weight") and v.ndim == 1:
            v = rng.uniform(0.8, 1.2, v.shape)
        sd[k] = v.astype(v.dtype if v.dtype == np.int64 else np.float32)
    return sd


def to_jax_variables(sd: dict, sn_folded: bool) -> dict:
    """Port state_dict -> JAX variables through ``convert_disco_state_dict``.

    The converter reads six encoder layers; a shallower model's layers are
    padded with copies for it and dropped from the variables afterwards. A
    model without ``enhanceNet`` is converted with ``enhanced=False``; the
    converter has no ``pos_enc`` (``learning_pos``), so its two tables are put
    into the params here, as flax ``nn.Embed`` keeps them (rows, features).
    """
    n_layers = len({k.split(".")[2] for k in sd if k.startswith("wildpath.layers.")})
    full = dict(sd)
    for path in ("wildpath", "hintpath"):
        for i in range(n_layers, 6):
            for k, v in sd.items():
                if k.startswith(f"{path}.layers.0."):
                    full[k.replace(".layers.0.", f".layers.{i}.", 1)] = v
    variables = cvt.convert_disco_state_dict(
        full, sn_folded=sn_folded, enhanced=any(k.startswith("enhanceNet.") for k in sd))
    if "pos_enc.row_embed.weight" in sd:
        variables["params"]["pos_enc"] = {t: {"embedding": sd[f"pos_enc.{t}.weight"]} for t in ("row_embed", "col_embed")}
    for coll in variables.values():
        for path in ("wildpath", "hintpath"):
            for i in range(n_layers, 6):
                coll.get(path, {}).pop(f"layer{i}", None)
    return variables


@pytest.fixture(scope="module")
def unfolded_sd():
    torch.manual_seed(0)
    return random_state_dict(AnchorColorProb(n_clusters=2, sn_folded=False), seed=0)


def test_bridge_round_trip(unfolded_sd):
    back = from_jax_variables(cvt.convert_disco_state_dict(unfolded_sd, sn_folded=False), sn_folded=False)
    assert set(back) == set(unfolded_sd)
    for k, v in unfolded_sd.items():
        assert back[k].shape == v.shape, k
        tol = 1e-6 if k.endswith("weight_v") else 0.0
        np.testing.assert_allclose(back[k].numpy(), v, atol=tol, rtol=0, err_msg=k)


def test_bridge_loads_strict_in_both_forms(unfolded_sd):
    for folded in (False, True):
        sd = from_jax_variables(to_jax_variables(unfolded_sd, folded), sn_folded=folded)
        AnchorColorProb(n_clusters=2, sn_folded=folded).load_state_dict(sd)  # strict


def test_deconv_flip_undone(unfolded_sd):
    """The JAX Deconv kernel is pre-flipped HWIO; the bridge restores torch's
    (I, O, kh, kw) layout, so a round trip returns each deconv weight."""
    k = "segnet.net.deconv3.0.weight"
    v = cvt.convert_disco_state_dict(unfolded_sd, sn_folded=True)
    jk = v["params"]["segnet"]["net"]["deconv3"]["deconv"]["kernel"]
    assert not np.array_equal(np.transpose(jk, (2, 3, 0, 1)), unfolded_sd[k])
    np.testing.assert_array_equal(from_jax_variables(v, sn_folded=True)[k].numpy(), unfolded_sd[k])


def test_reference_checkpoint_is_folded_like_the_converter(unfolded_sd, tmp_path):
    """A reference-layout checkpoint (torch spectral norm: weight_orig, u, v)
    loads into the serving Colorizer with sigma = u . (W v) divided in, the
    same weights ``convert_disco_state_dict(sn_folded=True)`` gives."""
    from disentangledcolorization_tpu_torch.api import Colorizer

    path = tmp_path / "ref.pth.tar"
    torch.save({"state_dict": {"module." + k: torch.tensor(v) for k, v in unfolded_sd.items()}}, path)
    loaded = Colorizer(checkpoint=str(path), n_clusters=2, device="cpu").model.state_dict()
    bridged = from_jax_variables(cvt.convert_disco_state_dict(unfolded_sd, sn_folded=True), sn_folded=True)
    for k, v in loaded.items():
        if k.endswith("weight_orig") or not k.endswith(("weight_u", "weight_v")):
            torch.testing.assert_close(v, bridged[k], atol=1e-6, rtol=1e-5, msg=k)


def test_gamut_tables_are_byte_copies():
    for name in ("gamut_pts.npy", "gamut_probs.npy"):
        with open(os.path.join(REPO, "disentangledcolorization_tpu", "utils", name), "rb") as a:
            with open(os.path.join(REPO, "disentangledcolorization_tpu_torch", "utils", name), "rb") as b:
                assert a.read() == b.read()


def test_port_imports_no_jax():
    pkg = os.path.join(REPO, "disentangledcolorization_tpu_torch")
    mods = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    code = (
        "import importlib, sys\n"
        f"for m in {sorted(mods)!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2', 'disentangledcolorization_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert len(mods) >= 15


def test_wrappers_route_cpu_tensors_to_plain_versions():
    g = torch.Generator().manual_seed(0)
    feat = torch.randn(1, 32, 32, 5, generator=g)
    prob = torch.softmax(torch.randn(1, 32, 32, 9, generator=g), -1)
    x = torch.randn(1, 8, 8, 16, generator=g)
    kern, bias = torch.randn(3, 3, 16, 9, generator=g), torch.randn(9, generator=g)
    q, k, v = (torch.randn(2, 16, 64, generator=g) for _ in range(3))
    tok = torch.randn(1, 2, 2, 5, generator=g)
    ab = torch.rand(1, 4, 4, 2, generator=g) - 0.5
    keep = torch.rand(2, 8, 16, 16, generator=g) < 0.9
    kernels.reset_launch_counts()
    pairs = [
        (superpixel.pool_stats(feat, prob, 16, 16), superpixel.pool_stats_plain(feat, prob, 16, 16)),
        (superpixel.upfeat(tok, prob, 16, 16), superpixel.upfeat_plain(tok, prob, 16, 16)),
        (superpixel.pool_stats(feat.bfloat16(), prob, 16, 16), superpixel.pool_stats_plain(feat.bfloat16(), prob, 16, 16)),
        (superpixel.upfeat(tok.bfloat16(), prob, 16, 16), superpixel.upfeat_plain(tok.bfloat16(), prob, 16, 16)),
        (affinity.affinity_head(x.bfloat16(), kern, bias), affinity.affinity_head_plain(x.bfloat16(), kern, bias)),
        (superpixel.pool_shift_add(feat, prob, 16, 16), superpixel.pool_shift_add_plain(feat, prob, 16, 16)),
        (superpixel.pool_shift_add(feat.bfloat16(), prob, 16, 16, dtype=torch.bfloat16),
         superpixel.pool_shift_add_plain(feat.bfloat16(), prob, 16, 16, dtype=torch.bfloat16)),
        (superpixel.pool_shift_add(feat.bfloat16(), prob, 16, 16, False, False, 1.0, torch.bfloat16)[0],
         superpixel.pool_shift_add_plain(feat.bfloat16(), prob, 16, 16, False, False, 1.0, torch.bfloat16)[0]),
        (affinity.affinity_head(x, kern, bias), affinity.affinity_head_plain(x, kern, bias)),
        (attention.attention(q, k, v, 8), attention.attention_plain(q, k, v, 8)),
        (attention.attention(q, k, v, 8, None, keep, 0.1), attention.attention_plain(q, k, v, 8, None, keep, 0.1)),
        (attention.attention_bwd(q, k, v, v, 8), attention.attention_bwd_plain(q, k, v, v, 8)),
        (colorlabel.encode_ab2ind(ab), colorlabel.encode_ab2ind_plain(ab)),
        (superpixel.prob_grad(feat, tok, tok[..., 0], 16, 16), superpixel.prob_grad_plain(feat, tok, tok[..., 0], 16, 16)),
    ]
    xq = torch.randn(1, 32, 6, 6, generator=g)
    wq, mw = quant.quantize_weight(torch.randn(8, 32, 3, 3, generator=g))
    amax = torch.tensor(2.0)
    for dt in (torch.float32, torch.bfloat16):
        pairs += [(quant.quantize_activation(xq.to(dt), amax), quant.quantize_activation_plain(xq.to(dt), amax)),
                  (quant.int8_conv_q(xq.to(dt), wq, mw, bias[:8], 1, amax),
                   quant.int8_conv_plain(quant.quantize_activation_plain(xq.to(dt), amax), amax, wq, mw, bias[:8], 1, dt))]
    for a, b in pairs:
        for x_, y_ in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x_, y_)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    assert set(kernels.LAUNCHES) == {
        "pool_stats", "affinity_head", "upfeat", "attention", "attention_bwd", "encode_ab2ind", "prob_grad",
        "pool_stats[bf16]", "affinity_head[bf16]", "upfeat[bf16]",
        "quantize", "quantize[bf16]", "int8_conv", "int8_conv[bf16]",
    }


def test_check_cuda_rejects_cpu_tensors():
    with pytest.raises(ValueError):
        kernels.check_cuda("k", {"a": torch.zeros(2)})


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
