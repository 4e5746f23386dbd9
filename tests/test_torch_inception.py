"""The port's InceptionV3 extractor and its weight bridge against the JAX package, on the CPU.

* ``InceptionV3Features`` features (N, 2048) and ``with_logits`` class logits
  (N, 1000) at (2, 75, 75, 3), the smallest input the stem takes, against the
  JAX model on the same weights: within 1e-4 of the largest entry. The JAX
  variables come from the port's seeded ``state_dict`` through the JAX
  package's own ``convert_inception_torchvision(sd, include_fc=True)``: no
  flax ``init`` is built (it takes about 20 s here).
* The bridge both ways, exact: ``inception_to_jax_variables`` equals
  ``convert_inception_torchvision`` leaf for leaf, and
  ``inception_from_jax_variables`` gives the ``state_dict`` back.
* Every key of a torchvision-layout ``inception_v3`` (the reference net of
  ``tests/test_extractor_parity.py``) is filled, and that net's weights give
  its features and logits through the port.
* The conv parameter count lies in the range that JAX's test asserts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.models.inception import InceptionV3Features as JInception
from disentangledcolorization_tpu.tools.convert_torch import convert_inception_torchvision
from disentangledcolorization_tpu_torch.models.inception import (
    InceptionV3Features,
    load_inception,
    random_inception_state_dict,
)
from disentangledcolorization_tpu_torch.tools.convert import inception_from_jax_variables, inception_to_jax_variables

TOL = 1e-4  # of the largest entry: f32 sums of up to 2,048 x 9 products through 94 convs, in other orders


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread: the suite's parallel workers, each with
    a thread per core, would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def seeded_inception_state_dict(seed: int = 3) -> dict[str, torch.Tensor]:
    """``random_inception_state_dict(seed)`` with BatchNorm moved off the
    identity (running means in +-0.1, variances, scales in [0.5, 1.5], biases
    in +-0.1) and a nonzero ``fc`` bias, so the bridge's every leaf matters."""
    sd = random_inception_state_dict(seed)
    rng = np.random.default_rng(seed + 100)
    lo_hi = {"running_mean": (-0.1, 0.1), "running_var": (0.5, 1.5), "bn.weight": (0.5, 1.5),
             "bn.bias": (-0.1, 0.1), "fc.bias": (-0.5, 0.5)}
    for k, v in sd.items():
        for suffix, (lo, hi) in lo_hi.items():
            if k.endswith(suffix):
                sd[k] = torch.from_numpy(rng.uniform(lo, hi, tuple(v.shape)).astype(np.float32))
    return sd


def jax_variables(sd: dict) -> dict:
    return convert_inception_torchvision({k: v.numpy() for k, v in sd.items()}, include_fc=True)


def rel_to_max(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def bridged():
    sd = seeded_inception_state_dict()
    return sd, jax_variables(sd)


@pytest.mark.parametrize("with_logits", [False, True])
def test_inception_matches_jax(bridged, with_logits):
    sd, variables = bridged
    x = np.random.default_rng(0).uniform(0, 1, (2, 75, 75, 3)).astype(np.float32)
    model = load_inception(inception_from_jax_variables(variables, include_fc=True), with_logits, device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(JInception(with_logits=with_logits).apply(variables, jnp.asarray(x)))
    assert out.shape == ref.shape == (2, 1000 if with_logits else 2048)
    assert rel_to_max(out, ref) < TOL


def test_bridge_both_ways_exact(bridged):
    sd, variables = bridged
    for include_fc in (False, True):
        ours = flat(inception_to_jax_variables(sd, include_fc=include_fc))
        theirs = flat(convert_inception_torchvision({k: v.numpy() for k, v in sd.items()}, include_fc=include_fc))
        assert sorted(ours) == sorted(theirs)
        assert all(np.array_equal(ours[k], theirs[k]) and ours[k].dtype == theirs[k].dtype for k in ours)
    back = inception_from_jax_variables(variables, include_fc=True)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    no_fc = inception_from_jax_variables(variables)
    assert sorted(no_fc) == sorted(k for k in sd if not k.startswith("fc."))
    without_fc = {"params": {k: v for k, v in variables["params"].items() if k != "fc"},
                  "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="fc"):
        inception_from_jax_variables(without_fc, include_fc=True)


def test_every_torchvision_key_filled():
    from test_extractor_parity import _torch_inception3

    net = _torch_inception3(torch)
    ref_sd = net.state_dict()
    assert sorted(InceptionV3Features(with_logits=True).state_dict()) == sorted(ref_sd)
    model = load_inception(dict(ref_sd), with_logits=True, device="cpu")
    feats = load_inception(dict(ref_sd), with_logits=False, device="cpu")  # fc.* dropped
    x = np.random.default_rng(1).uniform(0, 1, (1, 75, 75, 3)).astype(np.float32)
    with torch.no_grad():
        ref_feats, ref_logits = net(torch.from_numpy(x * 2 - 1).permute(0, 3, 1, 2))
        assert rel_to_max(model(torch.from_numpy(x)), ref_logits) < 1e-6
        assert rel_to_max(feats(torch.from_numpy(x)), ref_feats) < 1e-6


def test_parameter_count_and_frozen():
    model = InceptionV3Features()
    n_params = sum(p.numel() for p in model.parameters())  # conv kernels + BatchNorm scale and bias
    assert 20e6 < n_params < 24e6, n_params
    assert not any(p.requires_grad for p in model.parameters())
    model.train()  # BatchNorm reads its running statistics in either mode
    x = torch.rand(1, 75, 75, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        a = model(x)
        model.eval()
        assert torch.equal(a, model(x))
