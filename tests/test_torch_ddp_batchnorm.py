"""The port's train-mode ``BatchNorm`` over two ranks (gloo, CPU processes)
against one process on the global batch, and that one process against flax's
``nn.BatchNorm`` (JAX ``models/layers.py::BatchNorm``), whose statistics under
pjit are the global batch's.

Each rank normalises its 4 rows of an (8, C, H, W) batch, so the statistics
must be all-reduced (``models/layers.py::_GlobalBatchNorm``); the loss is
sum(y * cot) over each rank's rows, whose sum over the ranks is the global
batch's. So a rank's input gradient equals the one-process gradient's rows,
and the weight and bias gradients averaged over the ranks (the step's
``all_reduce_gradients``) equal the one-process ones divided by 2. Held within
1e-6 of each tensor's largest entry: the output, the input gradient, the
weight and bias gradients and the running statistics, for an f32 input and a
bf16 one (normalised in f32, the output cast back). The bf16 output and input
gradient are bf16 roundings of f32 values that the two computations
(``var_mean`` in one process, the all-reduced sums over ranks) leave a few
f32 ulps apart: one that sits on a bf16 rounding boundary takes the other
side (measured: 1 of 840 outputs). Those two are held within one bf16 ulp
of each entry, and their f32 parts (statistics, affine gradients) at 1e-6.
A third case has channel means 7.5 times their spread: a one-pass
E[x^2] - E[x]^2 over the ranks moves the output there by 5e-6 of its largest
entry (measured), the all-reduced two-pass statistics by 3e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.models import layers as jl
from disentangledcolorization_tpu_torch.models.layers import BatchNorm
from torch_ddp_workers import run_ranks

C, WORLD = 6, 2
DTYPES = (torch.float32, torch.bfloat16)
CASES = {"f32": (torch.float32, 0.7), "bf16": (torch.bfloat16, 0.7), "f32_large_mean": (torch.float32, 15.0)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The one-process reference on one torch thread, as each rank runs: the
    comparison then sees what data parallelism changes, not another thread
    count's sum order (a two-image microbatch's step moves by up to 4e-5 of a
    tensor's largest entry between 1 and 3 threads, measured)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payload(dtype, mean):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(8, C, 5, 7)) * 2.0 + mean).astype(np.float32)
    x = torch.from_numpy(x).to(dtype).float().numpy()  # representable in dtype
    state = {"weight": rng.uniform(0.8, 1.2, C).astype(np.float32), "bias": (rng.normal(size=C) * 0.1).astype(np.float32),
             "running_mean": rng.normal(size=C).astype(np.float32), "running_var": rng.uniform(0.5, 2, C).astype(np.float32),
             "num_batches_tracked": np.array(0)}
    return {"x": x, "cot": rng.normal(size=x.shape).astype(np.float32), "state": state, "dtype": dtype}


def _one_process(p):
    bn = BatchNorm(C)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in p["state"].items()})
    x = torch.from_numpy(p["x"]).to(p["dtype"]).requires_grad_()
    y = bn(x, train=True)
    (y.float() * torch.from_numpy(p["cot"])).sum().backward()
    return {"y": y.detach().float(), "dx": x.grad.float(), "dw": bn.weight.grad, "db": bn.bias.grad,
            "mean": bn.running_mean.detach(), "var": bn.running_var.detach()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both dtypes in one spawn of two ranks, and the one-process results."""
    payloads = {k: _payload(*v) for k, v in CASES.items()}
    ranks = run_ranks(tmp_path_factory.mktemp("bn"), [("batchnorm", p) for p in payloads.values()], world=WORLD)
    return {k: ([r[i] for r in ranks], p) for i, (k, p) in enumerate(payloads.items())}


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, atol=1e-6 * np.abs(b).max(), rtol=0, err_msg=what)


def _within_bf16_ulp(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    assert np.all(np.abs(a - b) <= ulp), what
    assert np.mean(a != b) < 0.01, what  # rounding flips, not a wrong statistic


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_one_process_on_the_global_batch(runs, case):
    ranks, p = runs[case]
    one = _one_process(p)
    b = p["x"].shape[0] // WORLD
    rounded = _within_bf16_ulp if p["dtype"] == torch.bfloat16 else _close
    for r, out in enumerate(ranks):
        rows = slice(r * b, (r + 1) * b)
        rounded(out["y"], one["y"][rows], f"rank {r} output")
        rounded(out["dx"], one["dx"][rows], f"rank {r} input gradient")
        _close(out["dw"] * WORLD, one["dw"], f"rank {r} weight gradient")
        _close(out["db"] * WORLD, one["db"], f"rank {r} bias gradient")
        for k in ("mean", "var"):
            _close(out[k], one[k], f"rank {r} running {k}")
            assert torch.equal(out[k], ranks[0][k]), k


@pytest.mark.parametrize("case", ["f32", "bf16"])
def test_one_process_equals_flax_batchnorm(runs, case):
    """The one-process result against flax's: output and running statistics
    (1e-6 of the largest entry; bf16 outputs within one bf16 ulp of flax's, the
    two packages' f32 statistics round apart), and the f32 input, weight and
    bias gradients."""
    _, p = runs[case]
    dtype = p["dtype"]
    one = _one_process(p)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = jnp.asarray(p["x"].transpose(0, 2, 3, 1)).astype(jdt)
    params = {"scale": jnp.asarray(p["state"]["weight"]), "bias": jnp.asarray(p["state"]["bias"])}
    stats = {"mean": jnp.asarray(p["state"]["running_mean"]), "var": jnp.asarray(p["state"]["running_var"])}

    def fn(params, x):
        y, new = jl.BatchNorm(use_running_average=False).apply(
            {"params": {"bn": params}, "batch_stats": {"bn": stats}}, x, mutable=["batch_stats"])
        return y, new["batch_stats"]["bn"]

    (y, new), vjp = jax.vjp(fn, params, x)
    cot = jnp.asarray(p["cot"].transpose(0, 2, 3, 1)).astype(jdt)
    gp, gx = vjp((cot, jax.tree_util.tree_map(jnp.zeros_like, new)))
    y = np.asarray(y.astype(jnp.float32)).transpose(0, 3, 1, 2)
    if dtype == torch.bfloat16:
        _within_bf16_ulp(one["y"], y, "output")
    else:
        _close(one["y"], y, "output")
        _close(one["dx"], np.asarray(gx).transpose(0, 3, 1, 2), "input gradient")
        _close(one["dw"], gp["scale"], "weight gradient")
        _close(one["db"], gp["bias"], "bias gradient")
    _close(one["mean"], new["mean"], "running mean")
    _close(one["var"], new["var"], "running var")
