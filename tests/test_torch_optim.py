"""The port's optimizers, schedules and device-data loader against the JAX package.

* ``build_schedule`` (poly, cosine, constant) gives the JAX schedule's value at
  every update count (1e-6 relative or 1e-10 absolute: JAX evaluates the
  formula in f32, the port in Python floats).
* ``build_optimizer`` (adam with weight decay, sgd with momentum, with and
  without ``grad_clip``) takes three updates on the same parameters and
  gradients as the optax chain the JAX package builds: 1e-5 absolute on
  parameters of size ~1 (a few f32 roundings per update, in another order).
* A non-finite gradient with ``grad_clip`` skips the whole update, moments
  and schedule included, as ``optax.apply_if_finite``.
* ``PlateauState`` and ``DeviceIndexLoader`` give the same sequences as the
  JAX ones, and ``stack_dataset`` stacks as ``stack_dataset`` there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from disentangledcolorization_tpu.train import data as jdata
from disentangledcolorization_tpu.train import optim as joptim
from disentangledcolorization_tpu_torch.train import data, optim


@pytest.mark.parametrize("name", ["poly", "cosine", "constant"])
def test_schedules_match_jax(name):
    ours, ref = optim.build_schedule(name, 2e-4, 6, 10), joptim.build_schedule(name, 2e-4, 6, 10)
    for count in (0, 1, 9, 10, 35, 59, 60, 80):
        want = ref if isinstance(ref, float) else float(ref(count))
        np.testing.assert_allclose(ours(count), want, rtol=1e-6, atol=1e-10)


def _params_and_grads(seed):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) * 3 for p in params] for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("name,kwargs", [
    ("adam", {"weight_decay": 1e-2}),
    ("adam", {"grad_clip": 1.0}),
    ("sgd", {"momentum": 0.9, "weight_decay": 1e-3, "grad_clip": 2.0}),
])
def test_updates_match_optax(name, kwargs):
    params, grads = _params_and_grads(0)
    schedule = optim.build_schedule("poly", 0.1, 2, 2)
    tx = joptim.build_optimizer(name, joptim.build_schedule("poly", 0.1, 2, 2), **kwargs)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = optim.build_optimizer(tp, name, schedule, **kwargs)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        assert opt.step()
        opt.zero_grad()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5, rtol=0)
    assert opt.count == 3


def test_non_finite_gradient_skips_the_update():
    params, grads = _params_and_grads(1)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = optim.build_optimizer(tp, "adam", 1e-3, grad_clip=1.0)
    for p, x in zip(tp, grads[0]):
        p.grad = torch.from_numpy(x.copy())
    tp[1].grad[0] = float("inf")
    assert not opt.step()
    assert opt.count == 0 and not opt.opt.state
    for a, b in zip(tp, params):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    tx = joptim.build_optimizer("adam", 1e-3, grad_clip=1.0)
    jp = [jnp.asarray(p) for p in params]
    updates, _ = tx.update([jnp.asarray(x.numpy()) for x in (tp[0].grad, tp[1].grad)], tx.init(jp), jp)
    assert all(float(jnp.abs(u).max()) == 0.0 for u in jax.tree_util.tree_leaves(updates))


def test_plateau_matches_jax():
    ours, ref = optim.PlateauState(patience=1), joptim.PlateauState(patience=1)
    for loss in (3.0, 2.0, 2.5, 2.4, 2.1, 1.0, 1.5, 1.5, 1.5):
        assert ours.update(loss) == ref.update(loss)


def test_device_index_loader_matches_jax():
    for shuffle, drop_last in ((True, True), (False, False), (True, False)):
        ours = data.DeviceIndexLoader(23, 5, shuffle=shuffle, seed=3, drop_last=drop_last)
        ref = jdata.DeviceIndexLoader(23, 5, shuffle=shuffle, seed=3, drop_last=drop_last)
        for epoch in (0, 2):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            a, b = list(ours), list(ref)
            assert len(a) == len(b) == len(ours) == len(ref)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_stack_dataset_matches_jax():
    rng = np.random.default_rng(4)
    ds = [{"gray": rng.normal(size=(8, 8, 1)).astype(np.float32), "color": rng.normal(size=(8, 8, 2)).astype(np.float32)}
          for _ in range(3)]
    ours, ref = data.stack_dataset(ds), jdata.stack_dataset(ds)
    for k in ("gray", "color"):
        np.testing.assert_array_equal(ours[k].numpy(), ref[k])
    with pytest.raises(ValueError, match="budget"):
        data.stack_dataset(ds, budget_gb=1e-9)
