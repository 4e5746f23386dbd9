"""The attention core at queries and keys of different lengths, and the kernels' tile plan, on the CPU.

* ``attention_plain``, ``attention_bwd_plain`` and ``attention_bwd_saved_plain``
  at T_q = 24 queries over T_k = 40 keys (the decoder's cross-attention),
  without and with the key mask (N, T_k) and a dropout keep-mask
  (N, nhead, T_q, T_k), against the JAX package's ``MultiheadAttention`` core
  (identity projections; the keep-mask applied by intercepting its
  ``attn_drop``) and ``jax.vjp`` of it for dq, dk, dv. Tolerance 1e-5
  absolute: f32 softmax over 40 keys, as ``test_torch_attention.py``.
* ``ops/attention.py::attention_plan`` across token counts up to 65,536 at every
  head width, with and without a keep-mask: the tiles are multiples of one
  step of the four lanes (64 rows), the ring fits a block's shared memory and
  its budget, its bytes stop growing with T, the tiles cover every key (and
  query) exactly once, and a model of the kernels' loops meets each lane's
  keys in the same order at the plan's tile as at one tile holding them all
  (why the tile changes no bit of the result).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.models import transformer as jtr
from disentangledcolorization_tpu_torch.ops import attention
from disentangledcolorization_tpu_torch.ops.kernels import SMEM_BLOCK

ATOL = 1e-5
N, TQ, TK, D, NHEAD, RATE = 2, 24, 40, 32, 4, 0.1


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(N, TQ, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(N, TK, D)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(size=(N, TK)) < 0.3
    mask[0] = True  # the first image's keys all masked: a uniform softmax
    keep = rng.uniform(size=(N, NHEAD, TQ, TK)) >= RATE
    return q, k, v, g, mask, keep


def _jax_core(mask, keep):
    """The flax core with identity projections as a function of (q, k, v);
    ``keep`` replaces ``attn_drop``'s draw."""
    eye = np.eye(D, dtype=np.float32)
    params = {"in_proj_weight": np.concatenate([eye, eye, eye]), "in_proj_bias": np.zeros(3 * D, np.float32),
              "out_proj": {"kernel": eye, "bias": np.zeros(D, np.float32)}}
    mha = jtr.MultiheadAttention(D, NHEAD, RATE)
    m = None if mask is None else jnp.asarray(mask)

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and not kwargs.get("deterministic", True):
            return jnp.where(jnp.asarray(keep), args[0] / (1.0 - RATE), 0.0)
        return next_fun(*args, **kwargs)

    def core(q, k, v):
        with fnn.intercept_methods(interceptor):
            return mha.apply({"params": params}, q, k, v, m, deterministic=keep is None)[0]

    return core


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dropped", [False, True])
def test_cross_attention_plain_matches_jax(masked, dropped):
    q, k, v, g, mask, keep = _inputs(1)
    mask, keep = (mask if masked else None), (keep if dropped else None)
    tm, tk_ = (None if x is None else torch.from_numpy(x) for x in (mask, keep))
    rate = RATE if dropped else 0.0
    core = _jax_core(mask, keep)
    ref, vjp = jax.vjp(core, *map(jnp.asarray, (q, k, v)))
    tq, tkk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, stats = attention.attention_plain(tq, tkk, tv, NHEAD, tm, tk_, rate, return_stats=True)
    assert out.shape == (N, TQ, D) and stats.shape == (N, NHEAD, TQ, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    ref_grads = vjp(jnp.asarray(g))
    plain = attention.attention_bwd_plain(tq, tkk, tv, tg, NHEAD, tm, tk_, rate)
    saved = attention.attention_bwd_saved_plain(tq, tkk, tv, tg, NHEAD, tm, tk_, rate, out, stats)
    for ours in (plain, saved):
        assert [x.shape for x in ours] == [(N, TQ, D), (N, TK, D), (N, TK, D)]
        for a, b in zip(ours, ref_grads):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)


def test_cross_attention_function_gradients_match_jax():
    """``attention`` (the autograd function, the plain versions on the CPU)
    with a key mask and a keep-mask: its gradients against ``jax.vjp``."""
    q, k, v, g, mask, keep = _inputs(2)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attention.attention(*ts, NHEAD, torch.from_numpy(mask), torch.from_numpy(keep), RATE)
    (out * torch.from_numpy(g)).sum().backward()
    _, vjp = jax.vjp(_jax_core(mask, keep), *map(jnp.asarray, (q, k, v)))
    for a, b in zip(ts, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=ATOL, rtol=0)


def test_wrappers_check_cross_attention_shapes():
    q, k, v, _, mask, keep = _inputs(3)
    tq, tk_, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="key_padding_mask must be"):
        attention._masks(tq, tk_, NHEAD, torch.zeros(N, TQ, dtype=torch.bool), None, 0.0)
    with pytest.raises(ValueError, match="keep must be"):
        attention._masks(tq, tk_, NHEAD, None, torch.ones(N, NHEAD, TK, TQ, dtype=torch.bool), RATE)
    m, kp = attention._masks(tq, tk_, NHEAD, torch.from_numpy(mask), torch.from_numpy(keep), RATE)
    assert m.shape == (N, TK) and kp.shape == (N, NHEAD, TQ, TK) and m.dtype == kp.dtype == torch.uint8


TOKENS = [1, 9, 63, 64, 65, 256, 257, 300, 1000, 3361, 4096, 16384, 65536]


def _lane_keys(t_k: int, tile: int, lane: int) -> list:
    """The keys lane ``lane`` of a row meets, in order, in kernel D's and the
    dq phase's loops (``for tile: for jl = lane * 16; jl < L && jt + jl < Tk;
    jl += 64``), each as its 16-key group's first key."""
    keys = []
    for jt in range(0, t_k, tile):
        jl = lane * 16
        while jl < tile and jt + jl < t_k:
            keys.append(jt + jl)
            jl += 64
    return keys


def _lane_queries(t_q: int, tile: int, lane: int) -> list:
    """The queries lane ``lane`` meets in the dk/dv phase's loops."""
    t4 = -(-t_q // 4) * 4
    return [i0 + i for i0 in range(0, t_q, tile) for i in range(lane, min(tile, t4 - i0), 4)]


@pytest.mark.parametrize("hd", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("keep", [False, True])
def test_plan_fits_and_covers_every_key_once(hd, keep):
    budget = 48 * 1024 if hd <= 8 else 200 * 1024
    grown = set()
    for t in TOKENS:
        plan = attention.attention_plan(t, t, hd, keep)
        assert plan.stages == attention.STAGES >= 2
        for tile, nbytes in ((plan.key_tile, plan.kv_bytes), (plan.query_tile, plan.dkv_bytes)):
            assert tile % 64 == 0 and 64 <= tile <= max(64, -(-t // 64) * 64)
            assert nbytes <= min(budget, SMEM_BLOCK)
            starts = list(range(0, t, tile))  # the ring's tiles over t rows
            valid = [min(tile, t - s) for s in starts]
            assert sum(valid) == t and all(0 < x <= tile for x in valid)
            covered = np.zeros(t, np.int64)
            for s, n in zip(starts, valid):
                covered[s:s + n] += 1
            assert (covered == 1).all()
        assert plan.kv_bytes == attention.STAGES * attention._kv_stage_bytes(plan.key_tile, hd)
        assert plan.dkv_bytes == attention.STAGES * attention._dkv_stage_bytes(plan.query_tile, hd, keep)
        if t >= 256:
            grown.add((plan.kv_bytes, plan.dkv_bytes))
    assert len(grown) == 1  # the ring's bytes do not grow with T


@pytest.mark.parametrize("hd", [4, 8, 64])
@pytest.mark.parametrize("t", [9, 300, 1000, 4096])
def test_tile_keeps_each_lanes_order(hd, t):
    """A lane meets its keys (and queries) in the same order at the plan's
    tile as at one tile holding them all, and the four lanes meet every 16-key
    group (every query) exactly once."""
    plan = attention.attention_plan(t, t, hd, True)
    whole = -(-t // 64) * 64
    for lane in range(4):
        assert _lane_keys(t, plan.key_tile, lane) == _lane_keys(t, whole, lane)
        assert _lane_queries(t, plan.query_tile, lane) == _lane_queries(t, whole, lane)
    groups = sorted(j for lane in range(4) for j in _lane_keys(t, plan.key_tile, lane))
    assert groups == list(range(0, t, 16))
    queries = sorted(i for lane in range(4) for i in _lane_queries(t, plan.query_tile, lane))
    assert queries == list(range(-(-t // 4) * 4))


def test_plan_refuses_what_the_kernels_cannot_index():
    assert attention.attention_plan(attention.MAX_TOKENS, 7, 8, True).key_tile == 64
    for args in ((0, 8, 8, False), (8, attention.MAX_TOKENS + 1, 8, False), (8, 8, 6, False)):
        with pytest.raises(ValueError):
            attention.attention_plan(*args)
