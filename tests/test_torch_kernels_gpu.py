"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device these skip (a kernel has no CPU mode;
the CPU suite holds the plain versions against the JAX package). On a card:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Shapes here are small and ragged (odd widths, sp=8, rectangular grids,
head widths 8..64); ``chip_smoke.py`` covers the main path's shapes.
Tolerance 1e-5 absolute, as there.
"""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from disentangledcolorization_tpu_torch.ops import kernels

    kernels.build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(dev, *shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).to(dev)


@pytest.mark.parametrize("n,h,w,c,s", [(2, 64, 64, 66, 16), (1, 32, 48, 5, 8), (1, 48, 32, 130, 16)])
def test_pool_stats_kernel(cuda, n, h, w, c, s):
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    feat = _rand(cuda, n, h, w, c)
    logits = _rand(cuda, n, h, w, 9, seed=1)
    logits[..., 5] = logits[..., 2]
    prob = torch.softmax(logits, -1).contiguous()
    out = sp.pool_stats(feat, prob, s, s)
    ref = sp.pool_stats_plain(feat, prob, s, s)
    for a, b in zip(out[:2], ref[:2]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert torch.equal(out[2], ref[2])
    t, mass, hard = sp.pool_stats(feat, prob, s, s, with_hard=False)
    assert hard is None and torch.equal(t, out[0])


@pytest.mark.parametrize("n,h,w,c", [(2, 17, 33, 16), (1, 64, 64, 16), (1, 8, 8, 3)])
def test_affinity_head_kernel(cuda, n, h, w, c):
    from disentangledcolorization_tpu_torch.ops import affinity

    x = _rand(cuda, n, h, w, c)
    k, b = _rand(cuda, 3, 3, c, 9, seed=1) * 0.3, _rand(cuda, 9, seed=2)
    torch.testing.assert_close(affinity.affinity_head(x, k, b), affinity.affinity_head_plain(x, k, b), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,hc,wc,c,s", [(2, 4, 4, 64, 16), (1, 3, 5, 7, 8)])
def test_upfeat_kernel(cuda, n, hc, wc, c, s):
    from disentangledcolorization_tpu_torch.ops import superpixel as sp

    tok = _rand(cuda, n, hc, wc, c)
    prob = torch.softmax(_rand(cuda, n, hc * s, wc * s, 9, seed=1), -1).contiguous()
    torch.testing.assert_close(sp.upfeat(tok, prob, s, s), sp.upfeat_plain(tok, prob, s, s), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,t,d,nhead", [(2, 256, 64, 8), (1, 50, 64, 4), (3, 17, 128, 2), (1, 9, 32, 1)])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_kernel(cuda, n, t, d, nhead, masked):
    from disentangledcolorization_tpu_torch.ops import attention

    q, k, v = (_rand(cuda, n, t, d, seed=i) for i in range(3))
    mask = (_rand(cuda, n, t, seed=4) > 0.5) if masked else None
    torch.testing.assert_close(
        attention.attention(q, k, v, nhead, mask), attention.attention_plain(q, k, v, nhead, mask), atol=1e-5, rtol=0
    )


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from disentangledcolorization_tpu_torch.ops import attention, superpixel

    x = _rand(cuda, 1, 32, 32, 4)
    prob = torch.softmax(_rand(cuda, 1, 32, 32, 9), -1)
    with pytest.raises(ValueError, match="contiguous"):
        superpixel.pool_stats(x.transpose(1, 2), prob, 16, 16)
    with pytest.raises(TypeError):
        superpixel.upfeat(_rand(cuda, 1, 2, 2, 4).double(), prob, 16, 16)
    with pytest.raises(ValueError, match="head width"):
        attention.attention(*(_rand(cuda, 1, 8, 24) for _ in range(3)), 2)
