"""Spatially sharded serving (``parallel/spatial.py``, ``cli/infer.py --no_resize --shard_spatial``) on the CPU.

* The plan: slabs cover the image's rows once, start on multiples of
  lcm(16, sp_size), every window is clipped to the image and holds its halos,
  an image of fewer units than devices takes fewer devices, and at 640 rows
  over two devices no window is the whole image.
* The halos: the receptive radius of the segnet, the repnet and HourGlass2,
  measured by the gradient of one output row w.r.t. the input rows at each of
  16 row phases, is below each net's halo by at least one cell row.
* The forward over ``[cpu, cpu]`` against the one-device forward of the same
  model on a 640x32 image (2+2 layers, 2 clusters, k-means anchors from one
  generator): tokens and predictions within 1e-4 absolute (the full-resolution
  nets run on windows, whose convolutions may round otherwise), the anchors
  equal, ``unpool`` within 1e-5 of kernel C over the whole affinity map; in
  f32, diverse (three samplings) and ``spix_pos`` (the pixels' positions of
  each window, normalized by the whole height).
* The positions: the sharded forward builds the pixels' sine code of each
  window's rows only (``spix_pos``) or the token grid's, never the whole
  image's.
* ``cli.infer --no_resize --shard_spatial`` over ``[cpu, cpu]`` with
  ``--save_guided --save_anchors`` on the folder of
  ``test_torch_infer_cli.py`` (anchors pinned in both packages): the PNGs
  within 1 level of the port's one-device run and of JAX's ``--shard_spatial``
  run (8 virtual CPU devices, GSPMD's halo exchanges), as
  ``tests/test_cli.py`` holds JAX's against its own one-device run.
"""

import os

import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.cli import infer as jinfer
from disentangledcolorization_tpu_torch.cli import infer
from disentangledcolorization_tpu_torch.models import AnchorColorProb, ColorProbNet, HourGlass2, SpixelSeg
from disentangledcolorization_tpu_torch.ops import superpixel as sp
from disentangledcolorization_tpu_torch.parallel import spatial
from test_torch_infer_cli import SIZES, _read, folder, pinned, weights  # noqa: F401 (fixtures)
from torch_fixtures import tmp_path  # noqa: F401 (removed after a passing test)

CPU2 = [torch.device("cpu")] * 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("h,n_dev,sp_size", [(640, 2, 16), (1024, 4, 16), (48, 2, 16), (32, 4, 16), (16, 8, 16),
                                              (4096, 2, 16), (96, 3, 8), (480, 2, 24)])
def test_plan_covers_rows_once_with_aligned_windows(h, n_dev, sp_size):
    import math

    unit = math.lcm(16, sp_size)
    plan = spatial.spatial_plan(h, n_dev, sp_size)
    assert len(plan) == min(n_dev, h // unit)
    assert plan[0].rows[0] == 0 and plan[-1].rows[1] == h
    assert all(a.rows[1] == b.rows[0] for a, b in zip(plan, plan[1:]))
    g = -(-spatial.HALO["enhance"] // unit) * unit
    for s in plan:
        s0, s1 = s.rows
        assert s0 % unit == 0 and s1 > s0
        assert s.pool == (max(s0 - sp_size, 0), min(s1 + sp_size, h))
        assert s.unpool == (max(s0 - g - unit, 0), min(s1 + g + unit, h))
        for (a, b), (c, d), halo in ((s.segnet, s.unpool, spatial.HALO["segnet"]),
                                     (s.repnet, s.pool, spatial.HALO["repnet"])):
            assert a % 16 == 0 and (b % 16 == 0 or b == h) and 0 <= a <= c and d <= b <= h
            assert a <= max(c - halo, 0) and b >= min(d + halo, h)
        assert s.unpool[0] % sp_size == 0 and s.unpool[1] % sp_size == 0
    if h >= 640:  # each device holds a slab plus halos, never the whole image
        assert all(spatial.window_rows(s)[1] - spatial.window_rows(s)[0] < h for s in plan)


def test_plan_refuses_rows_off_the_units():
    with pytest.raises(ValueError, match="multiple"):
        spatial.spatial_plan(40, 2, 16)


@pytest.mark.parametrize("net", ["segnet", "repnet", "enhance"])
def test_halos_cover_each_nets_receptive_field(net):
    torch.manual_seed(0)
    module, cin = {"segnet": (SpixelSeg(), 1), "repnet": (ColorProbNet(), 1), "enhance": (HourGlass2(), 65)}[net]
    x = torch.randn(1, 448, 16, cin, requires_grad=True)
    y = module.eval()(x)
    reach = 0
    for r in range(224, 240):
        g, = torch.autograd.grad(y[:, r].sum(), x, retain_graph=True)
        rows = (g.abs().sum(dim=(0, 2, 3)) > 0).nonzero().flatten()
        reach = max(reach, r - int(rows.min()), int(rows.max()) - r)
    assert 0 < reach <= spatial.HALO[net] - 16, (net, reach)


def _model(**options):
    torch.manual_seed(4)
    return AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=True, **options).eval()


@pytest.mark.parametrize("options,sampled_T", [({}, 0), ({}, 2), ({"spix_pos": True}, 0)],
                         ids=["f32", "diverse", "spix_pos"])
def test_sharded_forward_matches_one_device(options, sampled_T):
    model = _model(**options)
    rng = np.random.default_rng(1)
    grays = torch.from_numpy(rng.uniform(-1, 1, (1, 640, 32, 1)).astype(np.float32))
    with torch.no_grad():
        ref = model(grays, generator=torch.Generator().manual_seed(3), sampled_T=sampled_T)
    shards = spatial.SpatialShards(model, CPU2, lambda m, d: m.to(d).eval())
    assert len(shards) == 2 and shards.models[0] is not shards.models[1]
    out = shards(grays, generator=torch.Generator().manual_seed(3), sampled_T=sampled_T)
    assert out["affinity_map"] is None
    assert torch.equal(out["hint_mask"], ref["hint_mask"])
    for key in ("pal_logit", "ref_logit", "spix_colors", "spixel_sizes", "pred_colors"):
        assert out[key].shape == ref[key].shape, key
        torch.testing.assert_close(out[key], ref[key], atol=1e-4, rtol=0, msg=key)
    tok = ref["ref_logit"][..., :2].contiguous()
    torch.testing.assert_close(out["unpool"](tok), sp.upfeat(tok, ref["affinity_map"]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("options", [{}, {"spix_pos": True}], ids=["token_grid", "spix_pos"])
def test_sharded_forward_builds_no_whole_image_positions(options, monkeypatch):
    """The sharded path asks for the pixels' positions of each window only
    (``rows``) and, without ``spix_pos``, for the token grid's: never for the
    code of all H x W pixels."""
    model = _model(**options)
    calls, positions = [], AnchorColorProb._positions

    def recorded(self, n, h, w, hc, wc, device, dtype, rows=None):
        code = positions(self, n, h, w, hc, wc, device, dtype, rows=rows)
        calls.append((rows, tuple(code.shape)))
        return code

    monkeypatch.setattr(AnchorColorProb, "_positions", recorded)
    grays = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (1, 640, 32, 1)).astype(np.float32))
    spatial.SpatialShards(model, CPU2, lambda m, d: m.to(d).eval())(grays, generator=torch.Generator().manual_seed(3))
    if options:
        assert [r for r, _ in calls] == [s.pool for s in spatial.spatial_plan(640, 2)]
        assert all(shape[1] == r[1] - r[0] < 640 for r, shape in calls)
    else:
        assert calls == [(None, (1, 40, 2, 64))]


def _run(tmp, folder, pkl, extra, port=True, devices=None):
    argv = ["--data", folder, "--checkpt", pkl, "--n_clusters", "2", "--name", "t", "--no_resize",
            "--save_guided", "--save_anchors", "--save_dir", str(tmp), *extra]
    if port:
        args = infer.inference_argparser().parse_args(argv + ["--device", "cpu"])
        res = infer.infer(args, infer.folder_batches(args, infer.io_lib.get_filelist(folder)), devices=devices)
        assert res["images"] == len(SIZES)
    else:
        jinfer.main(argv)
    return str(tmp / "t-anchor2")


def test_infer_cli_shard_spatial_matches_one_device_and_jax(tmp_path, folder, weights, pinned, capsys):
    pkl = weights()
    sharded = _run(tmp_path / "sharded", folder, pkl, ["--shard_spatial"], devices=CPU2)
    assert "-spatially-sharded (H axis) inference over 2 devices" in capsys.readouterr().out
    one = _run(tmp_path / "one", folder, pkl, [])
    jax_sharded = _run(tmp_path / "jax", folder, pkl, ["--shard_spatial"], port=False)
    names = sorted(os.listdir(sharded))
    assert names == sorted(os.listdir(one)) == sorted(os.listdir(jax_sharded))
    assert len(names) == 3 * len(SIZES)  # the colors, the guided colors, the anchors
    for name in names:
        a = _read(os.path.join(sharded, name))
        for other in (one, jax_sharded):
            b = _read(os.path.join(other, name))
            assert a.shape == b.shape and int(np.abs(a - b).max()) <= 1, (name, other)
