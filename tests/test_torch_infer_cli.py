"""The port's inference command lines and checkpoint loader against the JAX package, on the CPU.

* ``cli/infer.py``: the port's ``main`` and the JAX ``main`` on one folder of
  three small PNGs (ragged sizes that pad to one 48x48 bucket), ``--device
  cpu``, 2 clusters, both on one ``.pkl`` of bridged 6+6-layer weights (so the
  loader's ``.pkl`` path is under test): ``--no_resize`` with
  ``--save_guided --save_anchors``, ``--diverse``, resize mode (``fetch_image_lab``
  patched to 64x64 in both, three images at batch 2, so the last batch is
  padded), ``--hint2regress --save_guided`` and ``--random_hint --d_model 32``
  (head width 4). The same file names in both; every PNG decoded as 8-bit
  RGB within 2 levels of JAX's, as ``test_torch_disco.py`` holds the forward
  (the Lab -> RGB chains differ: OpenCV in JAX, ``utils/color.py`` here). The
  anchors come from k-means or random draws, whose bits torch's generator
  cannot reproduce, so both packages' anchor functions are pinned to one
  mask, as ``test_torch_options_api.py`` pins them.
* ``cli/infer_spixel.py`` against the JAX command line on a ``.pkl`` of
  bridged SpixelSeg weights, within the same 2 levels.
* ``load_variables``/``Colorizer(checkpoint=...)``: a ``.pkl``, a
  reference ``.pth.tar`` and a run directory of the port's trainers give the
  weights JAX's loader gives (1e-6), and a ``.pkl`` Colorizer answers within
  2 levels of JAX's; a missing path and a JAX trainer's Orbax directory raise.
* ``--quantize int8|int8_safe`` and ``--no_resize --shard_spatial`` over more
  than one device compute (no environment variable set; the answers are held
  in ``test_torch_quant_api.py`` and ``test_torch_spatial.py``).
* Attention's plain version at head width 4 (``--d_model 32``) against the
  JAX core, 1e-5 as ``test_torch_attention.py``.
"""

import functools
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disentangledcolorization_tpu.api import Colorizer as JColorizer
from disentangledcolorization_tpu.cli import infer as jinfer
from disentangledcolorization_tpu.cli import infer_spixel as jinfer_spixel
from disentangledcolorization_tpu.models import anchor as janchor
from disentangledcolorization_tpu.models import transformer as jtr
from disentangledcolorization_tpu.ops import pallas_attention as pat
from disentangledcolorization_tpu.tools import convert_torch as cvt
from disentangledcolorization_tpu.train.checkpoint import fold_spectral_variables
from disentangledcolorization_tpu.utils import io as jio
from disentangledcolorization_tpu_torch.api import Colorizer
from disentangledcolorization_tpu_torch.cli import infer, infer_spixel
from disentangledcolorization_tpu_torch.models import AnchorColorProb, SpixelSeg
from disentangledcolorization_tpu_torch.models import anchor as tanchor
from disentangledcolorization_tpu_torch.ops import attention
from disentangledcolorization_tpu_torch.tools.convert import from_jax_variables
from disentangledcolorization_tpu_torch.utils import io as tio
from test_torch_bridge import random_state_dict, to_jax_variables
from torch_fixtures import tmp_path  # noqa: F401 (removed after a passing test)

UINT8_TOL = 2
SIZES = [(45, 37), (48, 40), (40, 33)]  # all pad to 48x48 at bucket 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one intra-op thread: the suite's parallel workers, each with
    a thread per core, would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(SIZES):
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 2)
        cv2.imwrite(str(d / f"im{i}.png"), img)
    yield str(d)
    shutil.rmtree(d, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def _unfolded(**options):
    torch.manual_seed(2)
    return random_state_dict(AnchorColorProb(n_clusters=2, **options), seed=2)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A ``.pkl`` of bridged folded 6+6-layer weights for each option set."""
    tmp = tmp_path_factory.mktemp("ckpt")
    made = {}

    def pkl(**options):
        key = tuple(sorted(options.items()))
        if key not in made:
            made[key] = str(tmp / f"w{len(made)}.pkl")
            with open(made[key], "wb") as f:
                pickle.dump(to_jax_variables(_unfolded(**options), sn_folded=True), f)
        return made[key]

    yield pkl
    shutil.rmtree(tmp, ignore_errors=True)


def _mask(n, h, w):
    """Two anchors an image, at places that depend on the image's index."""
    m = np.zeros((n, h * w), np.float32)
    for i in range(n):
        m[i, [(i + 1) % (h * w), (5 * i + 7) % (h * w)]] = 1.0
    return m.reshape(n, h, w, 1)


@pytest.fixture
def pinned(monkeypatch):
    """Both packages' k-means and random anchors -> :func:`_mask`."""
    monkeypatch.setattr(janchor, "clustering_hint_mask", lambda key, feats, k, sizes, *a, **kw: (
        jnp.asarray(_mask(*feats.shape[:3])), jnp.zeros(feats.shape[:3] + (k,), jnp.float32)))
    monkeypatch.setattr(janchor, "random_hint_mask", lambda key, n, h, w, k: (
        jnp.asarray(_mask(n, h, w)), jnp.zeros((n, h, w, k), jnp.float32)))
    monkeypatch.setattr(tanchor, "clustering_hint_mask", lambda feats, k, sizes, generator=None: (
        torch.from_numpy(_mask(*feats.shape[:3])).to(feats.device), None))
    monkeypatch.setattr(tanchor, "random_hint_mask", lambda n, h, w, k, generator=None, device=None: (
        torch.from_numpy(_mask(n, h, w)), None))


def _read(path):
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    assert img is not None, path
    return img.astype(int)


def _run_both(tmp_path, folder, pkl, flags):
    argv = ["--data", folder, "--checkpt", pkl, "--n_clusters", "2", "--batch_size", "2", "--name", "t", *flags]
    jinfer.main(argv + ["--save_dir", str(tmp_path / "jax")])
    res = infer.main(argv + ["--save_dir", str(tmp_path / "port"), "--device", "cpu"])
    jd, td = str(tmp_path / "jax" / "t-anchor2"), str(tmp_path / "port" / "t-anchor2")
    assert res["save_dir"] == td and res["loaded"] and res["images"] == len(SIZES)
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    gaps = {}
    for name in os.listdir(jd):
        a, b = _read(os.path.join(td, name)), _read(os.path.join(jd, name))
        assert a.shape == b.shape, name
        gaps[name] = int(np.abs(a - b).max())
    return sorted(os.listdir(td)), gaps


def _names(suffixes):
    return sorted(f"im{i}{s}.png" for i in range(len(SIZES)) for s in suffixes)


CASES = {
    "no_resize+guided+anchors": ({}, ["--no_resize", "--save_guided", "--save_anchors"], ["", "-guided", "-anchors"]),
    "diverse": ({}, ["--no_resize", "--diverse"], ["-c0", "-c1", "-c2"]),
    "resize": ({}, [], [""]),
    "hint2regress+guided": ({"hint2regress": True}, ["--no_resize", "--hint2regress", "--save_guided"],
                            ["", "-guided"]),
    "random_hint+d_model32": ({"d_model": 32}, ["--no_resize", "--random_hint", "--d_model", "32"], [""]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_infer_cli_matches_jax(case, tmp_path, folder, weights, pinned, monkeypatch):
    options, flags, suffixes = CASES[case]
    if case == "resize":  # 256x256 would compile JAX's graph at full size: both resize to 64
        for mod in (jio, tio):
            orig = mod.fetch_image_lab
            monkeypatch.setattr(mod, "fetch_image_lab", lambda p, no_resize=True, scale=16, resize_to=256, orig=orig:
                                orig(p, no_resize, scale, 64))
    names, gaps = _run_both(tmp_path, folder, weights(**options), flags)
    assert names == _names(suffixes)
    assert max(gaps.values()) <= UINT8_TOL, gaps
    want = (64, 64) if case == "resize" else None
    for i, (h, w) in enumerate(SIZES):  # --no_resize crops the bucket padding away
        assert _read(os.path.join(tmp_path / "port" / "t-anchor2", f"im{i}{suffixes[0]}.png")).shape[:2] == (want or (h, w))


def test_infer_cli_takes_array_batches(tmp_path, weights, pinned):
    """The loop the card is fed from memory: names of None are padding and
    write nothing, sizes of None leave the image uncropped."""
    args = infer.inference_argparser().parse_args(
        ["--checkpt", weights(), "--n_clusters", "2", "--device", "cpu", "--save_dir", str(tmp_path), "--name", "a",
         "--no_resize", "--prefetch", "0"])
    rng = np.random.default_rng(1)
    grays = rng.uniform(-1, 1, (2, 32, 48, 1)).astype(np.float32)
    colors = rng.uniform(-0.3, 0.3, (2, 32, 48, 2)).astype(np.float32)
    res = infer.infer(args, [(grays, colors, ["x.png", None], [(30, 41), None]), (grays[:1], colors[:1], ["y.png"], [None])])
    assert res["images"] == 2
    assert sorted(os.listdir(tmp_path / "a-anchor2")) == ["x.png", "y.png"]
    assert tio.read_png(open(tmp_path / "a-anchor2" / "x.png", "rb").read()).shape == (30, 41, 3)
    assert tio.read_png(open(tmp_path / "a-anchor2" / "y.png", "rb").read()).shape == (32, 48, 3)


def test_infer_spixel_cli_matches_jax(tmp_path, folder, monkeypatch):
    torch.manual_seed(3)
    sd = random_state_dict(SpixelSeg(), seed=3)
    pkl = tmp_path / "spixel.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(cvt.convert_spixelseg_state_dict(sd), f)
    argv = ["--data", folder, "--checkpt", str(pkl), "--input_size", "32", "--name", "sp"]
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jinfer_spixel.main(argv)
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    res = infer_spixel.main(argv + ["--device", "cpu"])
    assert res["images"] == len(SIZES)
    jd, td = tmp_path / "jax" / "sp-s16", tmp_path / "port" / "sp-s16"
    names = sorted(os.listdir(td))
    assert names == sorted(os.listdir(jd)) == _names(["-recon", "-spix"])
    for name in names:
        a, b = _read(str(td / name)), _read(str(jd / name))
        assert a.shape == b.shape == (32, 32, 3) and int(np.abs(a - b).max()) <= UINT8_TOL, name


def _sd_close(ours: dict, ref: dict, atol=1e-6):
    """Every weight and buffer within ``atol``; a folded model's spectral
    vectors u, v are not read by its forward and are skipped."""
    assert sorted(ours) == sorted(ref)
    for k, v in ours.items():
        if not k.endswith(("weight_u", "weight_v")):
            torch.testing.assert_close(v, ref[k].to(v.dtype), atol=atol, rtol=1e-5, msg=k)


def test_colorizer_loads_what_jax_loads(tmp_path, weights, pinned):
    """A ``.pkl``, a reference ``.pth.tar`` and a port run directory give the
    weights the JAX loader gives; the ``.pkl`` Colorizer answers as JAX's."""
    pkl = weights()
    col = Colorizer(checkpoint=pkl, n_clusters=2, device="cpu", compute_dtype="float32")
    jcol = JColorizer(checkpoint=pkl, n_clusters=2, compute_dtype="float32")
    assert col.loaded and jcol.loaded
    _sd_close(col.model.state_dict(), from_jax_variables(jcol.variables, sn_folded=True))
    img = np.random.default_rng(4).integers(0, 256, (48, 40, 3), dtype=np.uint8)
    gap = np.abs(col.colorize(img).astype(int) - jcol.colorize(img, key=jax.random.key(1)).astype(int)).max()
    assert gap <= UINT8_TOL

    unfolded = _unfolded()
    ref = tmp_path / "ref.pth.tar"
    torch.save({"state_dict": {"module." + k: torch.tensor(v) for k, v in unfolded.items()}}, ref)
    jref = JColorizer(checkpoint=str(ref), n_clusters=2, compute_dtype="float32")
    _sd_close(Colorizer(checkpoint=str(ref), n_clusters=2, device="cpu").model.state_dict(),
              from_jax_variables(jref.variables, sn_folded=True))

    # a run of the port's trainers, folded as the trainer's model computes
    # sigma: the JAX trainer's fold (fold_spectral_variables) of the same weights
    run = tmp_path / "run" / "checkpts"
    run.mkdir(parents=True)
    torch.save({"epoch": 1, "state_dict": {k: torch.tensor(v) for k, v in unfolded.items()}},
               run / "model_best.pth.tar")
    jfold = fold_spectral_variables(to_jax_variables(unfolded, sn_folded=False))
    _sd_close(Colorizer(checkpoint=str(tmp_path / "run"), n_clusters=2, device="cpu").model.state_dict(),
              from_jax_variables(jfold, sn_folded=True), atol=1e-5)


def test_loader_refuses_a_missing_path_and_an_orbax_run(tmp_path):
    """Where the JAX loader warns and serves random weights, the port raises."""
    with pytest.raises(FileNotFoundError, match="does not exist"):
        Colorizer(checkpoint=str(tmp_path / "missing.pkl"), n_clusters=2, device="cpu")
    (tmp_path / "jaxrun" / "checkpts" / "model_last").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        Colorizer(checkpoint=str(tmp_path / "jaxrun"), n_clusters=2, device="cpu")
    with pytest.raises(ValueError, match="expected a .pkl"):
        open(tmp_path / "w.npz", "wb").close()
        infer.read_checkpoint(str(tmp_path / "w.npz"))
    model, loaded = infer.load_variables("", lambda: AnchorColorProb(n_clusters=2, sn_folded=True), seed=5)
    again, _ = infer.load_variables("", lambda: AnchorColorProb(n_clusters=2, sn_folded=True), seed=5)
    assert not loaded and all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), again.state_dict().values()))


@pytest.mark.parametrize("flags, item", [(["--quantize", "int8"], "item 5"), (["--quantize", "int8_safe"], "item 5"),
                                         (["--no_resize", "--shard_spatial"], "item 9")])
def test_unported_flags_raise(flags, item, tmp_path, monkeypatch):
    """The flags that raised until their ROADMAP.md item was ported now
    compute over two devices (by ``parallel/mesh.py::local_devices``):
    ``--quantize`` (item 5) calibrated on the first batch, ``--no_resize
    --shard_spatial`` (item 9) with each image's H axis split over them
    (``parallel/spatial.py``); no environment variable is set."""
    for var in ("DISCO_INT8", "DISCO_INT8_EXCLUDE"):
        monkeypatch.delenv(var, raising=False)
    from disentangledcolorization_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "local_devices", lambda device: [torch.device("cpu")] * 2)
    argv = ["--data", str(tmp_path), "--device", "cpu", "--save_dir", str(tmp_path), *flags]
    batch = (np.zeros((2, 32, 32, 1), np.float32), np.zeros((2, 32, 32, 2), np.float32), ["a.png", "b.png"],
             [None, None])
    args = infer.inference_argparser().parse_args(argv + ["--n_clusters", "2", "--batch_size", "2"])
    assert infer.spatially_sharded(args, mesh.local_devices(None)) == (item == "item 9")
    assert infer.infer(args, [batch])["images"] == 2
    assert sorted(os.listdir(tmp_path / "test-anchor2")) == ["a.png", "b.png"]
    assert "DISCO_INT8" not in os.environ and "DISCO_INT8_EXCLUDE" not in os.environ


def test_more_than_one_card_raises(tmp_path, monkeypatch, capsys):
    """Two visible cards: data parallel, except ``--no_resize --shard_spatial``,
    which shards each image's H axis over the cards (no longer a refusal):
    the rule picks the sharded path, which then computes over two devices
    (here ``[cpu, cpu]``, the card's run being ``chip_smoke.py``'s)."""
    from disentangledcolorization_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    args = infer.inference_argparser().parse_args(["--data", str(tmp_path), "--save_dir", str(tmp_path),
                                                   "--no_resize", "--shard_spatial", "--n_clusters", "2"])
    cards = mesh.local_devices(torch.device("cuda"))
    assert len(cards) == 2 and infer.spatially_sharded(args, cards) and not infer.data_parallel(args, cards)
    rng = np.random.default_rng(2)
    batch = (rng.uniform(-1, 1, (1, 64, 48, 1)).astype(np.float32), np.zeros((1, 64, 48, 2), np.float32),
             ["c.png"], [(60, 45)])
    assert infer.infer(args, [batch], devices=[torch.device("cpu")] * 2)["images"] == 1
    assert "-spatially-sharded (H axis) inference over 2 devices" in capsys.readouterr().out
    assert tio.read_png(open(tmp_path / "test-anchor2" / "c.png", "rb").read()).shape == (60, 45, 3)


def test_argparser_has_every_jax_flag():
    from disentangledcolorization_tpu.utils.config import inference_argparser as jparser
    from disentangledcolorization_tpu_torch.utils.config import inference_argparser

    def flags(p):
        return {a.dest: (a.default, tuple(a.choices or ())) for a in p._actions if a.dest != "help"}

    ours, ref = flags(inference_argparser()), flags(jparser())
    assert ours.pop("device") == ("cuda", ())
    assert ours == ref


@pytest.mark.parametrize("masked", [False, True])
def test_attention_plain_at_head_width_4_matches_jax(masked):
    """d_model 32 over 8 heads: the plain core against JAX's Pallas core
    (interpret mode) and, with a key mask whose first image has every key
    masked, against JAX's ``MultiheadAttention`` on identity projections."""
    n, t, d, nhead = 2, 16, 32, 8
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(n, t, d)).astype(np.float32) for _ in range(3))
    if not masked:
        ours = attention.attention_plain(*map(torch.from_numpy, (q, k, v)), nhead)
        ref = pat.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), nhead)
    else:
        mask = rng.uniform(size=(n, t)) < 0.3
        mask[0] = True
        ours = attention.attention_plain(*map(torch.from_numpy, (q, k, v)), nhead, torch.from_numpy(mask))
        eye = np.eye(d, dtype=np.float32)
        params = {"in_proj_weight": np.concatenate([eye, eye, eye]), "in_proj_bias": np.zeros(3 * d, np.float32),
                  "out_proj": {"kernel": eye, "bias": np.zeros(d, np.float32)}}
        ref, _ = jtr.MultiheadAttention(d, nhead).apply({"params": params}, *map(jnp.asarray, (q, k, v)),
                                                        jnp.asarray(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("options", [{}, {"hint2regress": True, "d_model": 32}, {"learning_pos": True},
                                     {"enhanced": False}])
@pytest.mark.parametrize("folded", [True, False])
def test_to_jax_variables_lays_weights_out_as_the_converter(options, folded):
    """The port's ``to_jax_variables`` (the ``.pkl`` writer of ``chip_smoke.py``)
    gives the JAX converter's tree leaf for leaf, and back again. Folded, the
    converter divides a reference checkpoint's kernels by sigma; the port
    writes a folded model's kernels as they are, so it is fed the folded
    weights that the converter's tree loads into."""
    from disentangledcolorization_tpu_torch.tools.convert import to_jax_variables as port_to_jax

    torch.manual_seed(4)
    sd = random_state_dict(AnchorColorProb(n_clusters=2, n_enc_layers=2, sn_folded=folded, **options), seed=4)
    ref = to_jax_variables(sd, folded)
    if folded:
        sd = {k: v.numpy() for k, v in from_jax_variables(ref, sn_folded=True).items()}
    ours = port_to_jax(sd, folded)
    flat = lambda tree: {"/".join(map(str, p)): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}  # noqa: E731
    a, b = flat(ours), flat({k: v for k, v in ref.items() if v})
    assert sorted(a) == sorted(b)
    assert all(a[k].dtype == np.float32 and np.array_equal(a[k], b[k]) for k in a)
    back = from_jax_variables(ours, sn_folded=folded)
    assert all(np.array_equal(back[k].numpy(), sd[k]) for k in sd if not k.endswith(("weight_u", "weight_v"))
               and not k.endswith("num_batches_tracked"))
