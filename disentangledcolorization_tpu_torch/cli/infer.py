"""Colorizer inference command line: a folder of images -> colorized PNGs.

Counterpart of ``disentangledcolorization_tpu/cli/infer.py``: the same flags
(``utils/config.py::inference_argparser``, plus ``--device``), the same
padding and resize semantics, output names and directory
(``<save_dir>/<name>-anchor<k>``). ``use_dense_pos`` and ``enhanced`` are
forced, as in the reference (inference.py:74, :165-166); ``--n_enc`` and
``--n_dec`` are parsed and, as in the JAX command line, not passed to the
model (6 + 6 layers).

    python -m disentangledcolorization_tpu_torch.cli.infer --data ./imgs --checkpt disco-beta.pkl

Resize mode runs ``--batch_size`` images a forward, the last batch padded by
repeating its last image; ``--no_resize`` runs one image at a time, edge-padded
to multiples of ``max(--bucket, --psize)``. ``--diverse`` writes ``c0``..``c2``
(``sampled_T=2``); ``--save_guided`` the guided colors (the hintpath's ab,
unpooled by kernel C at C=2); ``--save_anchors`` the anchor markers (the hint
mask unpooled by kernel C at C=1, then ``ops/hints.py::mark_color_hints``).

The loop over batches is :func:`infer`, which takes any iterable of numpy
batches; :func:`main` feeds it from the folder through ``fetch_image_lab``
(OpenCV). PNGs are written by ``utils/io.py::write_png``, which needs no image
library. Lab -> RGB runs through the port's ``utils/color.py`` where the JAX
package uses OpenCV.

Data parallel, as JAX's (``cli/infer.py:119-139``): with more than one card
in ``parallel/mesh.py::local_devices``, no ``--no_resize`` and a
``--batch_size`` that splits over them, each batch is split by rows over one
replica a card (``parallel/replicas.py``), with the draws of one card.
Spatially sharded, as JAX's (``cli/infer.py:129-139``): with more than one
card, ``--no_resize`` and ``--shard_spatial``, each image's H axis is split
over the cards (``parallel/spatial.py``: each card runs the full-resolution
nets on its slab and halos, the token stage runs on the first). Otherwise one
card runs. :func:`infer` also takes the device list itself (``devices``), so
one card can run the sharded path over ``[cuda:0, cuda:0]``.

``--quantize int8|int8_safe``, as JAX's (``cli/infer.py:77-81``,
``:170-180``): the first batch runs one calibration forward (its
``sampled_T``, its colors and the same anchor draws as its forward), then
every forward is static int8 (``ops/quant.py``; kernels I and H on the card).
``int8_safe`` keeps the repnet in the compute dtype. The setting is the
model's own; no environment variable is read or set.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..models import AnchorColorProb
from ..models.layers import hold_compute_copies
from ..ops import colorlabel as cl
from ..ops import hints as hints_ops
from ..ops import quant
from ..ops import superpixel as sp
from ..parallel import mesh
from ..parallel.replicas import Replicas
from ..parallel.spatial import SpatialShards
from ..tools.convert import fold_spectral_norm, from_jax_variables, load_numpy_pickle
from ..train.checkpoint import load_train_variables
from ..utils import io as io_lib
from ..utils.config import inference_argparser
from ..utils.logging import profiler_trace


def _orbax_snapshot(path: str) -> bool:
    """A JAX trainer's run: ``model_best``/``model_last`` Orbax snapshot
    directories under the path or its ``checkpts``, or a snapshot itself."""
    dirs = [path, os.path.join(path, "checkpts")]
    return os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA")) or any(
        os.path.isdir(os.path.join(d, f"model_{tag}")) for d in dirs for tag in ("best", "last"))


def read_checkpoint(checkpt: str) -> dict:
    """A serving model's ``state_dict`` (spectral norm folded) from:

    * ``.pkl``/``.pickle``: flax variables as numpy (the JAX package's
      ``tools/convert_torch.py`` output), folded;
    * ``.pth``/``.tar``/``.pth.tar``: a reference torch checkpoint (its
      ``weight_orig`` divided by u . (W v)), or a file of the port's trainers;
    * a directory: a run of the port's trainers (its ``checkpts`` holding
      ``model_best``/``model_last.pth.tar``), folded as the trainer's model
      computes sigma.

    A JAX trainer's Orbax run directory raises ``ValueError``: Orbax is not
    installed beside the port. A path that does not exist raises
    ``FileNotFoundError``, where the JAX loader warns and serves random weights.
    """
    if not os.path.exists(checkpt):
        raise FileNotFoundError(f"checkpoint {checkpt!r} does not exist (the JAX package would warn and serve "
                                "random weights; the port refuses, so that no run silently serves noise)")
    if os.path.isdir(checkpt):
        if _orbax_snapshot(checkpt):
            raise ValueError(f"{checkpt} is an Orbax checkpoint of the JAX trainers, which the port cannot read: "
                             "convert it with the JAX package (train/checkpoint.py::load_train_variables, then "
                             "pickle the variables as numpy arrays into a .pkl)")
        return load_train_variables(checkpt)
    if checkpt.endswith((".pkl", ".pickle")):
        return from_jax_variables(load_numpy_pickle(checkpt), sn_folded=True)
    if checkpt.endswith((".pth", ".tar")):
        data = torch.load(checkpt, map_location="cpu", weights_only=True)
        sd = data.get("state_dict", data)
        return fold_spectral_norm({k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()})
    raise ValueError(f"checkpoint {checkpt!r}: expected a .pkl/.pickle, a .pth/.pth.tar or a run directory")


def load_variables(checkpt: str, build, seed: int = 0):
    """The model of ``build()`` (a model with ``sn_folded=True``), made under
    ``torch.manual_seed(seed)``, with the weights of ``checkpt``
    (:func:`read_checkpoint`) loaded strictly; an empty ``checkpt`` keeps the
    random weights of ``seed``. Returns (model on the CPU, loaded)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build()
    if not checkpt:
        return model, False
    model.load_state_dict(read_checkpoint(checkpt))
    return model, True


def to_serving(model, device):
    """The model on ``device`` in eval mode: channels_last activations on the
    card (the kernels then read the convs' outputs without a copy) and, for a
    bf16 model, the held bf16 copies of its weights."""
    model = model.to(device).eval()
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    if model.compute_dtype != torch.float32:
        hold_compute_copies(model, model.compute_dtype)
    return model


def build_model(args) -> AnchorColorProb:
    """What JAX's ``build_model`` passes (cli/infer.py:60-74): dense
    positions and enhanceNet forced, folded spectral norm."""
    return AnchorColorProb(
        sp_size=args.psize,
        d_model=args.d_model,
        use_dense_pos=True,  # forced, inference.py:165
        spix_pos=args.spix_pos,
        learning_pos=args.learning_pos,
        n_clusters=args.n_clusters,
        random_hint=args.random_hint,
        hint2regress=args.hint2regress,
        enhanced=True,  # forced, inference.py:74
        sn_folded=True,
        compute_dtype=torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32,
    )


def data_parallel(args, devices) -> bool:
    """JAX's rule: split batches over the cards when there is more than one,
    images are resized, and ``--batch_size`` splits over them."""
    return len(devices) > 1 and not args.no_resize and args.batch_size % len(devices) == 0


def spatially_sharded(args, devices) -> bool:
    """JAX's rule: shard each image's H axis over the cards when there is
    more than one, images keep their size, and ``--shard_spatial`` asks."""
    return len(devices) > 1 and args.no_resize and args.shard_spatial


def infer(args, batches, devices=None) -> dict:
    """Colorize ``batches`` (an iterable of numpy ``(grays (B,H,W,1), colors
    (B,H,W,2), names, sizes)``, normalized Lab; a name of None marks a padding
    image, a size of None an unpadded one) and write the PNGs under
    ``<save_dir>/<name>-anchor<n_clusters>``. ``devices``: the devices to
    serve over (default ``parallel/mesh.py::local_devices`` of ``--device``).
    Returns the count of images written and the seconds the loop took."""
    if devices is None:
        devices = mesh.local_devices(resolve_device(args.device))
    print(f"@Inference: [AnchorColorProb] (spixel-size={args.psize})")
    sampled_T = 2 if args.diverse else 0
    save_dir = os.path.join(args.save_dir, f"{args.name}-anchor{args.n_clusters}")
    os.makedirs(save_dir, exist_ok=True)
    print(f"-saving dir: {save_dir}")
    model, loaded = load_variables(args.checkpt, lambda: build_model(args), args.seed)
    if args.checkpt:
        print("-weight loaded successfully." if loaded else "-weight load FAILED.")
    device = devices[0]
    if data_parallel(args, devices):
        print(f"-data-parallel inference over {len(devices)} devices")
        model = Replicas(model, devices, to_serving)
    elif spatially_sharded(args, devices):
        print(f"-spatially-sharded (H axis) inference over {len(devices)} devices")
        model = SpatialShards(model, devices, to_serving)
    else:
        model = Replicas(model, [device], to_serving)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    # PNG writes go through a background thread unless --prefetch 0 (the
    # reference's serial behaviour); flush() at the end re-raises a write error
    writer = io_lib.AsyncWriter() if args.prefetch > 0 else None
    save = writer.submit if writer is not None else (lambda fn, *a, **k: fn(*a, **k))
    n_done = 0
    calibrated = args.quantize == "none"

    def crop(lab, h, w):
        return lab[:, :h, :w] if args.no_resize else lab

    def unpool(out, tokens, images=slice(None)):
        """Kernel C over the forward's affinity map (the spatial shards: over
        each slab's), tokens (N', hc, wc, C) -> pixels on the first device."""
        if "unpool" in out:
            return out["unpool"](tokens, images)
        return sp.upfeat(tokens.contiguous(), out["affinity_map"][images], args.psize, args.psize)

    @torch.no_grad()
    def process_batch(grays_np, colors_np, names, orig_sizes):
        nonlocal n_done, calibrated
        grays = torch.from_numpy(np.ascontiguousarray(grays_np, np.float32)).to(device)
        colors = torch.from_numpy(np.ascontiguousarray(colors_np, np.float32)).to(device)
        if not calibrated:  # int8: one calibration forward on the first batch, with its draws
            state = generator.get_state()
            quant.calibrate(model.models, lambda: model(grays, colors, generator=generator, sampled_T=sampled_T),
                            quant.EXCLUDE[args.quantize])
            generator.set_state(state)
            calibrated = True
        out = model(grays, colors, generator=generator, sampled_T=sampled_T)
        pred = out["pred_colors"].float()
        guided = None
        if args.save_guided and not args.diverse:
            # the guided (pre-enhancement) colors, inference.py:111-115
            tok = out["ref_logit"] if args.hint2regress else cl.decode_ind2ab(out["ref_logit"], T=0)
            guided = unpool(out, tok.float()).cpu().numpy()
        pred_ab = pred.cpu().numpy()
        if not np.isfinite(pred_ab).all():
            print("@Warning: non-finite prediction values — broken/unconverged weights? (outputs will be garbage)",
                  file=sys.stderr)
        nb = grays_np.shape[0]
        for i in range(nb):
            if names[i] is None:  # batch-padding tail
                continue
            h, w = orig_sizes[i] if orig_sizes[i] is not None else grays_np.shape[1:3]
            if args.diverse:
                for no in range(3):
                    lab = np.concatenate([grays_np[i], pred_ab[no * nb + i]], axis=-1)[None]
                    save(io_lib.save_normLabs_from_batch, crop(lab, h, w), save_dir, [names[i]], -1, suffix=f"c{no}")
            else:
                lab = np.concatenate([grays_np[i], pred_ab[i]], axis=-1)[None]
                save(io_lib.save_normLabs_from_batch, crop(lab, h, w), save_dir, [names[i]], -1)
                if guided is not None:
                    glab = np.concatenate([grays_np[i], guided[i]], axis=-1)[None]
                    save(io_lib.save_normLabs_from_batch, crop(glab, h, w), save_dir, [names[i]], -1,
                         suffix="guided")
                if args.save_anchors:
                    masks = unpool(out, out["hint_mask"][i:i + 1], slice(i, i + 1))
                    marked = hints_ops.mark_color_hints(grays[i:i + 1], pred[i:i + 1], masks,
                                                        base_abs=pred[i:i + 1]).cpu().numpy()
                    save(io_lib.save_normLabs_from_batch, crop(marked, h, w), save_dir, [names[i]], -1,
                         suffix="anchors")
            n_done += 1

    t_start = time.time()
    with profiler_trace(args.trace_dir or None):
        # a background thread decodes batch b+1 while the device computes batch
        # b and the writer saves batch b-1's PNGs; --prefetch 0 runs serially
        for item in io_lib.prefetch_iter(iter(batches), depth=args.prefetch):
            process_batch(*item)
        if writer is not None:
            writer.flush()
    seconds = time.time() - t_start
    print(f"-processed {n_done} imgs. consumed {seconds:.3f} sec")
    return {"images": n_done, "seconds": seconds, "save_dir": save_dir, "loaded": loaded}


def folder_batches(args, img_list):
    """The folder's images as :func:`infer` takes them, decoded by OpenCV:
    one edge-padded image a batch with ``--no_resize``, else batches of
    ``--batch_size`` resized to 256x256, the last padded with its last image."""
    if args.no_resize:
        bucket = max(args.bucket, args.psize)
        for pth in img_list:
            name = os.path.splitext(os.path.basename(pth))[0] + ".png"
            print(f"-processing {os.path.basename(pth)} ...")
            gray, ab, _, (h, w) = io_lib.fetch_image_lab(pth, no_resize=True, scale=bucket)
            yield gray[None], ab[None], [name], [(h, w)]
        return
    bs = max(args.batch_size, 1)
    for s in range(0, len(img_list), bs):
        grays, colors, names, sizes = [], [], [], []
        for pth in img_list[s:s + bs]:
            g, ab, _, hw = io_lib.fetch_image_lab(pth, no_resize=False)
            grays.append(g)
            colors.append(ab)
            names.append(os.path.splitext(os.path.basename(pth))[0] + ".png")
            sizes.append(hw)
        pad = bs - len(grays)
        yield (np.stack(grays + [grays[-1]] * pad), np.stack(colors + [colors[-1]] * pad),
               names + [None] * pad, sizes + [None] * pad)


def main(argv=None) -> dict:
    args = inference_argparser().parse_args(argv)
    img_list = io_lib.get_filelist(args.data)
    print(f"-data dir ({len(img_list)} images): {args.data}")
    return infer(args, folder_batches(args, img_list))


if __name__ == "__main__":
    main()
