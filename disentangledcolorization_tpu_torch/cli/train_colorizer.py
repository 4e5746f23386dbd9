"""Stage-2 colorizer training command line (AnchorColorProb).

Counterpart of ``disentangledcolorization_tpu/cli/train_colorizer.py``
(``:51-378``): the frozen SpixelNet from stage 1, palLoss (rebalanced CE) +
refLoss (CE) + recLoss (the VGG19 perceptual term with ``--vgg_npz``, else
pixel L1 with a warning), Adam + poly decay, validation every ``--eval_freq``
epochs with image dumps, last/best checkpoints, ``--resume``, ``--remat``,
``--grad_accum``, ``--device_data``, and a clean checkpoint on SIGTERM/SIGINT.
Runs on the card unless ``--device cpu``:

    python -m disentangledcolorization_tpu_torch.cli.train_colorizer --data <root with train/ val/> \\
        --enhanced --vgg_npz vgg19.npz --spixel_ckpt runs/spixel --batch_size 24 --name disco

``--spixel_ckpt`` takes stage 1's run (a run dir, its ``checkpts`` dir or a
file), a reference torch ``.pth.tar``, or a ``.pkl`` of numpy arrays in the
JAX layout. :func:`main` parses the flags and decodes the image folders
(OpenCV); :func:`train` takes any two sequences of item dicts {'gray',
'color', ...}, such as ``train.data.ArrayDataset``.
"""

from __future__ import annotations

import math
import os

import torch

from .. import resolve_device
from ..models import AnchorColorProb, xavier_reinit_params
from ..models.vgg import load_vgg19
from ..ops import colorlabel as cl
from ..ops import hints as hints_ops
from ..ops import superpixel as sp
from ..tools.convert import load_numpy_pickle, spixel_from_jax_variables
from ..train import data as data_lib
from ..train import optim, steps
from ..train.checkpoint import CheckpointManager, load_train_variables
from ..train.losses import AnchorColorProbLoss
from ..train.state import TrainState
from ..utils import io as io_lib
from ..utils.config import pcolor_argparser
from ..utils.logging import MetricsWriter, StepTimer, build_logger, profiler_trace, steptime_stats
from ..utils.seeding import generator_for, param_count
from ..utils.signals import GracefulShutdown, register_stack_dump
from ._common import configure_backends, host_metrics, refuse_unported, to_device


def main(argv=None) -> dict:
    args = pcolor_argparser().parse_args(argv)
    refuse_unported(args, colorizer=True)
    resolve_device(args.device)  # before decoding a dataset: no card, no run
    train_ds = data_lib.build_dataset(args.dataset, args.data, "train", args.input_size, cache=args.cache_data)
    val_ds = data_lib.build_dataset(args.dataset, args.data, "val", args.input_size, cache=args.cache_data)
    return train(args, train_ds, val_ds)


def load_spixel_state_dict(path: str) -> dict:
    """SpixelSeg weights (``net.*`` keys) from stage 1's run or file, a
    reference torch checkpoint, or a ``.pkl`` of the JAX layout."""
    if path.endswith((".pkl", ".pickle")):
        return spixel_from_jax_variables(load_numpy_pickle(path))
    return load_train_variables(path, fold_spectral=False)


def train(args, train_ds, val_ds) -> dict:
    """Train AnchorColorProb on ``train_ds`` with validation on ``val_ds``.
    Returns the state, the loss bundle and the run's record: 'history' (per
    epoch), 'step_losses', 'step_seconds', 'start_epoch', 'best_loss', 'run_dir'."""
    refuse_unported(args, colorizer=True)
    device = resolve_device(args.device)
    register_stack_dump()  # kill -USR1 <pid> = thread dump, not termination
    run_dir = os.path.join(args.save_dir, args.name)
    logger = build_logger(run_dir)
    writer_t, writer_v = MetricsWriter(run_dir, "train"), MetricsWriter(run_dir, "val")
    configure_backends(args, logger)

    dd_train = dd_val = None
    if args.device_data:
        # the dataset lives on the card; a step moves only an index batch
        dd_train = data_lib.stack_dataset(train_ds, device=device)
        dd_val = data_lib.stack_dataset(val_ds, device=device)
        train_loader = data_lib.DeviceIndexLoader(len(train_ds), args.batch_size, shuffle=True, seed=args.seed)
        val_loader = data_lib.DeviceIndexLoader(len(val_ds), args.batch_size, shuffle=False, seed=args.seed)
        nbytes = sum(t.numel() * t.element_size() for d in (dd_train, dd_val) for t in d.values())
        logger.info(f"device-resident dataset: {nbytes / 1e9:.2f} GB moved once")
    else:
        loader_kwargs = dict(batch_size=args.batch_size, num_workers=args.num_workers, seed=args.seed)
        train_loader = data_lib.DataLoader(train_ds, shuffle=True, **loader_kwargs)
        val_loader = data_lib.DataLoader(val_ds, shuffle=False, **loader_kwargs)

    def batches(loader, dd):
        for b in loader:
            if dd is None:
                yield to_device(b, device, ("gray", "color"))
            else:
                idx = torch.as_tensor(b, device=device)
                yield {k: dd[k][idx] for k in ("gray", "color")}

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = AnchorColorProb(sp_size=args.psize, n_clusters=args.n_clusters, n_enc_layers=args.n_enc)
    # the reference's blanket xavier re-init, then the frozen stage-1 segnet
    xavier_reinit_params(model, generator_for(args.seed, "xavier", device="cpu"))
    if args.spixel_ckpt:
        model.segnet.load_state_dict(load_spixel_state_dict(args.spixel_ckpt))
        logger.info(f"frozen SpixelNet loaded from {args.spixel_ckpt}")
    else:
        logger.warning("no --spixel_ckpt: segnet is random AND frozen (smoke-test only)")
    model.to(device)
    logger.info(f"AnchorColorProb params: {param_count(model) / 1e6:.2f}M, device: {device}")

    steps_per_epoch = max(len(train_loader), 1)
    plateau = optim.PlateauState()
    base = optim.build_schedule(args.scheduler, args.lr, args.epochs, steps_per_epoch, args.lr_decay_ratio)
    state = TrainState.create(model, name=args.optimizer, schedule=lambda c: base(c) * plateau.scale,
                              weight_decay=args.wd, grad_clip=args.grad_clip)
    mgr = CheckpointManager(os.path.join(run_dir, "checkpts"))
    start_epoch, best_loss = 0, float("inf")
    if args.resume and mgr.exists("last"):
        start_epoch, best_loss = mgr.restore("last", state, plateau)
        logger.info(f"resumed from epoch {start_epoch} (best {best_loss:.4f})")

    vgg = load_vgg19(args.vgg_npz or None, args.vgg_type, device)
    logger.info("perceptual loss: " + ("VGG19" if vgg is not None else "L1 fallback (no VGG weights)"))
    loss_bundle = AnchorColorProbLoss(hint2regress=args.hint2regress, enhanced=args.enhanced,
                                      with_grad=args.in_gradient, vgg=vgg)
    class_lambda = 1.0 - args.colorfulness
    train_step = steps.make_colorizer_train_step(loss_bundle, remat=args.remat, class_lambda=class_lambda,
                                                 grad_accum=args.grad_accum)
    eval_step = steps.make_colorizer_eval_step(loss_bundle, class_lambda=class_lambda)

    record = {"history": [], "step_losses": [], "step_seconds": [], "start_epoch": start_epoch, "run_dir": run_dir}
    with profiler_trace(args.trace_dir or None), GracefulShutdown() as shutdown:
        for epoch in range(start_epoch, args.epochs):
            train_loader.set_epoch(epoch)
            timer = StepTimer()
            sums, n_steps = {}, 0
            for it, batch in enumerate(batches(train_loader, dd_train)):
                if shutdown.requested:
                    break
                timer.mark_data()
                metrics = host_metrics(train_step(state, batch, args.seed))  # waits for the step
                timer.mark_step(batch["gray"].shape[0])
                record["step_losses"].append(metrics)
                n_steps += 1
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0.0) + v
                if it % 100 == 0:
                    s = timer.summary()
                    logger.info(f"epoch {epoch} iter {it}: total {metrics['totalLoss']:.4f} "
                                f"pal {metrics['palLoss']:.4f} ref {metrics['refLoss']:.4f} "
                                f"rec {metrics['recLoss']:.4f} "
                                f"(io/proc {s['io_proc_ratio']:.2f}, {s['images_per_sec']:.1f} img/s)")
            record["step_seconds"] += timer.durations
            ep_total = sums.get("totalLoss", 0.0) / max(n_steps, 1)
            if not math.isfinite(ep_total):
                # keep 'last' finite: resume from it, ideally with --grad_clip
                logger.error(f"non-finite train loss at epoch {epoch} ({ep_total}); aborting WITHOUT checkpointing. "
                             "Resume from the last finite checkpoint, ideally with --grad_clip > 0.")
                break
            for k, v in sums.items():
                writer_t.scalar(f"train/{k}", v / max(n_steps, 1), epoch)
            entry = {"epoch": epoch, "train_loss": ep_total, "val_loss": None}
            record["history"].append(entry)

            if shutdown.requested:
                # the epoch is not advanced, so --resume redoes it
                logger.info(f"shutdown signal received at epoch {epoch} iter {n_steps}: checkpointing and exiting")
                mgr.save("last", state, epoch, best_loss, plateau)
                break

            if (epoch + 1) % args.eval_freq != 0 and epoch + 1 != args.epochs:
                continue
            val_loss, vn = 0.0, 0
            for it, b in enumerate(batches(val_loader, dd_val)):
                val_loss += host_metrics(eval_step(state, b, args.seed + 10_000 + it))["totalLoss"]
                vn += 1
                if it == 0:
                    _dump_val_images(model, b, run_dir, epoch, args)
            if vn == 0:
                # a val set smaller than one batch (drop_last): 0.0 would pass for a best
                logger.warning("validation produced no batches (val set < batch); saving 'last' only")
                mgr.save("last", state, epoch + 1, best_loss, plateau)
                continue
            val_loss /= vn
            entry["val_loss"] = val_loss
            if args.scheduler == "plateau":
                plateau.update(val_loss)
            writer_v.scalar("val/totalLoss", val_loss, epoch)
            logger.info(f"epoch {epoch}: val {val_loss:.4f}")
            mgr.save("last", state, epoch + 1, min(best_loss, val_loss), plateau)
            if val_loss < best_loss:
                best_loss = val_loss
                mgr.save("best", state, epoch + 1, best_loss, plateau)
    # step-time stability; a cold start's first step includes cuDNN's warm-up
    stats = steptime_stats(record["step_seconds"][1:] if start_epoch == 0 else record["step_seconds"])
    if stats:
        logger.info("step-time stability: " + " ".join(
            f"{k}={v:.1f}" if isinstance(v, float) else f"{k}={v}" for k, v in stats.items()))
        for k, v in stats.items():
            writer_t.scalar(f"steptime/{k}", float(v), state.step)
    writer_t.flush()
    writer_v.flush()
    logger.info("done.")
    record.update(state=state, loss=loss_bundle, best_loss=best_loss)
    return record


@torch.no_grad()
def _dump_val_images(model, batch, run_dir, epoch, args, max_n: int = 4):
    """The eval forward on the first images of a batch, decoded: palette
    (pal), refined (ref) and enhanced colours, and the anchor panel (hints),
    as normalized-Lab PNGs under ``<run_dir>/val_imgs``."""
    gray, color = batch["gray"][:max_n], batch["color"][:max_n]
    out = model(gray, color, generator=torch.Generator(device=gray.device).manual_seed(epoch), test_mode=False,
                train=False)
    psize = args.psize
    pal_full = sp.upfeat(cl.decode_ind2ab(out["pal_logit"], T=0.38), out["affinity_map"], psize, psize)
    ref_full = sp.upfeat(cl.decode_ind2ab(out["ref_logit"], T=0), out["affinity_map"], psize, psize)
    anchor_masks = sp.upfeat(out["hint_mask"], out["affinity_map"], psize, psize)
    marked = hints_ops.mark_color_hints(gray, ref_full, anchor_masks, base_abs=ref_full)
    dump_dir = os.path.join(run_dir, "val_imgs")
    for suffix, ab in (("pal", pal_full), ("ref", ref_full), ("enhanced", out["pred_colors"])):
        io_lib.save_normLabs_from_batch(torch.cat([gray, ab], dim=-1), dump_dir, [], epoch, suffix=suffix)
    io_lib.save_normLabs_from_batch(marked, dump_dir, [], epoch, suffix="hints")


if __name__ == "__main__":
    main()
