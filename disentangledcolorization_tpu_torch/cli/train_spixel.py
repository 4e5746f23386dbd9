"""Stage-1 SpixelNet training command line.

Counterpart of ``disentangledcolorization_tpu/cli/train_spixel.py``
(``:35-212``): the ab (or BGR) + xy reconstruction loss, Adam or SGD with the
poly/cosine/plateau schedules, per-epoch validation with boundary-marked
superpixel dumps, last/best checkpoints, ``--resume``, and a clean checkpoint
on SIGTERM/SIGINT. Runs on the card unless ``--device cpu``:

    python -m disentangledcolorization_tpu_torch.cli.train_spixel --data <root with train/ val/> \\
        --batch_size 128 --epochs 20 --name spixel

Data parallel as ``cli/train_colorizer.py`` says: one process per card with
``--coordinator``/``--num_processes``/``--process_id`` (or torchrun's
environment with ``--coordinator env://``), ``--batch_size`` per card, BatchNorm over the global batch,
gradients averaged, only rank 0 writing, the global validation loss.

:func:`main` parses the flags and decodes the image folders (OpenCV);
:func:`train` takes any two sequences of item dicts {'gray', 'color', 'BGR'},
such as ``train.data.ArrayDataset``, for hosts without an image decoder.
"""

from __future__ import annotations

import math
import os

import torch

from ..models import SpixelSeg
from ..ops import superpixel as sp
from ..parallel import mesh
from ..train import data as data_lib
from ..train import optim, steps
from ..train.checkpoint import CheckpointManager
from ..train.losses import spixel_loss
from ..train.state import TrainState
from ..utils import io as io_lib
from ..utils.config import spixel_argparser
from ..utils.logging import StepTimer, profiler_trace
from ..utils.seeding import param_count
from ..utils.signals import GracefulShutdown, register_stack_dump
from ._common import (configure_backends, host_metrics, rank_writers, refuse_unported, save_checkpoint,
                      start_processes, to_device)


def main(argv=None) -> dict:
    args = spixel_argparser().parse_args(argv)
    refuse_unported(args)
    start_processes(args)  # before decoding a dataset: no card or no rendezvous, no run
    train_ds = data_lib.build_dataset(args.dataset, args.data, "train", args.input_size, cache=args.cache_data)
    val_ds = data_lib.build_dataset(args.dataset, args.data, "val", args.input_size, cache=args.cache_data)
    return train(args, train_ds, val_ds)


def train(args, train_ds, val_ds) -> dict:
    """Train SpixelSeg on ``train_ds`` with validation on ``val_ds``. Returns
    the state and the run's record: 'history' (per epoch), 'step_losses',
    'step_seconds', 'start_epoch', 'best_loss', 'run_dir'. A process group
    that this call makes (the distributed flags) is left at its end."""
    refuse_unported(args)
    device, made_group = start_processes(args)
    try:
        return _train(args, train_ds, val_ds, device)
    finally:
        if made_group:
            mesh.shutdown_distributed()


def _train(args, train_ds, val_ds, device) -> dict:
    register_stack_dump()  # kill -USR1 <pid> = thread dump, not termination
    run_dir = os.path.join(args.save_dir, args.name)
    rank, world = mesh.process_index(), mesh.world_size()
    logger, writer_t, writer_v = rank_writers(run_dir)
    configure_backends(args, logger)
    if world > 1:
        logger.info(f"data parallel over {world} processes: batch {args.batch_size} a process, "
                    f"global batch {args.batch_size * world}")
    if args.compute_dtype != "float32":
        logger.info(f"--compute_dtype {args.compute_dtype} is ignored: stage 1 trains in float32, "
                    "as the JAX stage-1 trainer (which never reads the flag) does")

    loader_kwargs = dict(batch_size=args.batch_size, num_workers=args.num_workers, seed=args.seed,
                         process_id=rank, num_processes=world)
    train_loader = data_lib.DataLoader(train_ds, shuffle=True, **loader_kwargs)
    val_loader = data_lib.DataLoader(val_ds, shuffle=False, **loader_kwargs)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = SpixelSeg()
    model.to(device)
    mesh.replicate(model)
    logger.info(f"SpixelSeg params: {param_count(model) / 1e6:.2f}M, device: {device}")

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

    train_step = steps.make_spixel_train_step(args.psize)
    ids, coord = sp.init_spixel_grid(args.input_size, args.input_size, args.psize, device=device)

    def prepare(batch):
        b = to_device(batch, device, ("gray", "color", "BGR"))
        n = b["gray"].shape[0]
        # the reconstruction feature: ab chroma or BGR pixels (--feat)
        return {"gray": b["gray"], "feat": b["color"] if args.feat == "ab" else b["BGR"],
                "coord": coord[None].expand(n, *coord.shape), "BGR": b["BGR"]}

    @torch.no_grad()
    def eval_step(batch):
        prob = model(batch["gray"], train=False)
        labxy = torch.cat([batch["feat"], batch["coord"]], dim=-1)
        return mesh.mean_reduce_metrics(spixel_loss(prob, labxy, args.psize)), prob

    record = {"history": [], "step_losses": [], "step_seconds": [], "start_epoch": start_epoch, "run_dir": run_dir}
    with profiler_trace(args.trace_dir or None), GracefulShutdown() as shutdown:
        for epoch in range(start_epoch, args.epochs):
            train_loader.set_epoch(epoch)
            timer = StepTimer()
            ep_loss, n_steps = 0.0, 0
            for it, batch in enumerate(train_loader):
                if mesh.any_rank(shutdown.requested, device):
                    break
                batch = prepare(batch)
                timer.mark_data()
                metrics = host_metrics(train_step(state, batch, args.seed))  # waits for the step
                timer.mark_step(batch["gray"].shape[0])
                loss = metrics["totalLoss"]
                record["step_losses"].append(metrics)
                ep_loss += loss
                n_steps += 1
                if it % 100 == 0:
                    s = timer.summary()
                    logger.info(f"epoch {epoch} iter {it}: loss {loss:.4f} "
                                f"(io/proc {s['io_proc_ratio']:.2f}, {s['images_per_sec']:.1f} img/s)")
            record["step_seconds"] += timer.durations
            ep_loss /= max(n_steps, 1)
            stopping = mesh.any_rank(shutdown.requested, device)
            if not math.isfinite(ep_loss):
                # keep 'last' finite: resume from it, ideally with --grad_clip
                logger.error(f"non-finite train loss at epoch {epoch} ({ep_loss}); aborting WITHOUT checkpointing. "
                             "Resume from the last finite checkpoint, ideally with --grad_clip > 0.")
                break
            writer_t.scalar("train/totalLoss", ep_loss, epoch)
            entry = {"epoch": epoch, "train_loss": ep_loss, "val_loss": None}
            record["history"].append(entry)

            if stopping:
                # the epoch is not advanced, so --resume redoes it
                logger.info(f"shutdown signal received at epoch {epoch} iter {n_steps}: checkpointing and exiting")
                save_checkpoint(mgr, "last", state, epoch, best_loss, plateau)
                break

            # validation and boundary dumps
            val_loss, vn = 0.0, 0
            for it, batch in enumerate(val_loader):
                batch = prepare(batch)
                metrics, prob = eval_step(batch)
                val_loss += host_metrics(metrics)["totalLoss"]
                vn += 1
                if it == 0 and mesh.is_main():
                    spix_map = sp.split_spixels(prob[:4], ids)
                    io_lib.save_markedSP_from_batch(batch["BGR"][:4].flip(-1).cpu().numpy(), spix_map.cpu().numpy(),
                                                    os.path.join(run_dir, "val_imgs"), [], epoch)
            if vn == 0:
                # a val set smaller than one batch (drop_last): 0.0 would pass for a best
                logger.warning("validation produced no batches (val set < batch); saving 'last' only")
                save_checkpoint(mgr, "last", state, epoch + 1, best_loss, plateau)
                continue
            val_loss /= vn
            entry["val_loss"] = val_loss
            if args.scheduler == "plateau":
                plateau.update(val_loss)
            writer_v.scalar("val/totalLoss", val_loss, epoch)
            logger.info(f"epoch {epoch}: train {ep_loss:.4f} val {val_loss:.4f}")
            save_checkpoint(mgr, "last", state, epoch + 1, min(best_loss, val_loss), plateau)
            if val_loss < best_loss:
                best_loss = val_loss
                save_checkpoint(mgr, "best", state, epoch + 1, best_loss, plateau)
    writer_t.flush()
    writer_v.flush()
    logger.info("done.")
    record.update(state=state, best_loss=best_loss)
    return record


if __name__ == "__main__":
    main()
