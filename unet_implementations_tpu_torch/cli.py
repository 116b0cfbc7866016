"""Command line of the PyTorch port.

    python -m unet_implementations_tpu_torch.cli our_unet train \\
        --data_dir <processed data> --output_dir <run dir> [flags]
    python -m unet_implementations_tpu_torch.cli our_unet evaluate \\
        --model_path <run dir>/best_model --data_dir <processed data> [flags]
    python -m unet_implementations_tpu_torch.cli ae_recon train|evaluate ...
    python -m unet_implementations_tpu_torch.cli ae_transfer train \\
        --pretrained_encoder <ae run dir>/best_model ...
    python -m unet_implementations_tpu_torch.cli ae_transfer evaluate ...
    python -m unet_implementations_tpu_torch.cli clip_resize --data_dir <processed data>
    python -m unet_implementations_tpu_torch.cli clip_unet embed --data_dir <processed data>
    python -m unet_implementations_tpu_torch.cli clip_unet train \\
        --data_dir <processed data> --output_dir <run dir> \\
        [--embeddings_dir <processed data>/clip_embeddings]
    python -m unet_implementations_tpu_torch.cli clip_unet evaluate ...
    python -m unet_implementations_tpu_torch.cli augment --data_dir <processed data>
    python -m unet_implementations_tpu_torch.cli predict \\
        --model_path model.pth --input <image-or-dir> --output_dir predictions

Data-parallel training runs one process per GPU under a launcher:

    python -m torch.distributed.run --nproc_per_node N \\
        -m unet_implementations_tpu_torch.cli our_unet train ...

Each ``train`` command joins the process group the launcher describes
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``;
``parallel/distributed.py``), takes the card ``cuda:LOCAL_RANK`` and trains
on its stripe of the training files; ``--batch_size`` is the global batch,
split evenly over the ranks (and their ``--grad_accum`` microbatches), and
the loss is the global batch's. Only rank 0 writes files. ``--no_mesh`` keeps
such a launch from wrapping the model: every rank then trains the same model
alone on the whole training set, and rank 0 writes. The backend is NCCL on a
card and gloo on the CPU. ``evaluate`` stays one process: JAX's
mesh there spreads one process's batch over its local chips, which a
one-process-per-GPU port has no counterpart of.

Spatial partitioning shards each image's rows over N ranks, in training and
in serving:

    python -m torch.distributed.run --nproc_per_node N \
        -m unet_implementations_tpu_torch.cli our_unet train --spatial N ...
    python -m torch.distributed.run --nproc_per_node N \
        -m unet_implementations_tpu_torch.cli predict --spatial N ...

The launch may hold a multiple of N ranks: they form a (data, space) grid
whose space groups each train on one stripe of the files (``--batch_size``
then splits over the data ranks). ``predict --spatial`` joins the launcher's
group as ``train`` does; rank 0 writes the masks.

The flags of ``our_unet``, ``ae_recon``, ``ae_transfer``, ``clip_unet``,
``clip_resize`` and ``augment`` are the JAX package's
(``unet_implementations_tpu/cli.py``), with its defaults; ``clip_unet embed``
also takes ``--device``, ``--f32`` and ``--decode_cache``, ``augment`` also
takes ``--device``, and ``--clip_weights`` is a torch CLIP checkpoint (OpenAI,
open_clip or TorchScript; random weights from seed 0 without it).
``--device`` is the torch device (default: CUDA; ``cpu`` runs the plain
PyTorch path). ``--num_workers`` is an alias of ``--num_threads``;
``--decode_cache DIR`` sets ``UNET_TPU_DECODE_CACHE`` for every dataset the
command opens. ``--amp`` and ``--reduced_complexity`` are accepted and do
nothing, and so is ``clip_unet train --use_clip``. ``--grad_accum N`` trains
each batch as N sequential microbatches with one optimizer update.
``--online_augment`` augments each training batch on the device (and, in
``clip_unet``, extracts its CLIP features live). Not ported yet, and refused:
``--visualize_samples`` > 0 (so it defaults to 0 here, 3 in JAX) and
``--analyze_latent_space``.

``--model_path`` of ``evaluate`` is a checkpoint directory or a reference
``.pth``; that of ``predict`` is a reference ``.pth``, such as the JAX
package's ``cli export_torch`` writes.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch


def _add_compat_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--num_workers", type=int, default=None,
                   help="alias of --num_threads")
    p.add_argument("--decode_cache", default=None, metavar="DIR",
                   help="decode each image and mask once into a uint8 memmap cache under "
                        "DIR and read from it thereafter; applies to every dataset the "
                        "command opens, and is rebuilt when the source files change")
    p.add_argument("--device", default=None,
                   help="torch device, e.g. cuda:1 or cpu (default: cuda)")
    p.add_argument("--amp", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--reduced_complexity", action="store_true", help=argparse.SUPPRESS)


def _add_common_train_flags(p: argparse.ArgumentParser, batch_size: int = 32) -> None:
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--batch_size", type=int, default=batch_size)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--num_threads", type=int, default=8)
    p.add_argument("--save_every", type=int, default=10)
    p.add_argument("--patience", type=int, default=15)
    p.add_argument("--resume", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_mesh", action="store_true",
                   help="under a launch with several ranks, do not train data-parallel: every "
                        "rank trains the same model alone and rank 0 writes; a single "
                        "process trains as without it")
    p.add_argument("--f32", action="store_true", help="compute in float32 (default bf16)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="split each batch into this many sequential microbatches, one "
                        "optimizer update per batch")
    _add_compat_flags(p)


def _add_seg_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--online_augment", action="store_true",
                   help="augment each training batch on the device (class-balanced policy); "
                        "Train/augmented/ is not read")
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--momentum", type=float, default=0.99)
    p.add_argument("--weighted_ce", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--static_weights", action="store_true")
    p.add_argument("--dice_weight", type=float, default=1.0)
    p.add_argument("--ce_weight", type=float, default=1.0)


def _add_eval_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model_path", required=True,
                   help="a checkpoint directory or a reference-schema .pth")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", default="evaluation_results")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--visualize_samples", type=int, default=0, help="not ported: only 0")
    # JAX's evaluate spreads one process's batch over its local chips; one
    # process per GPU has no counterpart of that.
    p.description = ("Evaluation runs in one process on one device, also under a launcher "
                     "of several ranks.")
    p.add_argument("--f32", action="store_true", help="compute in float32 (default bf16)")
    _add_compat_flags(p)


CLIP_MODELS = ["ViT-B/16", "ViT-B/32", "ViT-L/14"]


def _add_clip_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--clip_model", default="ViT-B/16", choices=CLIP_MODELS)
    p.add_argument("--clip_weights", default=None,
                   help="a torch CLIP checkpoint (OpenAI, open_clip or TorchScript); "
                        "random weights if absent")
    p.add_argument("--embeddings_dir", default=None,
                   help="the tables `clip_unet embed` wrote (skips live extraction)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="unet_implementations_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)

    our = sub.add_parser("our_unet", help="train or evaluate the 6-stage UNet")
    our_sub = our.add_subparsers(dest="cmd", required=True)
    t = our_sub.add_parser("train")
    _add_common_train_flags(t)
    _add_seg_train_flags(t)
    t.add_argument("--spatial", type=int, default=0,
                   help="shard image ROWS over N ranks during training (a (data, space) grid "
                        "of processes: halo exchanges and the InstanceNorm and loss "
                        "reductions across ranks) — the beyond-HBM image-size configuration. "
                        "Requires H divisible by 32·N and a launch of a multiple of N ranks")
    _add_eval_flags(our_sub.add_parser("evaluate"))

    ae = sub.add_parser("ae_recon", help="train or evaluate the reconstruction autoencoder")
    ae_sub = ae.add_subparsers(dest="cmd", required=True)
    t = ae_sub.add_parser("train")
    _add_common_train_flags(t)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--weight_decay", type=float, default=1e-5)
    t.add_argument("--mse_weight", type=float, default=1.0)
    t.add_argument("--perceptual_weight", type=float, default=0.0)
    t.add_argument("--ssim_weight", type=float, default=0.0)
    e = ae_sub.add_parser("evaluate")
    _add_eval_flags(e)
    e.add_argument("--analyze_latent_space", action="store_true", help="not ported")

    tr = sub.add_parser("ae_transfer",
                        help="train or evaluate the UNet on a frozen autoencoder encoder")
    tr_sub = tr.add_subparsers(dest="cmd", required=True)
    t = tr_sub.add_parser("train")
    _add_common_train_flags(t)
    _add_seg_train_flags(t)
    t.add_argument("--pretrained_encoder", required=True,
                   help="the ae_recon best_model checkpoint (a directory or its model.pth)")
    _add_eval_flags(tr_sub.add_parser("evaluate"))

    clip = sub.add_parser("clip_unet",
                          help="train, evaluate or embed with the CLIP-fused 6-stage UNet")
    clip_sub = clip.add_subparsers(dest="cmd", required=True)
    t = clip_sub.add_parser("train")
    _add_common_train_flags(t, batch_size=16)
    _add_seg_train_flags(t)
    _add_clip_flags(t)
    # The reference's --use_clip is store_true with default True: a no-op.
    t.add_argument("--use_clip", action="store_true", help=argparse.SUPPRESS)
    e = clip_sub.add_parser("evaluate")
    _add_eval_flags(e)
    _add_clip_flags(e)
    e.add_argument("--no_clip_features", action="store_true",
                   help="evaluate without conditioning (the reference evaluator's quirk)")
    em = clip_sub.add_parser("embed", help="write each split's CLIP embedding table to disk")
    em.add_argument("--data_dir", required=True)
    em.add_argument("--output_dir", default=None, help="default: <data_dir>/clip_embeddings")
    em.add_argument("--clip_model", default="ViT-B/16", choices=CLIP_MODELS)
    em.add_argument("--clip_weights", default=None, help="a torch CLIP checkpoint")
    em.add_argument("--batch_size", type=int, default=64)
    em.add_argument("--no_augmented", action="store_true", help="skip Train/augmented images")
    em.add_argument("--f32", action="store_true", help="compute in float32 (default bf16)")
    em.add_argument("--device", default=None,
                    help="torch device, e.g. cuda:1 or cpu (default: cuda)")
    em.add_argument("--decode_cache", default=None, metavar="DIR",
                    help="as for train and evaluate")

    clip_resize = sub.add_parser("clip_resize",
                                 help="write each split's resized_clip/ (padded square copies)")
    clip_resize.add_argument("--data_dir", required=True)
    clip_resize.add_argument("--size", type=int, default=224)

    aug = sub.add_parser("augment", help="write Train/augmented/ (class-balanced copies)")
    aug.add_argument("--data_dir", required=True,
                     help="processed dir; writes Train/augmented/{images,masks}")
    aug.add_argument("--cat_augmentations", type=int, default=5)
    aug.add_argument("--dog_augmentations", type=int, default=2)
    aug.add_argument("--seed", type=int, default=42)
    aug.add_argument("--config", default=None,
                     help="reference-format augmentation_config.yaml")
    aug.add_argument("--device", default=None,
                     help="torch device, e.g. cuda:1 or cpu (default: cuda)")

    pred = sub.add_parser("predict", help="run a trained UNet on an image file or directory")
    pred.add_argument("--model_path", required=True, help="a reference-schema .pth checkpoint")
    pred.add_argument("--input", required=True, help="an image file or a directory of images")
    pred.add_argument("--output_dir", default="predictions")
    pred.add_argument("--batch_size", type=int, default=32)
    pred.add_argument("--no_overlay", action="store_true")
    pred.add_argument("--f32", action="store_true", help="run in float32 instead of bfloat16")
    pred.add_argument("--spatial", type=int, default=0,
                      help="shard image rows over this many ranks of the launch on a "
                           "(data, space) grid — batch-1 latency scaling")
    pred.add_argument("--device", default=None,
                      help="torch device, e.g. cuda:1 or cpu (default: cuda)")
    return parser


def _dtype(args) -> torch.dtype:
    return torch.float32 if args.f32 else torch.bfloat16


def _num_threads(args) -> int:
    # torch's num_workers=0 means "decode in the main process"; the threaded
    # loader needs at least one worker, so 0 keeps the default.
    if args.num_workers is not None and args.num_workers > 0:
        return args.num_workers
    return getattr(args, "num_threads", 8)


def _seg_train_kwargs(args) -> dict:
    return dict(
        batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
        weight_decay=args.weight_decay, momentum=args.momentum,
        weighted_ce=args.weighted_ce, static_weights=args.static_weights,
        dice_weight=args.dice_weight, ce_weight=args.ce_weight,
        patience=args.patience, save_every=args.save_every, resume=args.resume,
        seed=args.seed, dtype=_dtype(args), device=args.device,
        num_threads=_num_threads(args), online_augment=args.online_augment,
        grad_accum=args.grad_accum, use_mesh=not args.no_mesh,
    )


def main(argv: Optional[Sequence[str]] = None):
    """Run one command; returns what its recipe returns (the training
    loop's result, the evaluation results, or the number of images
    predicted). A ``train`` command, and ``predict --spatial``, joins the
    launcher's process group first, if there is one, and leaves it when it
    returns."""
    args = build_parser().parse_args(argv)
    if getattr(args, "decode_cache", None):
        os.environ["UNET_TPU_DECODE_CACHE"] = args.decode_cache
    if getattr(args, "cmd", None) != "train" and getattr(args, "spatial", 0) <= 1:
        return _run(args)
    from unet_implementations_tpu_torch.parallel import distributed

    joined = not distributed.is_initialized() and distributed.maybe_initialize_distributed(device=args.device)
    try:
        return _run(args)
    finally:
        if joined:
            distributed.shutdown()


def _run(args):
    if args.command in ("our_unet", "ae_transfer"):
        from unet_implementations_tpu_torch.recipes import ae_transfer, our_unet

        if args.cmd == "train":
            kwargs = _seg_train_kwargs(args)
            if args.command == "our_unet":
                return our_unet.train(args.data_dir, args.output_dir, spatial=args.spatial,
                                      **kwargs)
            return ae_transfer.train(args.data_dir, args.output_dir,
                                     pretrained_encoder=args.pretrained_encoder, **kwargs)
        return our_unet.evaluate(
            args.model_path, args.data_dir, args.output_dir,
            batch_size=args.batch_size, dtype=_dtype(args), device=args.device,
            visualize_samples=args.visualize_samples, num_threads=_num_threads(args),
        )
    if args.command == "ae_recon":
        from unet_implementations_tpu_torch.recipes import ae_recon

        if args.cmd == "train":
            return ae_recon.train(
                args.data_dir, args.output_dir,
                batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
                weight_decay=args.weight_decay, mse_weight=args.mse_weight,
                perceptual_weight=args.perceptual_weight, ssim_weight=args.ssim_weight,
                patience=args.patience, save_every=args.save_every, resume=args.resume,
                seed=args.seed, dtype=_dtype(args), device=args.device,
                num_threads=_num_threads(args), grad_accum=args.grad_accum,
                use_mesh=not args.no_mesh,
            )
        return ae_recon.evaluate(
            args.model_path, args.data_dir, args.output_dir,
            batch_size=args.batch_size, dtype=_dtype(args), device=args.device,
            analyze_latent_space=args.analyze_latent_space,
            visualize_samples=args.visualize_samples, num_threads=_num_threads(args),
        )
    if args.command == "clip_unet":
        from unet_implementations_tpu_torch.recipes import clip_unet

        clip = dict(clip_model=args.clip_model, clip_weights=args.clip_weights)
        if args.cmd == "train":
            return clip_unet.train(args.data_dir, args.output_dir,
                                   embeddings_dir=args.embeddings_dir, **clip,
                                   **_seg_train_kwargs(args))
        if args.cmd == "embed":
            return clip_unet.dump_embeddings(
                args.data_dir, args.output_dir, batch_size=args.batch_size,
                include_augmented=not args.no_augmented, dtype=_dtype(args),
                device=args.device, **clip)
        return clip_unet.evaluate(
            args.model_path, args.data_dir, args.output_dir,
            batch_size=args.batch_size, dtype=_dtype(args), device=args.device,
            embeddings_dir=args.embeddings_dir, use_clip_features=not args.no_clip_features,
            visualize_samples=args.visualize_samples, num_threads=_num_threads(args), **clip)
    if args.command == "clip_resize":
        from pathlib import Path

        from unet_implementations_tpu_torch.data.pipeline import create_clip_resized

        counts = {}
        for split in ("Train", "Val", "Test"):
            d = Path(args.data_dir) / split
            if (d / "resized").exists():
                counts[split] = create_clip_resized([d / "resized"], d / "resized_clip",
                                                    args.size)
                print(f"{split}: {counts[split]} images")
        return counts
    if args.command == "augment":
        from unet_implementations_tpu_torch.data.augment import (
            augment_dataset_offline,
            load_policy_yaml,
        )

        stats = augment_dataset_offline(
            args.data_dir, cat_augmentations=args.cat_augmentations,
            dog_augmentations=args.dog_augmentations, seed=args.seed,
            policy=load_policy_yaml(args.config) if args.config else None, device=args.device)
        print(stats)
        return stats
    if args.command == "predict":
        from unet_implementations_tpu_torch.recipes.common import predict_segmentation

        return predict_segmentation(
            args.model_path, args.input, args.output_dir,
            batch_size=args.batch_size, dtype=_dtype(args),
            overlay=not args.no_overlay, device=args.device, spatial=args.spatial,
        )


if __name__ == "__main__":
    main()
