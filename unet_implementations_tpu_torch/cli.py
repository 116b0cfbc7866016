"""Command line of the PyTorch port.

    python -m unet_implementations_tpu_torch.cli predict \\
        --model_path model.pth --input <image-or-dir> --output_dir predictions

``--model_path`` is a reference-schema ``.pth``, such as the JAX package's
``cli export_torch`` writes. The forward runs on CUDA unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="unet_implementations_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    pred = sub.add_parser("predict", help="run a trained UNet on an image file or directory")
    pred.add_argument("--model_path", required=True, help="a reference-schema .pth checkpoint")
    pred.add_argument("--input", required=True, help="an image file or a directory of images")
    pred.add_argument("--output_dir", default="predictions")
    pred.add_argument("--batch_size", type=int, default=32)
    pred.add_argument("--no_overlay", action="store_true")
    pred.add_argument("--f32", action="store_true", help="run in float32 instead of bfloat16")
    pred.add_argument("--device", default=None,
                      help="torch device, e.g. cuda:1 or cpu (default: cuda)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.command == "predict":
        from unet_implementations_tpu_torch.recipes.common import predict_segmentation

        predict_segmentation(
            args.model_path, args.input, args.output_dir,
            batch_size=args.batch_size,
            dtype=torch.float32 if args.f32 else torch.bfloat16,
            overlay=not args.no_overlay, device=args.device,
        )


if __name__ == "__main__":
    main()
