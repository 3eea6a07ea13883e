"""Offline weight conversion: a torch .pth or the official .onnx -> the
port's params file (one ``torch.save`` of the parameter tree), which every
other command line loads with ``--pretrained``.

Usage:
  python -m pangu_tpu_torch.cli.convert_weights \\
      --input /path/pangu_weather_24_torch.pth --output weights/pangu24.pt
  python -m pangu_tpu_torch.cli.convert_weights \\
      --input /path/pangu_weather_24.onnx --keys_csv keys_all.csv \\
      --output weights/pangu24.pt --dtype bfloat16
"""

from __future__ import annotations

import argparse
import dataclasses

from pangu_tpu_torch import _device
from pangu_tpu_torch.config import PANGU_24, TINY
from pangu_tpu_torch.models import convert, pangu
from pangu_tpu_torch.utils.checkpoint import save_params


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True, help=".pth or .onnx weights")
    p.add_argument("--keys_csv", default=None,
                   help="torch->onnx name CSV (required for .onnx)")
    p.add_argument("--output", required=True, help="params file to write")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--tiny", action="store_true",
                   help="TINY geometry (tests)")
    p.add_argument("--device", default="cuda",
                   help='where the conversion runs: "cuda" (default) or "cpu"')
    args = p.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = dataclasses.replace(TINY if args.tiny else PANGU_24,
                              param_dtype=args.dtype)
    if args.input.endswith(".onnx"):
        if not args.keys_csv:
            raise SystemExit("--keys_csv required for .onnx input")
        params = convert.convert_onnx(args.input, args.keys_csv, cfg,
                                      device=dev)
    else:
        params = convert.load_torch_checkpoint(args.input, cfg,
                                               device=dev)
    n = pangu.param_count(params)
    save_params(args.output, params)
    print(f"converted {n:,} parameters -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
