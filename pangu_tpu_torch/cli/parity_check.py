"""Golden-numerics parity harness against the reference implementation.

Given converted pretrained weights (and optionally an ERA5 frame, a golden
output or the reference's published score tables), this checks the port
end to end:

  1. structural checks: the parameter inventory against the reference's
     223-entry name map (every entry's leaf present in the tree) and, with
     full-size weights, the parameter count;
  2. golden forward: the 24 h step on a saved input frame against a saved
     reference output (made once with the reference PyTorch model or ONNX
     Runtime elsewhere), reporting mean |diff| / mean |ref| per variable
     (0.5% passes); optionally per-stage activations (``taps``) dumped or
     compared against a reference dump, naming the first diverging stage;
  3. score parity: the Z500 / T850 RMSE of an evaluation sweep's CSVs
     against the reference's published anchors (within 0.5%).

Without weights it still runs the structural checks, on fresh weights, so
the harness itself is testable; the repository holds neither weights nor
frames.

Usage:
  python -m pangu_tpu_torch.cli.parity_check --pretrained weights/pangu24.pt \\
      [--frame frame.npz] [--golden reference_output.npz]
  python -m pangu_tpu_torch.cli.parity_check --device cpu --tiny
  # frame.npz: upper (5, 13, 721, 1440), surface (4, 721, 1440) float32
  # golden.npz: out_upper, out_surface in physical units
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np

ANCHORS = {  # the reference's published ONNX row (BASELINE.md)
    "z500_rmse": 45.001,
    "t850_rmse": 0.717,
}
REF_ENTRIES = 223           # the reference's keys_all.csv
REF_PARAMS = 276_659_936    # the published 24 h model's parameter count
TOL = 5e-3


def _csv_column_mean(path: str, column: str) -> float:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    j = rows[0].index(column)
    return float(np.mean([float(r[j]) for r in rows[1:]]))


def _leaf(tree, path):
    """The leaf at ``path`` in a nested dict / list tree, or None."""
    try:
        for k in path:
            tree = tree[k]
    except (KeyError, IndexError, TypeError):
        return None
    return tree


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pretrained", default=None,
                   help="weights: .pth (torch) or a params file of "
                        "convert_weights")
    p.add_argument("--frame", default=None, help=".npz with upper/surface")
    p.add_argument("--golden", default=None,
                   help=".npz with reference out_upper/out_surface")
    p.add_argument("--csv_dir", default=None,
                   help="compare an eval sweep csv dir against the anchors")
    p.add_argument("--dump-activations", default=None, metavar="OUT_NPZ",
                   help="with --frame: save per-stage activations (embed, "
                        "stage0..3, down/upsample, outputs)")
    p.add_argument("--golden-activations", default=None, metavar="REF_NPZ",
                   help="with --frame: compare per-stage activations "
                        "against a reference dump, reporting the FIRST "
                        "diverging stage")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help='"cuda" (default: the card; raises where there is '
                        'none) or "cpu" (the plain versions)')
    args = p.parse_args(argv)

    import torch

    from pangu_tpu_torch import _device
    from pangu_tpu_torch.cli import common
    from pangu_tpu_torch.config import PANGU_24, TINY, Config
    from pangu_tpu_torch.data.constants import (denorm_data, get_constants,
                                                to_device)
    from pangu_tpu_torch.models import convert, pangu

    dev = _device.resolve(args.device)
    cfg = TINY if args.tiny else PANGU_24
    ok = True

    # 1. structural audit
    entries = convert.name_map(cfg)
    print(f"[structure] name map entries: {len(entries)} "
          f"(reference keys_all.csv: {REF_ENTRIES})")
    ok &= len(entries) == REF_ENTRIES or args.tiny
    if args.pretrained:
        ns = argparse.Namespace(pretrained=args.pretrained, keys_csv=None,
                                device=str(dev))
        params = common.load_params(ns, Config(model=cfg))
        n = pangu.param_count(params)
        print(f"[structure] loaded {n:,} parameters")
        if not args.tiny and n != REF_PARAMS:
            print(f"[structure] FAIL: expected {REF_PARAMS:,}")
            ok = False
    else:
        params = pangu.init_params(torch.Generator().manual_seed(0), cfg,
                                   device=dev)
        print("[structure] no --pretrained given; using random init "
              "(golden checks will be structural only)")
    missing = [name for name, path, _ in entries
               if not isinstance(_leaf(params, path), torch.Tensor)]
    print(f"[structure] tree leaves for the name map: "
          f"{len(entries) - len(missing)} of {len(entries)}")
    if missing:
        print(f"[structure] FAIL: no leaf for {missing[:5]}")
        ok = False

    constants = to_device(get_constants(None, cfg), dev)

    # 2. golden forward
    if args.frame:
        data = np.load(args.frame)
        upper = torch.as_tensor(data["upper"])[None].to(dev)
        surface = torch.as_tensor(data["surface"])[None].to(dev)
        taps = {} if (args.dump_activations
                      or args.golden_activations) else None
        with torch.no_grad():
            out_u, out_s = pangu.forward(params, upper, surface, constants,
                                         cfg, device=dev, taps=taps)
            out_u, out_s = denorm_data(out_u.float(), out_s.float(),
                                       constants)
        acts = {}
        if taps is not None:
            acts = {k: v.float().cpu().numpy() for k, v in taps.items()}
            acts["out_upper"] = out_u[0].cpu().numpy()
            acts["out_surface"] = out_s[0].cpu().numpy()
        if args.dump_activations:
            np.savez_compressed(args.dump_activations, **acts)
            print(f"[activations] dumped {sorted(acts)} -> "
                  f"{args.dump_activations}")
        if args.golden_activations:
            gold = np.load(args.golden_activations)
            for name in ("embed", "stage0", "downsample", "stage1", "stage2",
                         "upsample", "stage3", "out_surface"):
                if name not in gold:
                    continue
                got = acts[name].squeeze()
                want = np.asarray(gold[name], np.float32).squeeze()
                rel = float(np.abs(got - want).mean()
                            / (np.abs(want).mean() + 1e-6))
                print(f"[activations] {name}: mean|diff|/mean|ref| = "
                      f"{rel:.2e} {'OK' if rel <= TOL else 'DIVERGES'}")
                if rel > TOL:
                    print(f"[activations] first divergence at {name!r}; "
                          "stages before it are parity-clean")
                    ok = False
                    break
        print(f"[forward] output ranges: upper [{float(out_u.min()):.3g}, "
              f"{float(out_u.max()):.3g}]")
        if args.golden:
            gold = np.load(args.golden)
            for name, got, want in (("upper", out_u[0], gold["out_upper"]),
                                    ("surface", out_s[0],
                                     gold["out_surface"])):
                want = np.asarray(want, np.float32)
                got = got.cpu().numpy()
                if got.shape != want.shape:
                    print(f"[golden] FAIL: {name} shape {got.shape} vs "
                          f"{want.shape}")
                    ok = False
                    continue
                rel = float(np.abs(got - want).mean()
                            / (np.abs(want).mean() + 1e-6))
                print(f"[golden] {name}: mean|diff|/mean|ref| = {rel:.2e}")
                for v in range(want.shape[0]):
                    rv = float(np.abs(got[v] - want[v]).mean()
                               / (np.abs(want[v]).mean() + 1e-6))
                    print(f"[golden] {name} variable {v}: max|diff| "
                          f"{float(np.abs(got[v] - want[v]).max()):.3e}, "
                          f"mean|diff|/mean|ref| {rv:.2e}")
                if rel > TOL:
                    print(f"[golden] FAIL: {name} relative error > "
                          f"{100 * TOL:.1f}%")
                    ok = False

    # 3. score anchors
    if args.csv_dir:
        z500 = _csv_column_mean(os.path.join(args.csv_dir, "rmse_upper_z.csv"),
                                "500")
        t850 = _csv_column_mean(os.path.join(args.csv_dir, "rmse_upper_t.csv"),
                                "850")
        for name, got in (("z500_rmse", z500), ("t850_rmse", t850)):
            want = ANCHORS[name]
            rel = abs(got - want) / want
            print(f"[anchor] {name}: {got:.3f} vs {want:.3f} "
                  f"({100 * rel:.2f}%) {'OK' if rel <= TOL else 'FAIL'}")
            ok &= rel <= TOL

    print("PARITY:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
