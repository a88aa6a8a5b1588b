"""Command-line front-end for the quantization pipeline (port of
``repro.pipeline.cli``).

    python -m repro_torch.pipeline.cli --arch qwen2-0.5b --recipe dfq-int8
    python -m repro_torch.pipeline.cli --list-recipes
    python -m repro_torch.pipeline.cli --arch qwen2-0.5b --smoke \
        --recipe serve-w8a8-kv8 --save /path/to/artifact --verbose --device cpu

The weights are the architecture's seeded random init. ``--save`` writes a
``QuantizedModel`` artifact that ``repro_torch.QuantizedModel.load``,
``python -m repro_torch.launch.serve --load`` and the JAX package all read.
"""
from __future__ import annotations

import argparse


def _print_recipes():
    from .recipes import BUILTIN_RECIPES

    for name in sorted(BUILTIN_RECIPES):
        r = BUILTIN_RECIPES[name]
        print(f"{name:16s} {' → '.join(r.stage_names())}")
        print(f"{'':16s}   {r.description}")


def _print_stages():
    from .registry import get_stage, list_stages

    for name in list_stages():
        s = get_stage(name)
        opts = ", ".join(f"{k}={v!r}" for k, v in s.defaults.items()) or "-"
        head = s.doc.splitlines()[0] if s.doc else ""
        print(f"{name:14s} options: {opts}")
        print(f"{'':14s}   {head}")


def print_site_sqnr(qm):
    """Per-site weight SQNR table."""
    snr = qm.site_sqnr_db()
    if not snr:
        return
    print("per-site weight SQNR (dB):")
    for site, db in sorted(snr.items(), key=lambda kv: kv[1]):
        print(f"  {site:14s} {db:7.2f}")


def _print_report(qm, verbose: bool):
    for rec in qm.report:
        m = rec["metrics"]
        extras = []
        if "skipped" in m:
            extras.append(f"skipped ({m['skipped']})")
        if "sites" in m:
            extras.append(f"{m['sites']} sites")
        if "sites_corrected" in m:
            extras.append(f"{len(m['sites_corrected'])} sites corrected")
        if "pairs" in m:
            extras.append(f"{m['pairs']} pairs x{m.get('iterations', 1)}")
        if "ops" in m:
            extras.append(f"{m['ops']} ops")
        if m.get("sqnr_min_db") is not None:
            extras.append(f"weight SQNR min {m['sqnr_min_db']:.1f} dB")
        if "compression" in m:
            extras.append(
                f"{m['int8_bytes'] / 1e6:.1f} MB ({m['compression']:.2f}x)")
        print(f"  {rec['stage']:14s} {rec['seconds'] * 1e3:8.1f} ms  "
              + "; ".join(extras))
    if verbose:
        print_site_sqnr(qm)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.pipeline.cli",
        description="Quantize an architecture with a pipeline recipe.")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--recipe", default="dfq-int8")
    ap.add_argument("--save", default=None, metavar="DIR",
                    help="persist the QuantizedModel artifact")
    ap.add_argument("--verbose", action="store_true",
                    help="print per-site weight SQNR diagnostics")
    ap.add_argument("--list-recipes", action="store_true")
    ap.add_argument("--list-stages", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)

    if args.list_recipes:
        _print_recipes()
        return 0
    if args.list_stages:
        _print_stages()
        return 0

    from .api import quantize

    arch = args.arch + ("-smoke" if args.smoke
                        and not args.arch.endswith("-smoke") else "")
    qm = quantize(arch, recipe=args.recipe, device=args.device)
    print(f"{arch} · recipe {qm.recipe.name!r} "
          f"({' → '.join(qm.recipe.stage_names())}) on {args.device}")
    _print_report(qm, args.verbose)
    if args.save:
        qm.save(args.save)
        print(f"saved QuantizedModel to {args.save}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
