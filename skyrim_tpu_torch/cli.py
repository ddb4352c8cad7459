"""Console script ``forecast-torch`` (port of skyrim_tpu/cli.py).

The flags, choices, defaults and help of the JAX package's ``forecast``
command (reference skyrim/forecast.py:59-147), on ``argparse``: the card's
machine has no ``click``.  ``--device`` (default ``cuda``) is the port's
own: the forecast runs on the card unless it asks for the CPU.  Heavy
imports wait until a forecast runs, so ``--help`` and ``-l`` work on any
machine.

    python -m skyrim_tpu_torch.cli -m pangu -ic file --ic-path ic.nc -lt 12 -o out
"""

from __future__ import annotations

import argparse
import datetime
import sys

MODEL_CHOICES = [
    "pangu", "fourcastnet", "fourcastnet_v2", "graphcast", "dlwp", "fuxi", "fengwu",
]
IC_CHOICES = ["cds", "gfs", "ifs", "synthetic", "file"]


def run_forecast(
    model_name: str,
    date: str,
    time: str,
    lead_time: int,
    initial_conditions: str,
    output_dir: str,
    filter_vars: str,
    ic_path: str | None = None,
    device: str = "cuda",
) -> tuple:
    """Core run path (reference forecast.py:19-56) through the port's facade."""
    from skyrim_tpu_torch.core import Skyrim
    from skyrim_tpu_torch.io.save import SaveConfig
    from skyrim_tpu_torch.utils.logging import logger

    ic = initial_conditions
    if ic == "file":
        if not ic_path:
            raise ValueError("--ic-path is required with -ic file")
        ic = f"file:{ic_path}"
    model = Skyrim(model_name, ic_source=ic, device=device)
    cfg = SaveConfig(
        output_dir=output_dir,
        filter_vars=tuple(v for v in filter_vars.split(",") if v),
    )
    pred, paths = model.predict(
        date=date, time=time, lead_time=lead_time, save=True, save_config=cfg
    )
    logger.success("forecast complete: %d files", len(paths))
    return pred, paths


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("python -m skyrim_tpu_torch.cli", description="Run a global weather forecast.")
    p.add_argument("-m", "--model_name", choices=MODEL_CHOICES, default="pangu", help="model to run")
    p.add_argument("--date", "-d", type=str,
                   default=(datetime.datetime.now(datetime.timezone.utc)
                            - datetime.timedelta(days=1)).strftime("%Y%m%d"),
                   help="start date YYYYMMDD (default yesterday)")
    p.add_argument("--time", "-t", type=str, default="0000", help="start time HHMM")
    p.add_argument("--lead_time", "-lt", type=int, default=6,
                   help="lead time in hours (floored to the model step)")
    p.add_argument("--list_models", "-l", action="store_true", help="list available models")
    p.add_argument("--initial_conditions", "-ic", choices=IC_CHOICES, default="gfs",
                   help="initial-condition source")
    p.add_argument("--ic-path", type=str, default=None, help="path to a saved IC/forecast (with -ic file)")
    p.add_argument("--output_dir", "-o", type=str, default="outputs", help="local dir or s3:// target")
    p.add_argument("--filter_vars", "-f", type=str, default="",
                   help="comma-separated channels to keep when saving")
    p.add_argument("--remote", "--modal", dest="remote", action="store_true",
                   help="run serverless via the remote launcher (reference's --modal)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on: cuda (default) or cpu")
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.list_models:
        print("Available models:")
        for m in MODEL_CHOICES:
            print(f"  {m}")
        return 0
    if args.initial_conditions == "file" and not args.ic_path:
        parser.error("--ic-path is required with -ic file")
    if args.remote:
        from skyrim_tpu_torch.serverless import run_remote

        run_remote(
            model_name=args.model_name, date=args.date, time=args.time, lead_time=args.lead_time,
            initial_conditions=args.initial_conditions, output_dir=args.output_dir,
            filter_vars=args.filter_vars, ic_path=args.ic_path,
        )
        return 0
    run_forecast(
        args.model_name, args.date, args.time, args.lead_time, args.initial_conditions,
        args.output_dir, args.filter_vars, args.ic_path, args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
