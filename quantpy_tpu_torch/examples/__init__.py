"""The research walkthroughs of examples/*.py on the port.

Each module keeps the functions, names and flags of its counterpart in
examples/ and runs as

    python -m quantpy_tpu_torch.examples.<name> [--device cpu]

`--device` (default ``cuda``) sets the port's default device for the run.
Figures are written only where matplotlib is installed, into
quantpy_tpu_torch/examples/figures/ (see `_viz`); EXAMPLES_FIGURES=0 turns
them off. The records of `real_records` are read from examples/data/ of the
checkout.
"""

from __future__ import annotations

import argparse

import torch

from .. import config


def device_label(device=None) -> str:
    """The device the timings of an example ran on: the card's name on
    ``cuda``, else the device type (default: `config.get_device()`)."""
    device = torch.device(device) if device is not None else config.get_device()
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def parse_args(parser: argparse.ArgumentParser, args=None) -> argparse.Namespace:
    """Parse an example's flags plus `--device`, and make that device the
    port's default."""
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device the example runs on (the port's default device)",
    )
    parsed = parser.parse_args(args)
    config.set_device(parsed.device)
    return parsed
