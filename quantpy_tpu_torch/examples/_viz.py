"""Shared figure styling for the example studies (copy of examples/_viz.py).

The scripts of this subpackage write their figures into
quantpy_tpu_torch/examples/figures/, a directory that git ignores (the
committed PNGs under examples/figures/ belong to the JAX package's
examples). One place defines the look: a fixed-order categorical
palette (validated reference instance of the dataviz method), recessive
grid/axes, thin 2px lines, text in ink tokens rather than series colors.

Matplotlib is optional — every example degrades to numbers-only when it is
unavailable or when --no-figure / EXAMPLES_FIGURES=0 is set.
"""

from __future__ import annotations

import os
import pathlib

#: fixed-order categorical slots (never cycled; assign by entity)
PALETTE = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4"]
SURFACE = "#fcfcfb"
GRID = "#e6e5e2"
TEXT = "#0b0b0b"
TEXT2 = "#52514e"

FIG_DIR = pathlib.Path(__file__).resolve().parent / "figures"


def figures_enabled() -> bool:
    if os.environ.get("EXAMPLES_FIGURES", "1") == "0":
        return False
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def new_axes(title: str, xlabel: str, ylabel: str, figsize=(7.0, 4.4)):
    """A styled (fig, ax) pair: surface background, recessive grid, no
    top/right spines, ink-colored text."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize, facecolor=SURFACE)
    ax.set_facecolor(SURFACE)
    ax.grid(True, color=GRID, linewidth=0.8, zorder=0)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(GRID)
    ax.tick_params(colors=TEXT2, labelsize=9)
    ax.set_title(title, color=TEXT, fontsize=11, loc="left", pad=10)
    ax.set_xlabel(xlabel, color=TEXT2, fontsize=9)
    ax.set_ylabel(ylabel, color=TEXT2, fontsize=9)
    return fig, ax


def legend(ax):
    leg = ax.legend(
        frameon=False, fontsize=9, labelcolor=TEXT2, handlelength=1.6
    )
    return leg


def save(fig, name: str) -> pathlib.Path:
    FIG_DIR.mkdir(exist_ok=True)
    path = FIG_DIR / f"{name}.png"
    fig.tight_layout()
    fig.savefig(path, dpi=144, facecolor=SURFACE)
    import matplotlib.pyplot as plt

    plt.close(fig)
    print(f"figure written: {path}")
    return path
