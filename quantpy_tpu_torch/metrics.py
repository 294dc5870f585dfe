"""CI-calibration harness: the achieved confidence levels of interval
methods (port of quantpy_tpu/metrics.py).

For `n_iter` independent simulated experiments, reconstruct a point
estimate, build the chosen interval, and record the confidence level its
distance map assigns to the actual distance between estimate and truth.
Sorted levels against the uniform quantiles give the calibration curve
(the diagonal is perfect calibration).
"""

from __future__ import annotations

import numpy as np

from .tomography.interval import (
    BootstrapProcessInterval,
    BootstrapStateInterval,
    MHMCProcessInterval,
    MHMCStateInterval,
    MomentInterval,
    SugiyamaInterval,
)
from .tomography.process import ProcessTomograph
from .tomography.state import StateTomograph

__all__ = ["get_CL_list_state", "get_CL_list_channel", "STATE_INTERVALS",
           "CHANNEL_INTERVALS"]

# Only distance-valued intervals can be inverted; the polytope and
# moment-fidelity intervals return fidelity bands and are left out.
STATE_INTERVALS = {
    "moment": MomentInterval,
    "sugiyama": SugiyamaInterval,
    "bootstrap": BootstrapStateInterval,
    "mhmc": MHMCStateInterval,
}

CHANNEL_INTERVALS = {
    "moment": MomentInterval,
    "bootstrap": BootstrapProcessInterval,
    "mhmc": MHMCProcessInterval,
}


def _achieved_level(interval, dist_value: float) -> float:
    """Invert the interval's level -> distance map at the observed distance."""
    grid = np.linspace(1e-3, 1 - 1e-3, 512)
    dists, _ = interval(grid)
    return float(np.interp(dist_value, np.asarray(dists, dtype=np.float64), grid))


def get_CL_list_state(  # noqa: N802 - reference API name
    state,
    interval: str = "moment",
    n_measurements: int = 1000,
    povm: str = "proj-set",
    n_iter: int = 100,
    method: str = "lin",
    key: int = 0,
    **interval_kwargs,
):
    """Sorted achieved confidence levels of a state-interval family. The
    tomographs take the port's default device and dtype."""
    cls = STATE_INTERVALS[interval]
    levels = []
    for i in range(n_iter):
        tmg = StateTomograph(state, key=key * 100003 + i)
        tmg.experiment(n_measurements, povm)
        est = tmg.point_estimate(method)
        d = float(tmg.dst(est, state))
        levels.append(_achieved_level(cls(tmg, **interval_kwargs), d))
    return np.sort(np.asarray(levels))


def get_CL_list_channel(  # noqa: N802 - reference API name
    channel,
    interval: str = "moment",
    n_measurements: int = 1000,
    povm: str = "proj-set",
    input_states: str = "proj4",
    n_iter: int = 100,
    method: str = "lifp",
    key: int = 0,
    **interval_kwargs,
):
    """Sorted achieved confidence levels of a channel-interval family."""
    cls = CHANNEL_INTERVALS[interval]
    levels = []
    for i in range(n_iter):
        tmg = ProcessTomograph(channel, input_states=input_states, key=key * 100003 + i)
        tmg.experiment(n_measurements, povm)
        est = tmg.point_estimate(method)
        d = float(tmg.dst(est.choi, channel.choi))
        levels.append(_achieved_level(cls(tmg, **interval_kwargs), d))
    return np.sort(np.asarray(levels))
