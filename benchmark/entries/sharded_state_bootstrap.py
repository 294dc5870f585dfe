"""Entry: `parallel.mesh.sharded_bootstrap_distances` over the cell's
cards, then the sort and quantiles the state interval does, on the
tomograph and point estimate of `state_interval`. Each card draws and
re-estimates its share of the resamples in its own worker thread, and the
distances are gathered on the first card. The check is the state
interval's, over every shard's counts; it also holds each call to one
shard per card, each drawn in its card's own thread."""

from __future__ import annotations

import numpy as np
import torch

from .state_interval import CAPTURE, COMPARED, readings, verify  # noqa: F401 - the entry interface
from benchmark import checks

from .state_interval import tomograph


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, devices):
        from quantpy_tpu_torch.parallel import mesh

        checks.require_precision(config)
        self.mesh = mesh
        self.devices = devices
        self.tmg, self.counts = tomograph(config, seed, devices[0])
        c = traffic["center"]
        est = self.tmg.point_estimate(c["method"], max_iter=c["max_iter"], tol=c["tol"])
        dtype = self.tmg.dtype
        self.args = tuple(torch.as_tensor(x, dtype=dtype, device=devices[0]) for x in
                          (est.bloch, self.tmg.povm_matrix, self.tmg.n_measurements))
        self.options = traffic["options"]
        self.levels = np.asarray(traffic["levels"], dtype=np.float64)

    def call(self, key: int):
        d = self.mesh.sharded_bootstrap_distances(
            self.mesh.make_mesh(devices=self.devices), key, *self.args, **self.options)
        d = np.sort(d.cpu().numpy().astype(np.float64))
        return d, np.interp(self.levels, np.linspace(0.0, 1.0, len(d)), d)

    def release(self) -> dict:
        inputs = {"experiment": self.counts,
                  "center": np.asarray(self.tmg.reconstructed_state.bloch, dtype=np.float64)}
        self.tmg = self.args = None
        return inputs
