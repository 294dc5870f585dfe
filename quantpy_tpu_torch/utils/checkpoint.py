"""Resumable accumulators for long Monte-Carlo runs (port of
quantpy_tpu/utils/checkpoint.py).

A chunked runner persists the accumulated samples to an .npz file after
every chunk and resumes from it on restart. The file format (`samples`,
`n_chunks`) is the JAX package's: a file written by either package resumes
in the other.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

__all__ = ["ChunkedAccumulator", "resumable_bootstrap"]


class ChunkedAccumulator:
    """Append-only sample store persisted atomically to an .npz file."""

    def __init__(self, path: str):
        self.path = path
        self._chunks: list[np.ndarray] = []
        self.n_done = 0
        #: number of chunks drawn so far, persisted so that a resumed run
        #: never reuses a chunk's random stream, even after a partial chunk
        self.n_chunks = 0
        if os.path.exists(path):
            with np.load(path) as data:
                samples = data["samples"]
                n_chunks = int(data["n_chunks"]) if "n_chunks" in data else None
            if samples.size:
                self._chunks = [samples]
                self.n_done = samples.shape[0]
                # legacy files (no n_chunks key): fall back to the sample
                # count, which over-counts chunks but can never REUSE a
                # chunk's stream (duplicated streams are the failure that
                # matters)
                self.n_chunks = (
                    n_chunks if n_chunks is not None else self.n_done
                )

    @property
    def samples(self) -> np.ndarray:
        if not self._chunks:
            return np.empty((0,))
        return np.concatenate(self._chunks, axis=0)

    def append(self, chunk: np.ndarray) -> None:
        chunk = np.asarray(chunk)
        self._chunks = [self.samples, chunk] if self._chunks else [chunk]
        self.n_done += chunk.shape[0]
        self.n_chunks += 1
        self._flush()

    def _flush(self) -> None:
        # atomic write: tmp file + rename, so a crash never corrupts state
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        # suffix must be .npz: np.savez appends it to any other name
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
        os.close(fd)
        try:
            np.savez(tmp, samples=self.samples, n_chunks=self.n_chunks)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _chunk_seed(seed: int, chunk_idx: int) -> int:
    """The seed of chunk `chunk_idx`'s generator: a stable function of
    (seed, chunk_idx), the same on every run and device."""
    return int(np.random.SeedSequence([seed, chunk_idx]).generate_state(1, np.uint64)[0])


def resumable_bootstrap(
    path: str,
    tmg,
    n_points: int,
    chunk_size: int = 1024,
    method: str = "lin",
    max_iter: int = 100,
    seed: int = 0,
):
    """Run (or resume) a bootstrap of `n_points` distances in chunks,
    checkpointing after each chunk. Returns the sorted distances.

    Each chunk draws from its own `torch.Generator` on the tomograph's
    device, seeded from `(seed, chunk index)` with the PERSISTED chunk
    counter, so a resumed run reproduces an uninterrupted one on the same
    device, including after a partial final chunk (a size-derived index
    would repeat and duplicate that chunk's random stream).
    """
    from ..ops.geometry import hs_dst, if_dst, trace_dst
    from ..tomography import bootstrap_core
    from ..tomography.state import make_generator

    acc = ChunkedAccumulator(path)
    state = getattr(tmg, "reconstructed_state", None)
    if state is None:
        state = tmg.point_estimate()
    dst_name = {hs_dst: "hs", trace_dst: "trace", if_dst: "if"}.get(tmg.dst, "hs")
    bloch = tmg._tensor(state.bloch)
    povm_matrix = tmg._tensor(tmg.povm_matrix)
    n_measurements = tmg._tensor(tmg.n_measurements)
    while acc.n_done < n_points:
        chunk_idx = acc.n_chunks
        n = min(chunk_size, n_points - acc.n_done)
        d = bootstrap_core.bootstrap_distances(
            make_generator(_chunk_seed(seed, chunk_idx), tmg.device),
            bloch,
            povm_matrix,
            n_measurements,
            n_points=n,
            method=method,
            dst=dst_name,
            max_iter=max_iter,
        )
        acc.append(d.cpu().numpy().astype(np.float64))
    return np.sort(acc.samples[:n_points])
