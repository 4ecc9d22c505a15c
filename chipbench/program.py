"""The system under test, built from a configuration file: the port's
scoring pipeline (engine and scorer) and its durable write-behind sink.

The benchmark makes the inputs: the scorer's weights from the seed (on the
card, with a ``torch.Generator`` there) and the counter RNG's key; the
program receives them as a user would hand them over.  From the program
the benchmark takes only the pipeline, the sink and their counters.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from chipbench import bench

# A traced run measures its window as an untraced run does, then profiles
# this many seconds more: enough blocks or dispatches for steady shares,
# few enough events to reduce.
TRACE_SECONDS = 2.0


@dataclasses.dataclass
class Outcome:
    metrics: dict               # end-to-end values by name
    counters: dict              # what the per-layer readers read
    trace: Optional[object]     # trace.TraceSummary of a traced run
    samples: list               # check.Sample of each stretch of the run
    numbers: dict               # further numbers compared (e.g. misordered)
    attempted: int
    failed: int
    memory_peak_bytes: int
    weights: dict               # the scorer's weights the run used
    device: Optional[dict] = None


def start(device, t_start: float) -> dict:
    """Import the program's modules that the loops use, then start the
    card: set-up's first two phases, timed from the process's start."""
    import repro_torch.features.spec  # noqa: F401
    import repro_torch.serving.frontend  # noqa: F401
    import repro_torch.serving.pipeline  # noqa: F401
    import repro_torch.streaming.durable  # noqa: F401
    import repro_torch.streaming.persistence  # noqa: F401

    phases = {"imports": time.perf_counter() - t_start}
    mark = time.perf_counter()
    if device.type == "cuda":
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    phases["card"] = time.perf_counter() - mark
    return phases


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> int:
    """Start a fresh peak; returns the peak so far."""
    if device.type != "cuda":
        return 0
    before = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return before


def peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def sample_keys(keys: np.ndarray, n_keys: int, seed: int, n_hot: int = 1,
                n_random: int = 2048) -> np.ndarray:
    """The keys ``correct`` follows: the ``n_hot`` busiest (the longest
    histories) and ``n_random`` more, drawn from the seed among the keys
    the stream holds.  Sorted."""
    counts = np.bincount(keys, minlength=n_keys)
    hot = np.argsort(-counts, kind="stable")[:n_hot]
    seen = np.setdiff1d(np.flatnonzero(counts), hot)
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 7])
    pick = rng.choice(seen, size=min(n_random, seen.size), replace=False)
    return np.sort(np.concatenate([hot, pick])).astype(np.int64)


def scorer_weights(seed: int, n_features: int, hidden: int, device) -> dict:
    """Seeded scorer weights, drawn on ``device`` in a few calls."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    draw = lambda *shape: torch.randn(shape, generator=gen, device=device)
    return {"w1": draw(n_features, hidden) / n_features ** 0.5,
            "b1": 0.1 * draw(hidden),
            "w2": draw(hidden, 1) / hidden ** 0.5,
            "b2": 0.1 * draw(1),
            "mu": 0.5 * draw(n_features),
            "sd": 0.5 + torch.rand(n_features, generator=gen, device=device)}


def profile_spec(config: dict):
    from repro_torch.features.spec import ProfileSpec

    e = config["engine"]
    h = float(e["kde_bandwidth_s"])
    return ProfileSpec(windows=tuple(float(x) for x in e["windows_s"]),
                       kde_bandwidth=h,
                       write_budget_per_min=float(e["lambda_h"]) / h * 60.0,
                       variance_alpha=float(e["variance_alpha"]),
                       policy=e["policy"])


def engine_overrides(config: dict) -> dict:
    e = config["engine"]
    return {"mu_tau_index": int(e["mu_tau_index"]),
            "min_p": float(e["min_p"])}


class HostCopies:
    """Device rows copied to the host in call order without a stall and
    without pinning memory in the window: two pinned buffers of ``rows``
    rows, made at set-up; each copy goes into the one not in flight, and
    lands in ordinary host memory once the copy two calls back is done."""

    def __init__(self, rows: int, cols: int, device):
        self.cuda = device.type == "cuda"
        self.buf = [torch.empty((rows, cols), pin_memory=self.cuda)
                    for _ in range(2)]
        self.pending = [None, None]
        self.out = []
        self.i = 0

    def put(self, x: torch.Tensor) -> None:
        i, n = self.i, x.shape[0]
        self._drain(i)
        self.buf[i][:n].copy_(x, non_blocking=self.cuda)
        done = None
        if self.cuda:
            done = torch.cuda.Event()
            done.record()
        self.pending[i] = (done, n)
        self.i = 1 - i

    def _drain(self, i: int) -> None:
        if self.pending[i] is not None:
            done, n = self.pending[i]
            if done is not None:
                done.synchronize()
            self.out.append(self.buf[i][:n].numpy().copy())
            self.pending[i] = None

    def result(self) -> np.ndarray:
        self._drain(self.i)            # the older copy first
        self._drain(1 - self.i)
        return np.concatenate(self.out) if self.out else \
            np.zeros((0, self.buf[0].shape[1]), np.float32)


class SystemUnderTest:
    """The pipeline with its scorer, and a durable sink in a fresh store
    directory under ``TMPDIR`` (removed again by ``close_and_read``)."""

    def __init__(self, config: dict, seed: int, device):
        from repro_torch.serving.pipeline import ScoringPipeline, ScorerParams

        self.config = config
        self.device = device
        n_keys = int(config["stream"]["n_keys"])
        spec = profile_spec(config)
        self.pipe = ScoringPipeline.build(spec, n_keys, mode=config["engine"]
                                          ["mode"], device=device,
                                          **engine_overrides(config))
        self.weights = scorer_weights(seed, spec.feature_dim,
                                      int(config["scorer"]["hidden"]), device)
        self.pipe.scorer = ScorerParams(**self.weights)
        self.rng = bench.rng_words(seed)
        self.store_dir = tempfile.mkdtemp(prefix="chipbench-store-")
        self.sink = self.make_sink(self.store_dir)

    def _store_kw(self) -> dict:
        st = self.config["store"]
        return {"compaction": st["compaction"],
                "compact_threshold_bytes": int(st["compact_threshold_bytes"])}

    def make_sink(self, store_dir: str):
        from repro_torch.streaming.persistence import WriteBehindSink

        st = self.config["store"]
        if st["backend"] != "durable":
            raise ValueError("the benchmark's stores are durable")
        return WriteBehindSink(self.pipe.engine.cfg,
                               n_partitions=int(st["partitions"]),
                               backend="durable", store_dir=store_dir,
                               store_kw=self._store_kw(), device=self.device)

    def close_and_read(self, keys: np.ndarray) -> list:
        """Close the sink (its final group commit), reopen the stores from
        the directory as a restart would, and read each key's row (None
        where absent); then remove the directory."""
        from repro_torch.streaming.durable import open_partition_stores

        self.sink.close()
        n = int(self.config["store"]["partitions"])
        stores = open_partition_stores(self.store_dir, n, **self._store_kw())
        try:
            part = keys % n
            rows = [None] * keys.size
            for p in range(n):
                idx = np.flatnonzero(part == p)
                for i, raw in zip(idx, stores[p].multi_get(keys[idx])):
                    rows[int(i)] = None if raw is None else bytes(raw)
        finally:
            for s in stores:
                s.close()
            shutil.rmtree(self.store_dir, ignore_errors=True)
        return rows


def written_bytes() -> int:
    """Bytes this process has handed to ``write`` calls, all threads
    (``wchar`` of ``/proc/self/io``), as the kernel counts them.  In the
    window only the stores write, so its growth there is the bytes they
    wrote: their write-ahead log, segments and indexes."""
    with open("/proc/self/io") as f:
        for line in f:
            if line.startswith("wchar:"):
                return int(line.split()[1])
    raise RuntimeError("/proc/self/io has no wchar: cannot count the "
                       "bytes written")


def store_counted_bytes(sink) -> int:
    """WAL, segment and index bytes the sink's stores count themselves
    (reported beside the kernel's count, never in its place)."""
    return sum(s.durable.wal_bytes + s.durable.seg_bytes
               + s.durable.seg_index_bytes for s in sink.stores)
