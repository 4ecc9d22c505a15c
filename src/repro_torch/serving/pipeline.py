"""End-to-end risk-scoring pipeline (the paper's Figure 8 architecture).

The counterpart of ``repro.serving.pipeline``: stream orchestration ->
feature aggregation engine (persistence-path control) -> stateless model
scoring.  Every event is scored; only a thinned subset triggers durable
profile writes.  The scorer is a small MLP over the profile feature vector
(§6.5 restricts features to persistence-derived aggregations only); its two
products are ``torch.matmul`` in float32 — callers comparing scores keep
TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``).

The open-loop serving frontend (``ScoringPipeline.serve``) is not ported
yet (ROADMAP.md queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.thinning import prng_key
from repro_torch.core.types import Event, resolve_device
from repro_torch.features.engine import ShardedFeatureEngine
from repro_torch.features.spec import ProfileSpec


class ScorerParams(NamedTuple):
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    # feature standardization (fit on train split)
    mu: torch.Tensor
    sd: torch.Tensor


def init_scorer(gen: torch.Generator, feature_dim: int, hidden: int = 64,
                device=None) -> ScorerParams:
    """Seeded scorer weights: normal draws from ``gen`` (made on the
    generator's device), scaled by fan-in, moved to ``device``."""
    dev = resolve_device(device)
    normal = lambda *shape: torch.randn(shape, generator=gen,
                                        device=gen.device).to(dev)
    zeros = lambda n: torch.zeros(n, device=dev)
    return ScorerParams(
        w1=normal(feature_dim, hidden) / feature_dim ** 0.5,
        b1=zeros(hidden),
        w2=normal(hidden, 1) / hidden ** 0.5,
        b2=zeros(1),
        mu=zeros(feature_dim),
        sd=torch.ones(feature_dim, device=dev))


def scorer_from_jax(params_np, device=None) -> ScorerParams:
    """The JAX package's ``ScorerParams`` (numpy leaves, e.g. ``jax.tree.
    map(np.asarray, params)``) as the port's, on ``device``."""
    dev = resolve_device(device)
    return ScorerParams(*(torch.tensor(np.asarray(x, np.float32), device=dev)
                          for x in params_np))


def score(params: ScorerParams, features: torch.Tensor) -> torch.Tensor:
    """[B, F] -> [B] anomaly logits."""
    x = (torch.log1p(features.abs()) * torch.sign(features) - params.mu) \
        / params.sd
    h = torch.relu(x @ params.w1 + params.b1)
    return (h @ params.w2 + params.b2)[:, 0]


def scorer_loss(params: ScorerParams, features, labels, pos_weight=20.0):
    logits = score(params, features)
    ll = F.logsigmoid(logits)
    nll = F.logsigmoid(-logits)
    w = torch.where(labels > 0, pos_weight, 1.0)
    return -torch.mean(w * torch.where(labels > 0, ll, nll))


@dataclasses.dataclass
class ScoringPipeline:
    """Feature engine + scorer behind one ``process_batch`` interface."""
    engine: ShardedFeatureEngine
    scorer: Optional[ScorerParams] = None

    @classmethod
    def build(cls, spec: ProfileSpec, num_entities: int, mesh=None,
              mode: str = "fast", device=None,
              **engine_overrides) -> "ScoringPipeline":
        eng = ShardedFeatureEngine(spec.engine_config(**engine_overrides),
                                   num_entities, mesh=mesh, mode=mode,
                                   device=device)
        return cls(engine=eng)

    def init(self, residency: Optional[int] = None):
        """Engine state: dense (one row per entity) or, with a
        ``residency`` budget, a bounded state of ``residency`` slots
        (see ``process_stream``)."""
        if residency is not None:
            return self.engine.init_resident_state(residency)
        return self.engine.init_state()

    def process_batch(self, state, ev: Event, rng, step_fn=None):
        """(1)-(5) of §5.1 for a micro-batch + scoring of every event.

        Returns (new_state, StepInfo, scores or None).
        """
        step_fn = step_fn or self.engine.make_step()
        state, info = step_fn(state, ev, rng)
        scores = None
        if self.scorer is not None:
            scores = score(self.scorer, info.features)
        return state, info, scores

    # ------------------------------------------------- durable fast path
    def make_sink(self, **kw):
        """Write-behind sink whose partitions mirror the engine layout."""
        return self.engine.make_sink(**kw)

    def process_stream(self, state, keys, qs, ts, *, rng=None,
                       batch_per_shard: int = 1024, sink=None,
                       collect_info: bool = True, residency=None,
                       sink_group: int = 4, pipeline_depth: int = 1):
        """Run a whole stream through the engine's block driver (the
        features every event is scored on; ``score`` them with the
        scorer).

        With ``sink`` the thinned rows are persisted write-behind while
        the stream computes (the paper's decoupling, end to end).
        ``residency`` bounds device state to a slot budget
        (``init(residency=...)`` builds the matching state): misses
        hydrate from the sink's stores, and scores are bit-identical to
        the dense engine for any budget (requires ``sink``).
        ``pipeline_depth`` as ``core.stream.run_stream``.
        """
        return self.engine.run_stream(state, keys, qs, ts, rng=rng,
                                      batch_per_shard=batch_per_shard,
                                      collect_info=collect_info, sink=sink,
                                      residency=residency,
                                      sink_group=sink_group,
                                      pipeline_depth=pipeline_depth)

    # --------------------------------------------------- online serving
    def serve(self, *args, **kwargs):
        """Open-loop serving through the admission queue and dynamic
        batcher of ``serving.frontend`` — not ported yet."""
        raise NotImplementedError(
            "ScoringPipeline.serve needs serving/frontend.py (VirtualClock, "
            "threaded admission, adaptive wait), which is not ported to "
            "repro_torch yet: ROADMAP.md queue 1 item 8; use "
            "process_stream")

    def restart_from(self, sink):
        """Rebuild engine state from the sink's durable stores: persisted
        feature columns are bit-exact to the lost in-memory state (exact
        mode), so post-restart scores equal pre-restart scores."""
        sink.flush()
        return self.engine.hydrate_state(sink.stores)

    def restart_from_dir(self, store_dir: str):
        """Rebuild engine state from an on-disk durable directory (the
        real restart: the stores are recovered from their WAL + segment
        files)."""
        return self.engine.hydrate_from_dir(store_dir)

    def score_cold(self, sink, keys, t):
        """Score entities straight from the sink's durable bytes (no dense
        state table; the sink's L2 tier is probed first), bit-identical to
        scoring a fully hydrated state."""
        sink.flush()
        feats = self.engine.materialize_cold(sink.stores, keys, t,
                                             l2_probe=sink.l2_probe)
        return score(self.scorer, feats) if self.scorer is not None \
            else feats


def run_restart_demo(spec: ProfileSpec, num_entities: int, keys, qs, ts,
                     *, mode: str = "exact", batch_per_shard: int = 512,
                     rng=None, residency: Optional[int] = None,
                     sink_group: int = 4, backend: str = "memory",
                     store_dir: Optional[str] = None,
                     store_kw: Optional[dict] = None, device=None,
                     **engine_overrides) -> dict:
    """End-to-end score -> persist -> restart -> score round trip.

    Streams events through a thinned pipeline with a write-behind sink,
    simulates a process loss (the in-memory state is discarded), and
    scores every key the stream touched at a later time from both the live
    and the recovered side.

    ``backend="memory"`` keeps the stores in-process and the "crash"
    discards only the engine state.  ``backend="durable"`` (with
    ``store_dir=``) closes the sink and its stores and recovers by
    reopening them from the directory (WAL replay included); the returned
    dict then carries ``recovery``, the stores' measured recovery counters
    summed over partitions.

    Dense (``residency=None``): recovery rebuilds the state table with
    ``hydrate_state``.  With a ``residency`` budget: the stream runs on a
    bounded slot state and recovery *is* cold-start hydration
    (``materialize_cold``); the "live" side is then a dense in-memory run
    of the same stream, so the pair pins bounded residency + crash +
    cold-start scoring against the dense engine.

    The scorer's weights come from ``torch.Generator().manual_seed(1)``.
    """
    pipe = ScoringPipeline.build(spec, num_entities, mode=mode,
                                 device=device, **engine_overrides)
    pipe.scorer = init_scorer(torch.Generator().manual_seed(1),
                              spec.feature_dim, device=pipe.engine.device)
    rng = prng_key(0) if rng is None else rng
    sink = pipe.make_sink(backend=backend, store_dir=store_dir,
                          **({"store_kw": store_kw} if store_kw else {}))
    state, info = pipe.process_stream(pipe.init(residency=residency), keys,
                                      qs, ts, rng=rng,
                                      batch_per_shard=batch_per_shard,
                                      sink=sink, residency=residency,
                                      sink_group=sink_group)
    stats = sink.flush()

    recovered_stores = recovery = None
    if backend == "durable":
        # a real crash boundary: final group-commit fsync, handles closed;
        # everything below this line reads only what is on disk
        sink.close()
        recovered_stores = pipe.engine.reopen_stores(store_dir,
                                                     **(store_kw or {}))
        recovery = {}
        for s in recovered_stores:
            for k, v in s.measured().items():
                recovery[k] = recovery.get(k, 0) + v

    t_score = float(np.max(ts)) + 1.0
    ents = np.unique(np.asarray(keys, np.int64))
    if residency is None:
        feats_live = pipe.engine.materialize(state, ents, t_score)
        scores_live = score(pipe.scorer, feats_live)
        del state                         # the crash: only stores survive
        if recovered_stores is not None:
            restored = pipe.engine.hydrate_state(recovered_stores)
        else:
            restored = pipe.restart_from(sink)
        feats_rec = pipe.engine.materialize(restored, ents, t_score)
        scores_rec = score(pipe.scorer, feats_rec)
    else:
        # "live" reference: the same stream on a dense in-memory engine
        # (no persistence) — decisions are residency-invariant, so its
        # state is what the bounded engine would hold at S = E
        ref = ScoringPipeline.build(spec, num_entities, mode=mode,
                                    device=device, **engine_overrides)
        ref.scorer = pipe.scorer
        ref_state, _ = ref.process_stream(ref.init(), keys, qs, ts, rng=rng,
                                          batch_per_shard=batch_per_shard,
                                          collect_info=False)
        scores_live = score(pipe.scorer,
                            ref.engine.materialize(ref_state, ents, t_score))
        del state, ref_state
        # crash: the bounded slot state is gone; recovery is a cold-start
        # hydration read of the scored keys straight from durable bytes
        if recovered_stores is not None:
            feats = pipe.engine.materialize_cold(recovered_stores, ents,
                                                 t_score)
            scores_rec = score(pipe.scorer, feats)
        else:
            scores_rec = pipe.score_cold(sink, ents, t_score)
    sink.close()
    if recovered_stores is not None:
        for s in recovered_stores:
            s.close()
    n = int(np.shape(keys)[0])
    writes = int(info.writes)
    return {
        "scores_live": scores_live.cpu().numpy(),
        "scores_recovered": scores_rec.cpu().numpy(),
        "events": n,
        "keys_scored": int(ents.size),
        "writes": writes,
        "write_pct": 100.0 * writes / max(n, 1),
        "sink": stats,
        "backend": backend,
        "recovery": recovery,
    }


def fit_standardization(params: ScorerParams, features: np.ndarray
                        ) -> ScorerParams:
    x = np.log1p(np.abs(features)) * np.sign(features)
    dev = params.mu.device
    return params._replace(
        mu=torch.tensor(x.mean(0), dtype=torch.float32, device=dev),
        sd=torch.tensor(x.std(0) + 1e-6, dtype=torch.float32, device=dev))


def recall_at_fpr(scores: np.ndarray, labels: np.ndarray,
                  fpr: float = 0.01) -> float:
    """Recall at a fixed false-positive rate (the paper's Table 5 metric)."""
    neg = scores[labels == 0]
    pos = scores[labels == 1]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    thr = np.quantile(neg, 1.0 - fpr)
    return float((pos > thr).mean())
