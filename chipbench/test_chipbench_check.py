"""The check that decides ``correct``, driven on the CPU at a small size:
sound runs of the port pass it, and the control (the reference one
precision below, in the program's place) and planted faults of the timed
path fail it.

The run's look for a card is skipped (``run.run_cell`` on the CPU); the
rest of a run is the benchmark's own, at a configuration cut to 2,000 keys
and 256-event blocks.  Each cell's configuration runs through its own
loop and limits.
"""
import copy
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chipbench import bench, check  # noqa: E402
from chipbench import run as bench_run  # noqa: E402
from chipbench.reference import engine as ref  # noqa: E402

CELLS = {
    "iiot-800k.stream": {"chunk_blocks": 8},
    "fraud-7k.online": {"rate_per_s": 2000, "warmup_requests": 256},
}


def small_cell(name):
    cell = bench.cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["stream"].update(n_keys=2000, span_events=20000,
                                 base_spans=1)
    cell.config["engine"].update(batch=256)
    cell.traffic = dict(cell.traffic, **CELLS[name])
    return cell


def run_small(name, seed=3, seconds=0.6):
    return bench_run.run_cell(small_cell(name), seed, seconds, False,
                              torch.device("cpu"),
                              t_start=time.perf_counter())


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
    line, numbers = run_small(name)
    assert line["correct"], line["checks"]
    assert numbers["compared_events"] > 1000
    # every sampled key's stored row is compared, and most events' rows
    # come from a fold of their key's earlier blocks
    assert numbers["stored_keys"] == numbers["compared_keys"]
    assert numbers["folded_events"] > numbers["compared_events"] // 2


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_is_not_correct(name):
    cell = small_cell(name)
    outcome = bench.loop(cell.traffic["kind"]).run(
        cell, 5, 0.6, False, torch.device("cpu"), time.perf_counter())
    eng = ref.engine_from_config(cell.config)
    words = bench.rng_words(5)
    weights = {k: v.numpy() for k, v in outcome.weights.items()}
    low = check.control_sample(outcome.samples[0], eng, words, weights)
    numbers = check.numbers_of(low, eng, words, weights)
    correct, rows = check.judge(numbers, cell.limits)
    assert not correct, rows


def _keep_state(step):
    """A fast step that returns its state unchanged."""
    def broken(cfg, state, ev, rng, rng_entity=None):
        before = [x.clone() for x in state]
        state, info = step(cfg, state, ev, rng, rng_entity)
        for dst, src in zip(state, before):
            dst.copy_(src)
        return state, info
    return broken


def _drop_half(step):
    """A fast step that leaves out every other event of its block."""
    def broken(cfg, state, ev, rng, rng_entity=None):
        keep = torch.arange(ev.valid.shape[0]) % 2 == 0
        return step(cfg, state, ev._replace(valid=ev.valid & keep), rng,
                    rng_entity)
    return broken


def _alter_score(score):
    """The scorer's answers altered where they are produced."""
    def broken(params, features):
        return score(params, features) * 1.001
    return broken


@pytest.fixture
def fresh_drivers():
    """The frontend's per-config drivers are cached with the step they
    were built on: clear them around a planted fault."""
    from repro_torch.core import stream

    caches = (stream._block_runner, stream._sink_step,
              stream._residency_step)
    for c in caches:
        c.cache_clear()
    yield
    for c in caches:
        c.cache_clear()


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_planted_fault_is_not_correct(name, fault, monkeypatch,
                                      fresh_drivers):
    """Each fault a one-card cell can have (no exchange between cards
    exists to leave out)."""
    from repro_torch.core import engine
    from repro_torch.serving import pipeline

    if fault == "state_unchanged":
        monkeypatch.setattr(engine, "_step_fast",
                            _keep_state(engine._step_fast))
    elif fault == "half_batch":
        monkeypatch.setattr(engine, "_step_fast",
                            _drop_half(engine._step_fast))
    else:
        monkeypatch.setattr(pipeline, "score", _alter_score(pipeline.score))
    line, _ = run_small(name)
    assert not line["correct"], line["checks"]


PP = ref.Engine(taus=(60.0, 3600.0), h=3600.0, budget=0.1 / 3600.0,
                policy="pp", alpha=0.0, mu_tau_index=1, min_p=1e-6)
W = {"w1": np.ones((8, 2), np.float32), "b1": np.zeros(2, np.float32),
     "w2": np.ones((2, 1), np.float32), "b2": np.zeros(1, np.float32),
     "mu": np.zeros(8, np.float32), "sd": np.ones(8, np.float32)}


def _one_key(n, last, seed, eng=PP):
    """One key's events, in blocks of 4 but the last ``last`` together,
    and a program that is the float32 replay of them."""
    rng = np.random.default_rng(seed)
    sample = check.Sample(
        slot=np.zeros(n, np.int64), entity=np.full(n, 7, np.int64),
        q=rng.lognormal(3.0, 0.5, n).astype(np.float32),
        t=np.cumsum(rng.exponential(30.0, n)).astype(np.float32),
        block=np.minimum(np.arange(n) // 4, (n - last) // 4),
        keys=np.array([7]), z=None, p=None, lam=None, features=None,
        score=None, stored=[None])
    rep = ref.replay(eng, sample.slot, sample.entity, sample.q, sample.t,
                     sample.block, (0, 9), 1)
    return sample._replace(z=rep.z, p=rep.p, lam=rep.lam,
                           features=rep.features,
                           score=ref.score(W, rep.features)), rep


def test_tie_gap_reads_the_first_differing_decision():
    """A decision that differs from the reference's: ``tie_gap`` is
    ``|u - p| / p`` there, tiny at a near tie and large far from one."""
    n, last = 400, 40
    same, rep = _one_key(n, last, 0)
    sound = check.numbers_of(same, PP, (0, 9), W)
    assert sound["tie_gap"] == 0.0 and sound["differing_decisions"] == 0
    # flip one decision of the last block, whose events decide together
    gap = np.abs(rep.u.astype(np.float64) - rep.p) / rep.p
    tail = np.arange(n - last, n)
    for i in (tail[np.argmin(gap[tail])], tail[np.argmax(gap[tail])]):
        z = rep.z.copy()
        z[i] = ~z[i]
        got = check.numbers_of(same._replace(z=z), PP, (0, 9), W)
        assert got["tie_gap"] == pytest.approx(gap[i], rel=1e-4), i
        assert got["differing_decisions"] == 1
        # the block's rows are its start's: no reported feature moves
        assert got["feature_gap"] == sound["feature_gap"]


@pytest.mark.parametrize("policy", ["pp", "pp_vr"])
def test_step_judge_follows_a_long_history(policy):
    """A sound float32 run reads small gaps at every event of a long
    history; rows that drift late in it, or a decision flipped early, read
    large ones."""
    eng = PP._replace(policy=policy, alpha=1.0 if policy == "pp_vr" else 0.0,
                      budget=1.0 / 3600.0)
    n, T = 2000, len(PP.taus)
    same, rep = _one_key(n, 4, 2, eng)
    assert rep.z.sum() > 20
    got = check.numbers_of(same, eng, (0, 9), W)
    assert got["folded_events"] == n - 4
    assert got["decision_gap"] < 1e-5 and got["feature_gap"] < 1e-3
    assert got["tie_gap"] == 0.0
    # the counts drift by 5 % after event 1500
    feats = same.features.copy()
    feats[1500:, :T] *= 1.05
    got = check.numbers_of(same._replace(features=feats), eng, (0, 9), W)
    assert got["feature_gap"] > 1e-2
    # the key's first persisted event is left out
    z = rep.z.copy()
    z[np.flatnonzero(z)[0]] = False
    got = check.numbers_of(same._replace(z=z), eng, (0, 9), W)
    assert got["tie_gap"] > 1e-2 and got["feature_gap"] > 1e-2
