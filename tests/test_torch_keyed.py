"""repro_torch's keyed fused pass against the JAX composition it replaces.

The JAX package computes a step's decisions as three pieces: the counter-RNG
uniforms (``repro.core.thinning.uniform_for_events``), the row gather
(``repro.core.engine._gather_rows``) and the fused pass
(``repro.kernels.ops.thinning_rmw``); in exact mode the rows then go back
through conflict-free ``.at[].set(mode="drop")`` scatters.  The port's
``ops.thinning_rmw_keyed`` does all of it in one call (one launch on the
card).  On the CPU its plain version is held here *bitwise* to that
composition with the jnp reference body, in both modes, and to the Pallas
body in interpret mode at ``test_kernels.py``'s own tolerance (that body
uses the hardware ``exp``).  The CUDA kernel is held bitwise to the plain
version in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.core as jcore                                   # noqa: E402
from repro.core import engine as jengine                     # noqa: E402
from repro.core import thinning as jthin                     # noqa: E402
from repro.kernels import ops as jops                        # noqa: E402
from repro_torch.core import ProfileState                    # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.kernels import ref                          # noqa: E402
from repro_torch.kernels import thinning_rmw as trmw          # noqa: E402
from test_torch_cuda import keyed_inputs, keyed_lanes        # noqa: E402

POLICIES = ["pp", "pp_vr", "full", "fixed", "unfiltered"]
N, L = 1000, 96
SEED = 11


def _kw(policy, T):
    return dict(h=3600.0, budget=0.001, alpha=1.5, policy=policy,
                fixed_rate=0.3, mu_tau_index=min(2, T - 1))


def _case(T, policy, **gen):
    return keyed_inputs(np.random.default_rng([T, POLICIES.index(policy)]),
                        N, L, T, **gen)


def _port_state(table):
    return ProfileState(*(torch.tensor(x) for x in table))


def _jax_state(table):
    return jcore.ProfileState(*(jnp.asarray(x) for x in table))


def _jax_rows(taus, jstate, key, ent, q, t, active, use_pallas, kw):
    """The JAX engine's decision inputs: masked keys and entities, the
    threefry uniforms, the gathered rows; then its fused pass."""
    rng = jax.random.PRNGKey(SEED)
    key = jnp.where(active, jnp.asarray(key.astype(np.int32)), 0)
    ent = jnp.where(active, jnp.asarray(ent.astype(np.uint32)), 0)
    u = jthin.uniform_for_events(rng, ent, jthin.time_bits(jnp.asarray(t)))
    last_t, v_f, agg, v_full, last_t_full = jengine._gather_rows(jstate, key)
    extra = dict(block_b=64) if use_pallas == "interpret" else {}
    return key, jops.thinning_rmw(
        jnp.asarray(taus), last_t, v_f, agg, jnp.asarray(q), jnp.asarray(t),
        u, active.astype(jnp.float32), v_full, last_t_full,
        use_pallas=use_pallas, **extra, **kw)


def _bitwise(got, want, name):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                  err_msg=name)


@pytest.mark.parametrize("T", [2, 3, 6])
@pytest.mark.parametrize("policy", POLICIES)
def test_keyed_decisions_bitwise_vs_jax(T, policy):
    """Decision only: duplicate keys, key N - 1, -inf and NaN times,
    invalid events, an RNG entity other than the key at or above 2^31
    (even T) and the key itself (odd T)."""
    (taus, *table), (key, ent, q, t, valid) = _case(T, policy,
                                                    big_ent=T % 2 == 0)
    kw = _kw(policy, T)
    _, want = _jax_rows(taus, _jax_state(table), key, ent, q, t,
                        jnp.asarray(valid), False, kw)
    state = _port_state(table)
    launches = trmw.keyed_launches
    got = ops.thinning_rmw_keyed(
        torch.tensor(taus), state, torch.tensor(key), torch.tensor(q),
        torch.tensor(t), torch.tensor(valid), np.asarray(
            jax.random.PRNGKey(SEED)), torch.tensor(ent), **kw)
    assert trmw.keyed_launches == launches        # CPU tensors never launch
    for g, w, name in zip(got, (want[3], want[4], want[5], want[6]),
                          ("z", "p", "features", "lam")):
        _bitwise(g, w, name)
    for g, w, name in zip(state, table, ProfileState._fields):
        _bitwise(g, w, name)                      # decision only: untouched


@pytest.mark.parametrize("policy", POLICIES)
def test_keyed_decisions_vs_pallas_interpret(policy):
    T = 6
    (taus, *table), (key, ent, q, t, valid) = _case(T, policy)
    kw = _kw(policy, T)
    _, want = _jax_rows(taus, _jax_state(table), key, ent, q, t,
                        jnp.asarray(valid), "interpret", kw)
    got = ops.thinning_rmw_keyed(
        torch.tensor(taus), _port_state(table), torch.tensor(key),
        torch.tensor(q), torch.tensor(t), torch.tensor(valid),
        np.asarray(jax.random.PRNGKey(SEED)), **kw)
    for g, w, name in zip(got, (want[3], want[4], want[5], want[6]),
                          ("z", "p", "features", "lam")):
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(w, np.float32), rtol=2e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("T", [2, 3, 6])
@pytest.mark.parametrize("policy", POLICIES)
def test_keyed_write_back_bitwise_vs_jax_exact_chunk(T, policy):
    """Write-back: one exact-mode chunk of the JAX engine (its compact
    schedule's chunk body: gather, fused pass, drop-scatters of the
    persisted columns where z and the control column where active, the
    outputs to their lanes) against the port's one call.  The chunk has
    empty slots, invalid events on key 0 and a valid event on key 0."""
    (taus, *table), (key, ent, q, t, valid) = _case(
        T, policy, distinct=True, big_ent=T % 2 == 0)
    lanes = keyed_lanes(np.random.default_rng(T), L)
    kw = _kw(policy, T)
    js = _jax_state(table)
    jl = jnp.asarray(lanes)
    lane = jnp.where(jl < L, jl, 0)
    active = (jl < L) & jnp.asarray(valid)[lane]
    at = np.asarray(lane)
    jkey, res = _jax_rows(taus, js, key[at], ent[at], q[at], t[at], active,
                          False, kw)
    (_, new_v_f, new_agg, z, p, feats, lam, new_v_full, _) = res
    t_lane = jnp.asarray(t)[lane]
    data_key = jnp.where(z, jkey, N)
    ctrl_key = jnp.where(active, jkey, N)
    js = js._replace(
        agg=js.agg.at[data_key].set(new_agg.reshape(-1, T, 3), mode="drop"),
        v_f=js.v_f.at[data_key].set(new_v_f, mode="drop"),
        last_t=js.last_t.at[data_key].set(t_lane, mode="drop"),
        v_full=js.v_full.at[ctrl_key].set(new_v_full, mode="drop"),
        last_t_full=js.last_t_full.at[ctrl_key].set(t_lane, mode="drop"))
    out_lane = jnp.where(active, lane, L)
    init = (jnp.zeros(L, bool), jnp.full(L, -1.0), jnp.full((L, 4 * T), -1.0),
            jnp.full(L, -1.0))
    want_out = [o.at[out_lane].set(v, mode="drop")
                for o, v in zip(init, (z, p, feats, lam))]

    state = _port_state(table)
    out = (torch.zeros(L, dtype=torch.bool), torch.full((L,), -1.0),
           torch.full((L, 4 * T), -1.0), torch.full((L,), -1.0))
    got = ops.thinning_rmw_keyed(
        torch.tensor(taus), state, torch.tensor(key), torch.tensor(q),
        torch.tensor(t), torch.tensor(valid),
        np.asarray(jax.random.PRNGKey(SEED)), torch.tensor(ent),
        write_back=True, lanes=torch.tensor(lanes), out=out, **kw)
    assert got is out
    assert bool(out[0].any())                     # something was written
    for g, w, name in zip(out, want_out, ("z", "p", "features", "lam")):
        _bitwise(g, w, name)
    for g, w, name in zip(state, js, ProfileState._fields):
        _bitwise(g, w, name)


def test_keyed_write_back_identity_lanes_is_a_masked_round():
    """Without ``lanes`` row i is event i: the masked schedule's round."""
    T, policy = 3, "pp"
    (taus, *table), (key, ent, q, t, valid) = _case(T, policy, distinct=True)
    kw = _kw(policy, T)
    args = (torch.tensor(taus), None, torch.tensor(key), torch.tensor(q),
            torch.tensor(t), torch.tensor(valid), (0, 3))
    outs = []
    for lanes in (None, torch.arange(L)):
        state = _port_state(table)
        out = (torch.zeros(L, dtype=torch.bool), torch.zeros(L),
               torch.zeros(L, 4 * T), torch.zeros(L))
        ops.thinning_rmw_keyed(args[0], state, *args[2:], write_back=True,
                               lanes=lanes, out=out, **kw)
        outs.append(list(out) + list(state))
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_keyed_entry_checks_its_mode():
    T = 2
    (taus, *table), (key, ent, q, t, valid) = _case(T, "pp")
    args = (torch.tensor(taus), _port_state(table), torch.tensor(key),
            torch.tensor(q), torch.tensor(t), torch.tensor(valid), (0, 1))
    with pytest.raises(ValueError, match="needs out"):
        ops.thinning_rmw_keyed(*args, write_back=True, h=600.0, budget=0.1)
    with pytest.raises(ValueError, match="write_back=True"):
        ops.thinning_rmw_keyed(*args, lanes=torch.arange(L), h=600.0,
                               budget=0.1)
    with pytest.raises(ValueError, match="unknown policy"):
        ops.thinning_rmw_keyed(*args, h=600.0, budget=0.1, policy="nope")
    with pytest.raises(ValueError, match="CUDA tensors"):
        trmw.thinning_rmw_keyed_cuda(*args, h=600.0, budget=0.1)


def test_gather_rows_matches_jax():
    (_, *table), (key, _, _, _, _) = _case(3, "pp")
    want = jengine._gather_rows(_jax_state(table),
                                jnp.asarray(key.astype(np.int32)))
    got = ref.gather_rows(_port_state(table), torch.tensor(key))
    for g, w, name in zip(got, want, ("last_t", "v_f", "agg", "v_full",
                                      "last_t_full")):
        _bitwise(g, w, name)
