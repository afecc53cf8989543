"""The port's codistilled-fleet router held against the JAX reference's
``FleetRouter`` on the CPU: the ensemble policy and canaries, weight refresh
from snapshots, and chaos serving with the router's defenses.

Each case runs the reference's router and the port's on the same bridged
weights and the same workload (the reference ``test_fleet.py``'s tiny model,
requests and fault schedules; those cases are green on the project's test
run) and compares the ``FleetReport``s field by field: every count,
simulated time and the stream digest exactly, the canary's mse (prefill
logits of two frameworks) within 1e-5 relative. The reference's Pallas
scatters do not trace on every installed JAX (``pl.load``), so it runs on
their jnp oracles, swapped in by ``monkeypatch``; nothing of the JAX
package changes.

Also: the serve CLI runs ``--speculative``, ``--router ensemble
--canary-every 2`` and ``--faults ... --hedge`` on the CPU to a report with
nothing lost or duplicated.
"""
import json
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.io import save_snapshot as jax_save_snapshot
from repro.configs import get_reduced as jax_get_reduced
from repro.kernels import paged_cache as jax_paged_cache
from repro.models import build_model as jax_build_model
from repro.runtime import FaultConfig as JaxFaultConfig
from repro.serve.fleet import ChaosConfig as JaxChaosConfig
from repro.serve.fleet import FleetConfig as JaxFleetConfig
from repro.serve.fleet import FleetDefense as JaxFleetDefense
from repro.serve.fleet import FleetRouter as JaxFleetRouter
from repro.serve.fleet import model_exec as jax_model_exec
from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.runtime import FaultConfig
from repro_torch.serve.fleet import (ChaosConfig, FleetConfig, FleetDefense,
                                     FleetRouter, Request)
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

FLOAT_FIELDS = ("mean_mse", "max_mse")


def _tiny_cfg(get):
    return replace(get("qwen1.5-0.5b"), num_layers=2, d_model=64, d_ff=128,
                   vocab_size=64, num_heads=2, num_kv_heads=2, head_dim=32)


class _ListWorkload:
    def __init__(self, requests, scenario="custom", seed=0):
        self.requests = requests
        self.scenario = scenario
        self.seed = seed


def _requests(vocab, lens, max_new=5, gap_ms=1.0, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(i, i * gap_ms, tuple(int(x) for x in
                                         rng.integers(0, vocab, size=n)),
                    max_new)
            for i, n in enumerate(lens)]


@pytest.fixture(scope="module")
def fleet():
    """The tiny model on both sides and three sets of bridged weights."""
    jm = jax_build_model(_tiny_cfg(jax_get_reduced))
    jps = [jm.init(jax.random.key(i)) for i in range(3)]
    pm = build_model(_tiny_cfg(get_reduced))
    pps = [params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
           for p in jps]
    return jm, jps, pm, pps


@pytest.fixture
def oracle_scatters(monkeypatch):
    """The reference fleet on its scatters' jnp oracles."""
    monkeypatch.setattr(jax_model_exec, "paged_scatter",
                        jax_paged_cache.paged_scatter_ref)
    monkeypatch.setattr(jax_model_exec, "paged_scatter_quant",
                        jax_paged_cache.paged_scatter_quant_ref)


def _same(a, b) -> bool:
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


def _fc(cls, **kw):
    base = dict(max_slots=2, block_size=4, num_blocks=32,
                max_blocks_per_slot=8, max_queue=32)
    base.update(kw)
    return cls(**base)


def _both(fleet, peers, workload, *, fc=None, chaos=None, defense=None,
          **kw):
    """The reference's and the port's routers over the same weights (peer
    indices into the fixture's three) and workload; returns both routers
    and both reports as dicts."""
    jm, jps, pm, pps = fleet
    fc = fc or {}
    jkw, pkw = dict(kw), dict(kw)
    if chaos is not None:
        faults, ckw = chaos
        jkw["chaos"] = JaxChaosConfig(JaxFaultConfig(**faults), **ckw)
        pkw["chaos"] = ChaosConfig(FaultConfig(**faults), **ckw)
    if defense is not None:
        jkw["defense"] = JaxFleetDefense(**defense)
        pkw["defense"] = FleetDefense(**defense)
    ref = JaxFleetRouter(jm, [jps[i] for i in peers],
                         config=_fc(JaxFleetConfig, **fc), **jkw)
    mine = FleetRouter(pm, [pps[i] for i in peers],
                       config=_fc(FleetConfig, **fc), device="cpu", **pkw)
    return ref, mine, ref.run(workload).to_dict(), mine.run(workload).to_dict()


def _assert_reports_equal(want, got):
    assert set(want) == set(got)
    for key, w in want.items():
        g = got[key]
        if key == "canary":
            assert set(w) == set(g)
            for ck, cw in w.items():
                if ck in FLOAT_FIELDS:
                    assert g[ck] == pytest.approx(cw, rel=1e-5, abs=1e-9), ck
                else:
                    assert g[ck] == cw, ck
        else:
            assert g == w, (key, w, g)


# ----------------------------------------------------------------------------
# ensemble and canaries
# ----------------------------------------------------------------------------

def test_ensemble_report_equals_reference(fleet, oracle_scatters):
    """Every request on all three peers: the primary rotates, the two
    shadows feed the agreement signal (12 canary pairs)."""
    _jm, _jps, pm, _pps = fleet
    wl = _ListWorkload(_requests(pm.cfg.padded_vocab, [6] * 6, max_new=4))
    ref, mine, want, got = _both(fleet, [0, 1, 2], wl, policy="ensemble",
                                 fc=dict(max_blocks_per_slot=4))
    _assert_reports_equal(want, got)
    assert got["completed"] == 6 and got["canary"]["count"] == 12
    assert got["canary"]["mean_mse"] > 0
    assert all(len(e.records) == 6 for e in mine.engines)


@pytest.mark.parametrize("peers", [[0, 0], [0, 1]], ids=["identical", "two"])
def test_canary_report_equals_reference(fleet, oracle_scatters, peers):
    """Every second request shadowed on the next peer: identical peers
    agree exactly (mse 0, token agreement 1); different peers' divergence
    equals the reference's."""
    _jm, _jps, pm, _pps = fleet
    wl = _ListWorkload(_requests(pm.cfg.padded_vocab, [6, 6, 6, 6],
                                 max_new=4))
    _ref, _mine, want, got = _both(fleet, peers, wl, canary_every=2,
                                   fc=dict(max_blocks_per_slot=4))
    _assert_reports_equal(want, got)
    assert got["canary"]["count"] == 2
    if peers == [0, 0]:
        assert got["canary"]["mean_mse"] == 0.0
        assert got["canary"]["token_agreement"] == 1.0


# ----------------------------------------------------------------------------
# weight refresh: keep-last + staleness bound
# ----------------------------------------------------------------------------

def test_weight_refresh_equals_reference(fleet, tmp_path):
    """Snapshots the reference wrote: peer 0 at step 10, peer 1 at step 1
    (9 behind the newest, past the bound of 5: dropped); an older snapshot
    does not roll peer 0 back; a newer one of peer 1 is adopted. Counts,
    versions, billed bytes and the adopted weights equal the reference's."""
    jm, jps, pm, pps = fleet
    snap = str(tmp_path / "snaps")
    jax_save_snapshot(snap, 0, {"params": jps[1]}, meta={"step": 10})
    jax_save_snapshot(snap, 1, {"params": jps[2]}, meta={"step": 1})
    kw = dict(snapshot_dir=snap, staleness_bound=5)
    ref = JaxFleetRouter(jm, [jps[0], jps[0]],
                         config=_fc(JaxFleetConfig, max_slots=1), **kw)
    mine = FleetRouter(pm, [pps[0], pps[0]], config=_fc(FleetConfig,
                                                        max_slots=1),
                       device="cpu", **kw)

    def state(r):
        return (r.refreshes, r.refreshes_dropped_stale, r.refresh_bytes,
                [e.weights_version for e in r.engines])

    assert ref.refresh_now() == mine.refresh_now() == 1
    assert state(mine) == state(ref) == (1, 1, state(ref)[2], [10, -1])
    assert _same(mine.engines[0].params, pps[1])
    jax_save_snapshot(snap, 0, {"params": jps[0]}, meta={"step": 7})
    assert ref.refresh_now() == mine.refresh_now() == 0
    jax_save_snapshot(snap, 1, {"params": jps[2]}, meta={"step": 9})
    assert ref.refresh_now() == mine.refresh_now() == 1
    assert state(mine) == state(ref)
    assert [e.weights_version for e in mine.engines] == [10, 9]
    assert mine.refresh_bytes > 0
    assert _same(mine.engines[1].params, pps[2])


def test_periodic_refresh_during_a_run_equals_reference(fleet, oracle_scatters,
                                                        tmp_path):
    """``refresh_every_ms`` polls at request arrivals during the run: both
    peers adopt their snapshot (billed once each) and then serve from it;
    the report equals the reference's."""
    jm, jps, pm, _pps = fleet
    snap = str(tmp_path / "snaps")
    for i in range(2):
        jax_save_snapshot(snap, i, {"params": jps[2 - i]}, meta={"step": 3})
    wl = _ListWorkload(_requests(pm.cfg.padded_vocab, [5, 9, 12, 7] * 2,
                                 gap_ms=4.0))
    _ref, mine, want, got = _both(fleet, [0, 1], wl, snapshot_dir=snap,
                                  refresh_every_ms=10.0)
    _assert_reports_equal(want, got)
    assert got["refreshes"] == 2 and got["refresh_bytes"] > 0
    assert [e.weights_version for e in mine.engines] == [3, 3]


# ----------------------------------------------------------------------------
# chaos: seeded faults on the decode-tick clock + the router defenses
# ----------------------------------------------------------------------------

def test_preemption_migration_equals_reference(fleet, oracle_scatters):
    """Peer 1 preempted mid-run; the defended router migrates its in-flight
    work: nothing lost or duplicated, the streams equal a clean run's, and
    the report equals the reference's."""
    _jm, _jps, pm, pps = fleet
    wl = _ListWorkload(_requests(pm.cfg.padded_vocab, [5, 9, 12, 7] * 4,
                                 gap_ms=4.0))
    _ref, _mine, want, got = _both(
        fleet, [0, 0], wl,
        chaos=(dict(n_peers=2, seed=0, preemptions=((1, 6, 150.0),)), {}),
        defense={})
    _assert_reports_equal(want, got)
    assert got["preemptions"] == 1 and got["migrations"] >= 1
    assert got["lost_tokens"] == 0 and got["duplicated_tokens"] == 0
    clean = FleetRouter(pm, [pps[0], pps[0]], config=_fc(FleetConfig),
                        device="cpu").run(wl)
    assert got["stream_digest"] == clean.stream_digest


@pytest.mark.parametrize("defended", [True, False], ids=["defended",
                                                         "undefended"])
def test_failure_and_snapshot_recovery_equals_reference(fleet,
                                                        oracle_scatters,
                                                        tmp_path, defended):
    """Peer 1 dies at tick 8. Defended, with a snapshot and
    ``recover_after_ms``, its work migrates and it revives from the
    snapshot; undefended, its requests are stranded. Both reports equal the
    reference's."""
    jm, jps, pm, _pps = fleet
    snap = str(tmp_path / "snaps")
    jax_save_snapshot(snap, 1, {"params": jps[0]}, meta={"step": 7})
    wl = _ListWorkload(_requests(pm.cfg.padded_vocab, [5, 9, 12, 7] * 5,
                                 gap_ms=4.0))
    faults = dict(n_peers=2, seed=0, failures=((1, 8),))
    if defended:
        kw = dict(chaos=(faults, dict(recover_after_ms=30.0)), defense={},
                  snapshot_dir=snap)
    else:
        kw = dict(chaos=(faults, {}))
    _ref, mine, want, got = _both(fleet, [0, 0], wl, **kw)
    _assert_reports_equal(want, got)
    assert got["peers_died"] == 1
    if defended:
        assert got["peers_recovered"] == 1 and got["migrations"] >= 1
        assert got["completed"] == 20
        assert got["lost_tokens"] == 0 and got["duplicated_tokens"] == 0
        assert mine.engines[1].weights_version == 7
    else:
        assert got["migrations"] == 0 and got["completed"] < 20


def test_hedged_dispatch_equals_reference(fleet, oracle_scatters):
    """The slowest-decile requests run on two peers; the first to finish
    answers, the other is cancelled; every pair resolves."""
    _jm, _jps, pm, _pps = fleet
    wl = _ListWorkload(_requests(pm.cfg.padded_vocab,
                                 [5, 5, 5, 5, 12, 5, 5, 12, 5, 5],
                                 gap_ms=4.0))
    _ref, mine, want, got = _both(
        fleet, [0, 0], wl,
        defense=dict(hedging=True, hedge_quantile=0.7, hedge_min_samples=3))
    _assert_reports_equal(want, got)
    assert got["hedges"] >= 1 and got["completed"] == 10
    assert got["lost_tokens"] == 0 and got["duplicated_tokens"] == 0
    assert not mine._hedge_pairs
    assert all(not e.slots and not e.waiting for e in mine.engines)


def test_straggler_health_routing_equals_reference(fleet, oracle_scatters):
    """A 4x straggler over a fifth of its ticks: health routing steers
    arrivals off it (defended tail at most the undefended one); both runs'
    reports equal the reference's."""
    _jm, _jps, pm, _pps = fleet
    wl = _ListWorkload(_requests(pm.cfg.padded_vocab, [5, 9, 12, 7] * 6,
                                 gap_ms=2.0))
    chaos = (dict(n_peers=2, seed=0, straggler_peers=(1,),
                  straggler_factor=4.0, straggler_frac=0.2), {})
    _r, _m, want_u, got_u = _both(fleet, [0, 0], wl, chaos=chaos)
    _r, _m, want_d, got_d = _both(fleet, [0, 0], wl, chaos=chaos,
                                  defense=dict(migration=False))
    _assert_reports_equal(want_u, got_u)
    _assert_reports_equal(want_d, got_d)
    assert got_d["completed"] == 24
    assert got_d["p99_ttft_ms"] <= got_u["p99_ttft_ms"]


def test_degraded_admission_tightens_queue_bounds(fleet):
    """With half the peers gone the per-peer queue bound halves, and it
    recovers with the capacity (the reference's sequence of bounds)."""
    _jm, _jps, pm, pps = fleet
    router = FleetRouter(pm, [pps[0], pps[0]], config=_fc(FleetConfig,
                                                          max_queue=8),
                         defense=FleetDefense(), device="cpu")
    router._chaos_maintenance(0.0)
    assert all(e.max_queue_live == 8 for e in router.engines)
    router.engines[1].die()
    router._chaos_maintenance(1.0)
    assert all(e.max_queue_live == 4 for e in router.engines)
    router.engines[1].harvest()
    router.engines[1].revive(2.0)
    router._chaos_maintenance(3.0)
    assert all(e.max_queue_live == 8 for e in router.engines)


# ----------------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--speculative"],
    ["--router", "ensemble", "--canary-every", "2"],
    ["--faults", "preempt=1@6+120", "--hedge"],
], ids=["speculative", "ensemble-canary", "faults-hedge"])
def test_cli_codist_modes_run_on_cpu(capsys, tmp_path, argv):
    from repro_torch.launch.serve import main
    report = tmp_path / "r.json"
    main(["--device", "cpu", "--arch", "qwen2-7b", "--requests", "8",
          "--max-new", "4", "--max-prompt", "16", "--slots", "4",
          "--report", str(report), *argv])
    out = capsys.readouterr().out
    assert "lost_tokens=0 duplicated_tokens=0" in out
    rep = json.loads(report.read_text())
    assert rep["completed"] == 8 and rep["rejected"] == 0
    assert rep["lost_tokens"] == 0 and rep["duplicated_tokens"] == 0
    if "--speculative" in argv:
        assert rep["router"] == "speculative" and rep["spec_rounds"] > 0
    if "--canary-every" in argv:
        assert rep["canary"]["count"] == 8
    if "--faults" in argv:
        assert rep["preemptions"] == 1
