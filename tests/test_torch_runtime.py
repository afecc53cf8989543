"""The port's async peer runtime (``repro_torch.runtime`` and
``AsyncPrediction``) held against the JAX reference's, on the CPU.

* ``parse_faults`` / ``FaultSchedule`` equal the reference's on several
  specs (seeded straggler episodes, speeds), and malformed specs raise the
  reference's errors.
* The mailbox bills each transfer once.
* At ``staleness_bound=0`` on a clean schedule the port's async run equals
  its own synchronous ``PredictionExchange`` (periods 1 and 2).
* The port's ``AsyncScheduler`` against the reference's, both fed the
  reference's initial params (bridged in through ``_init_params`` /
  ``_join_params``) and its numpy batches: under a straggler, a preemption,
  a failure recovered from a checkpoint and an elastic join (mse and kl),
  and on a clean schedule with microbatch 2, the per-peer losses agree
  within 1e-5 relative and ``sim_time``, ``completion``, ``comm_events``,
  ``comm_bytes`` and the staleness stats are equal.
* The reference reads the port's per-peer histories and the params of its
  snapshots; the ``codist-async`` CLI runs on the CPU.
"""
import json
import os
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_snapshot_params as jax_load_snapshot_params
from repro.configs import CodistConfig as JCodistConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_reduced as jax_get_reduced
from repro.core.codistillation import init_stacked as jax_init_stacked
from repro.data import MarkovLM as JMarkovLM
from repro.data import make_lm_batch as jax_make_lm_batch
from repro.models import build_model as jax_build_model
from repro.runtime import AsyncScheduler as JAsyncScheduler
from repro.runtime import FaultSchedule as JFaultSchedule
from repro.runtime import Mailbox as JMailbox
from repro.runtime import parse_faults as jax_parse_faults
from repro.runtime import simulate_allreduce as jax_simulate_allreduce
from repro.train import AsyncPrediction as JAsyncPrediction
from repro.train.loop import History as JHistory
from repro_torch.checkpoint import (load_snapshot_params, params_from_jax,
                                    snapshot_meta)
from repro_torch.configs import CodistConfig, TrainConfig, get_reduced
from repro_torch.models import build_model
from repro_torch.runtime import (AsyncScheduler, FaultConfig, FaultSchedule,
                                 Mailbox, parse_faults, simulate_allreduce)
from repro_torch.runtime.mailbox import payload_bytes
from repro_torch.runtime.scheduler import join_seed
from repro_torch.train import (AsyncPrediction, History, stack_batches,
                               train_codist)

torch.set_num_threads(2)

ARCH = "qwen1.5-0.5b"
B, S = 4, 16
TINY = dict(num_layers=1, d_model=32, d_ff=64, vocab_size=64, num_heads=2,
            num_kv_heads=2, head_dim=16)
FAULTS = "straggler=1*3@0.5,preempt=1@2+3,fail=0@4"


def _close_rel(got, want, tol=1e-5):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.all(np.abs(g - w) <= tol * np.maximum(1.0, np.abs(w))), (g, w)


def _models():
    return (jax_build_model(replace(jax_get_reduced(ARCH), **TINY)),
            build_model(replace(get_reduced(ARCH), **TINY)))


def _ref_batches(steps, k=0):
    """The reference's Markov-LM batches as numpy; with k > 1 each leaf is
    reshaped to the microbatch layout (k, B/k, ...)."""
    task = JMarkovLM(vocab=64, seed=0)
    out = []
    for s in range(steps):
        b = {n: np.array(v) for n, v in
             jax_make_lm_batch(task, B, S, s, None, seed=0).items()}
        if k > 1:
            b = {n: v.reshape((k, B // k) + v.shape[1:]) for n, v in b.items()}
        out.append(b)
    return out


def _tc(steps, cls, **kw):
    kw = dict(dict(lr=1e-3, warmup_steps=2, optimizer="adamw", seed=0), **kw)
    return cls(total_steps=steps, **kw)


# ----------------------------------------------------------------------------
# the clock and the mailbox
# ----------------------------------------------------------------------------

SPECS = ["", "none", "straggler=1*4@0.25,preempt=0@3+5,fail=1@30,hetero=0.2",
         "speeds=1.0:2.5:0.5,straggler=2*3@0.5", FAULTS,
         "preempt=1@3+5,preempt=1@9+5", "straggler=0*2@0.5,straggler=1*2@0.5"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_schedule_equals_reference(spec):
    n = 3 if "speeds" in spec else 2
    mine, ref = parse_faults(spec, n, seed=7), jax_parse_faults(spec, n, seed=7)
    assert vars(mine) == vars(ref)
    joins = ((n, 2.5), (n + 1, 4.0))
    a = FaultSchedule(replace(mine, joins=joins), 40)
    b = JFaultSchedule(replace(ref, joins=joins), 40)
    np.testing.assert_array_equal(a.speeds, b.speeds)
    np.testing.assert_array_equal(a.mult, b.mult)
    assert (a.preempt, a.fail_at, a.joins) == (b.preempt, b.fail_at, b.joins)
    for p in range(n + 2):
        for s in range(41):
            assert a.duration(p, s) == b.duration(p, s)
            assert a.pause_after(p, s) == b.pause_after(p, s)


@pytest.mark.parametrize("spec", [
    "preempt=1@3+-5", "preempt=1@-3+5", "fail=1@-2", "straggler=1*-4@0.2",
    "straggler=1*4@1.5", "straggler=3*4@0.2", "fail=x@3", "melt=1",
    "speeds=1.0:0", "hetero=-0.5", "preempt=1@3+5,preempt=1@3+9",
    "fail=1@3,fail=1@9", "straggler=0*2@0.5,straggler=1*8@0.1"])
def test_malformed_fault_specs_raise_the_reference_errors(spec):
    with pytest.raises(ValueError) as mine:
        parse_faults(spec, 2)
    with pytest.raises(ValueError) as ref:
        jax_parse_faults(spec, 2)
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError):
        FaultConfig(n_peers=2, joins=((1, 5.0),))


def test_mailbox_bills_each_transfer_once():
    for mb, zeros in ((Mailbox(None), lambda: torch.zeros(4)),
                      (JMailbox(None), lambda: np.zeros(4, np.float32))):
        mb.post(1, 0, 0.0, {"vals": zeros()})            # 16 bytes
        mb.collect(0, 0, [1])
        mb.collect(0, 1, [1])   # keep-last re-read: the receiver holds it
        assert mb.bytes_delivered == 16
        assert mb.stats.accepted == 2   # staleness is measured per use
        mb.post(1, 1, 1.0, {"vals": zeros()})
        mb.collect(0, 2, [1])
        assert mb.bytes_delivered == 32
    wire = {"vals": torch.zeros(2, 3, dtype=torch.bfloat16),
            "idx": torch.zeros(2, 3, dtype=torch.int64)}
    assert payload_bytes(wire) == 2 * 3 * 2 + 2 * 3 * 8
    bounded = Mailbox(1)
    bounded.post(1, 0, 0.0, wire)
    assert [w for _, _, w in bounded.collect(0, 2, [1])] == [0.0]
    assert bounded.stats.dropped == 1 and bounded.bytes_delivered == 0


# ----------------------------------------------------------------------------
# staleness bound 0 == the port's synchronous prediction exchange
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("period", [1, 2])
def test_s0_reproduces_sync_prediction_exchange(period):
    _, model = _models()
    steps = 6
    tc = _tc(steps, TrainConfig)
    codist = CodistConfig(n_models=2, period=period)
    batches = [{n: torch.from_numpy(v) for n, v in b.items()}
               for b in _ref_batches(steps)]
    rep = AsyncScheduler(model, tc, codist, lambda s: batches[s],
                         FaultConfig(n_peers=2, seed=0), staleness_bound=0,
                         device="cpu").run()
    assert rep.staleness["staleness_max"] == 0.0
    assert rep.staleness["payloads_dropped"] == 0
    state, hist = train_codist(model, codist, tc,
                               lambda s: stack_batches([batches[s]] * 2),
                               log_every=1, device="cpu")
    for p in (0, 1):
        for key in ("task_loss", "distill_loss"):
            np.testing.assert_allclose(
                rep.histories[p].series(key),
                hist.series(f"{key}_per_model_{p}"), rtol=0, atol=5e-5)
        for a, b in zip(jax.tree_util.tree_leaves(rep.states[p].params),
                        jax.tree_util.tree_leaves(state.params[p])):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=0, atol=1e-4)


# ----------------------------------------------------------------------------
# the port's scheduler against the reference's
# ----------------------------------------------------------------------------

def _inject_reference_init(monkeypatch, jmodel, seed, n):
    """The port's scheduler starts from the reference's params: its
    initial stacked init and each joiner's fold_in init, bridged."""
    key = jax.random.key(seed)
    stacked = jax.tree.map(np.asarray, jax_init_stacked(jmodel.init, key, n))

    def init_params(self):
        return [params_from_jax(jax.tree.map(lambda a, i=i: a[i], stacked),
                                device="cpu") for i in range(n)]

    def join_params(self, pid):
        params = jmodel.init(jax.random.fold_in(key, 1000 + pid))
        return params_from_jax(jax.tree.map(np.asarray, params), device="cpu")

    monkeypatch.setattr(AsyncScheduler, "_init_params", init_params)
    monkeypatch.setattr(AsyncScheduler, "_join_params", join_params)


KEYS = ("step", "sim_time", "peer", "loss", "task_loss", "distill_loss",
        "alpha", "staleness", "peer_weight", "accuracy")

CASES = {
    "faults-mse": dict(distill="mse", faults=FAULTS, elastic=2.5, bound=1,
                       steps=8),
    "faults-kl-keeplast": dict(distill="kl", faults=FAULTS, elastic=2.5,
                               bound=None, steps=8),
    "clean-microbatch2": dict(distill="mse", faults="", elastic=0.0,
                              bound=0, steps=4, microbatch=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scheduler_matches_reference(case, monkeypatch, tmp_path):
    c = CASES[case]
    steps, k = c["steps"], c.get("microbatch", 0)
    jmodel, model = _models()
    _inject_reference_init(monkeypatch, jmodel, seed=0, n=2)
    batches = _ref_batches(steps, k)
    faults = parse_faults(c["faults"], 2, seed=0)
    jfaults = jax_parse_faults(c["faults"], 2, seed=0)
    if c["elastic"]:
        faults = replace(faults, joins=((2, c["elastic"]),))
        jfaults = replace(jfaults, joins=((2, c["elastic"]),))
    kw = dict(staleness_bound=c["bound"], checkpoint_every=2,
              recover_after=2.0, join_burn_in=2)
    ccfg = dict(n_models=2, distill_loss=c["distill"])
    mine = AsyncScheduler(
        model, _tc(steps, TrainConfig, microbatch=k), CodistConfig(**ccfg),
        lambda s: {n: torch.from_numpy(v) for n, v in batches[s].items()},
        faults, checkpoint_dir=str(tmp_path / "port"), device="cpu",
        **kw).run()
    ref = JAsyncScheduler(
        jmodel, _tc(steps, JTrainConfig, microbatch=k),
        JCodistConfig(**ccfg),
        lambda s: {n: jax.numpy.asarray(v) for n, v in batches[s].items()},
        jfaults, checkpoint_dir=str(tmp_path / "ref"), **kw).run()
    assert mine.sim_time == ref.sim_time
    assert mine.time_to_first == ref.time_to_first
    assert mine.completion == ref.completion
    assert mine.comm_events == ref.comm_events
    assert mine.comm_bytes == ref.comm_bytes > 0
    assert mine.staleness == ref.staleness
    assert sorted(mine.histories) == sorted(ref.histories)
    for p in ref.histories:
        got, want = mine.histories[p].records, ref.histories[p].records
        assert [r["step"] for r in got] == [r["step"] for r in want]
        for key in KEYS:
            _close_rel([r[key] for r in got], [r[key] for r in want])
    if c["faults"]:
        # peer 0 died at step 4, rejoined from its step-4 snapshot, and
        # every peer (the joiner too) finished
        assert sorted(mine.completion) == [0, 1, 2]
        assert mine.completion[0] > ref.histories[0].records[3]["sim_time"]
        assert mine.staleness["staleness_max"] > 0


def test_reference_reads_histories_and_snapshots(tmp_path):
    jmodel, model = _models()
    steps = 4
    batches = [{n: torch.from_numpy(v) for n, v in b.items()}
               for b in _ref_batches(steps)]
    rep = AsyncScheduler(model, _tc(steps, TrainConfig),
                         CodistConfig(n_models=2), lambda s: batches[s],
                         FaultConfig(n_peers=2, seed=0),
                         checkpoint_dir=str(tmp_path), checkpoint_every=2,
                         device="cpu").run()
    rep.save_histories(str(tmp_path))
    like = jmodel.init(jax.random.key(1))
    for p in (0, 1):
        h = JHistory.load(os.path.join(str(tmp_path), f"peer{p}.jsonl"))
        assert h.records == rep.histories[p].records
        assert History.load(os.path.join(str(tmp_path),
                                         f"peer{p}.jsonl")).records == h.records
        # the last snapshot is the final state (step 4)
        assert snapshot_meta(str(tmp_path), p) == {"step": 4}
        params = jax_load_snapshot_params(str(tmp_path), p, like)
        mine = load_snapshot_params(str(tmp_path), p, rep.states[p].params)
        for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
            got, final = mine, rep.states[p].params
            for q in path:
                got, final = got[q.key], final[q.key]
            np.testing.assert_array_equal(np.asarray(want), got.numpy())
            np.testing.assert_array_equal(got.numpy(), final.detach().numpy())


def test_simulate_allreduce_matches_reference(monkeypatch):
    """The barrier baseline on a straggler, preemption and failure
    schedule, both sides from the reference's params and batches."""
    jmodel, model = _models()
    steps = 4
    key_params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0)))

    class Injected(type(model)):
        def init(self, generator, device="cuda", weight_dtype=None):
            return params_from_jax(key_params, device=device)

    batches = _ref_batches(steps)
    spec = "straggler=1*4@0.5,preempt=0@1+3,fail=1@2"
    mine = simulate_allreduce(
        Injected(model.cfg), _tc(steps, TrainConfig),
        lambda s: {n: torch.from_numpy(v) for n, v in batches[s].items()},
        parse_faults(spec, 2), recover_after=5.0, device="cpu")
    ref = jax_simulate_allreduce(
        jmodel, _tc(steps, JTrainConfig),
        lambda s: {n: jax.numpy.asarray(v) for n, v in batches[s].items()},
        jax_parse_faults(spec, 2), recover_after=5.0)
    for field in ("sim_time", "completion", "comm_events", "comm_bytes"):
        assert getattr(mine, field) == getattr(ref, field), field
    for key in ("step", "sim_time", "loss", "task_loss"):
        _close_rel(mine.histories[0].series(key), ref.histories[0].series(key))


def test_async_prediction_comm_bytes_equals_reference():
    jmodel, model = _models()
    batch = _ref_batches(1)[0]
    for kw in ({}, {"compression": "bf16"}, {"compression": "topk", "topk": 8},
               {"compression": "subsample", "subsample": 4}):
        mine = AsyncPrediction(CodistConfig(**kw), n_slots=3).comm_bytes(
            model, None, {"batch": {n: torch.from_numpy(v)
                                    for n, v in batch.items()}})
        ref = JAsyncPrediction(JCodistConfig(**kw), n_slots=3).comm_bytes(
            jmodel, None, {"batch": batch})
        assert mine == ref > 0, kw


def test_join_seeds_are_distinct():
    seeds = {join_seed(s, p) for s in range(4) for p in range(2, 6)}
    assert len(seeds) == 16 and not seeds & set(range(4))


def test_cli_codist_async_on_cpu(capsys, tmp_path):
    from repro_torch.launch.train import main
    main(["--device", "cpu", "--mode", "codist-async", "--steps", "6",
          "--batch", "2", "--seq", "8", "--log-every", "1", "--faults",
          FAULTS, "--elastic", "2.5", "--staleness-bound", "1",
          "--join-burn-in", "2", "--checkpoint-every", "2",
          "--recover-after", "2", "--distill-loss", "kl",
          "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "nan" not in out.lower()
    summary = next(line for line in out.splitlines()
                   if line.startswith("sim_time="))
    assert "comm_events=" in summary and "dropped=" in summary
    assert "done: 6 steps x 3 peers" in out
    for p in range(3):
        hist = JHistory.load(str(tmp_path / f"peer{p}.jsonl"))
        assert hist.records and hist.last("step") == 5
        doc = json.loads((tmp_path / f"final_peer{p}.tree.json").read_text())
        assert doc["n_leaves"] > 0
        assert (tmp_path / "runtime_ckpt" / f"peer{p}.npz").exists()
