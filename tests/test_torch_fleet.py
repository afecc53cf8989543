"""The port's serving fleet held against the JAX reference, and the port's
hygiene.

* The port's ``FleetRouter`` (round_robin and least_loaded, fused attention
  on and off, 2 decode slots so joins and evictions happen mid-stream, 2
  peers with different weights) emits for every request exactly the tokens
  of the reference's dense ``Engine.generate`` on that request's peer's
  weights — the invariant of the reference's ``test_fleet.py``. The
  reference tokens are computed once per module.
* The workload generator is a verbatim copy: same arguments, same requests.
* The port imports nothing of ``jax`` or ``repro``; ``chip_smoke.py`` exits
  non-zero without a card; asking for CUDA without a card raises; the CLI
  runs on the CPU (hedging and the ensemble policy too) and writes its
  trace, metrics, alert log and postmortem bundles, which
  ``tools/trace_check.py`` passes; it refuses what the reference refuses
  (``--rules`` or ``--flight-recorder`` without ``--alerts``) and
  unported features with status 2.
* The hygiene scan covers every module of the port, ``obs/`` included.
"""
import ast
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.serve import Engine
from repro.serve.fleet.workload import generate_workload as jax_generate_workload
from repro_torch import resolve_device
from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.serve.fleet import (FleetConfig, FleetRouter, PagedCachePool,
                                     Request, SCENARIOS, generate_workload)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
LENS = [5, 9, 12, 7, 5, 9, 12, 7]
MAX_NEW = 5


class _ListWorkload:
    def __init__(self, requests, scenario="custom", seed=0):
        self.requests = requests
        self.scenario = scenario
        self.seed = seed


@pytest.fixture(scope="module")
def fleet_ref():
    """Reduced qwen2-7b, two peers with different weights, eight staggered
    requests, and the reference's ``Engine.generate`` tokens of every
    request on every peer (one engine, params swapped, so each prompt
    length traces once)."""
    cfg = jax_get_reduced("qwen2-7b")
    jm = jax_build_model(cfg)
    jparams = [jm.init(jax.random.key(i)) for i in range(2)]
    rng = np.random.default_rng(0)
    reqs = [Request(i, i * 1.0, tuple(int(x) for x in
                                      rng.integers(0, cfg.padded_vocab, size=n)),
                    MAX_NEW)
            for i, n in enumerate(LENS)]
    eng = Engine(jm, jparams[0])
    ref = []
    for p in jparams:
        eng.params = p
        out = {}
        for r in reqs:
            g = eng.generate({"tokens": jnp.asarray(r.prompt, jnp.int32)[None]},
                             r.max_new)
            out[r.rid] = np.asarray(g.tokens[0, r.prompt_len:]).tolist()
        ref.append(out)
    pm = build_model(get_reduced("qwen2-7b"))
    pparams = [params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
               for p in jparams]
    return pm, pparams, reqs, ref


def _run(fleet_ref, policy, fused, **fc_kw):
    pm, pparams, reqs, _ref = fleet_ref
    fc = FleetConfig(max_slots=2, block_size=4, num_blocks=32,
                     max_blocks_per_slot=8, max_prefills_per_step=1,
                     fused_attention=fused, **fc_kw)
    router = FleetRouter(pm, pparams, config=fc, policy=policy, device="cpu")
    rep = router.run(_ListWorkload(reqs), slo_ms=50.0)
    return router, rep


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("policy", ["round_robin", "least_loaded"])
def test_fleet_tokens_equal_reference_engine(fleet_ref, policy, fused):
    router, rep = _run(fleet_ref, policy, fused)
    _pm, _pp, reqs, ref = fleet_ref
    assert rep.completed == len(reqs) and rep.rejected == 0
    assert rep.lost_tokens == 0 and rep.duplicated_tokens == 0
    recs = router._primaries
    assert any(a.admitted_ms < b.admitted_ms < a.finished_ms
               for a in recs for b in recs if a is not b), \
        "no mid-stream join observed: churn not exercised"
    served = {id(r): i for i, e in enumerate(router.engines) for r in e.records}
    assert set(served.values()) == {0, 1}, "both peers must serve"
    for rec in recs:
        want = ref[served[id(rec)]][rec.request.rid]
        assert rec.tokens == want, (policy, fused, rec.request.rid)
    digest = hashlib.sha256()
    for rec in sorted(recs, key=lambda r: r.request.rid):
        digest.update(bytes(f"{rec.request.rid}:", "ascii"))
        digest.update(np.asarray(ref[served[id(rec)]][rec.request.rid],
                                 np.int32).tobytes())
    assert rep.stream_digest == digest.hexdigest()


def test_defrag_keeps_streams_and_null_block(fleet_ref):
    """Compacting the pool every tick moves blocks under live slots; the
    token streams do not change and block 0 stays all-zero."""
    base = _run(fleet_ref, "round_robin", True)[1]
    router, rep = _run(fleet_ref, "round_robin", True, defrag_every=1)
    assert rep.stream_digest == base.stream_digest
    for eng in router.engines:
        for pools in eng.pool.kv.values():
            for t in pools.values():
                assert not t[:, 0].any()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_workload_equals_reference(scenario):
    for kw in (dict(seed=3), dict(seed=9, max_prompt=16, max_new=8)):
        a = jax_generate_workload(scenario, 24, 512, **kw)
        b = generate_workload(scenario, 24, 512, **kw)
        assert [(r.rid, r.arrival_ms, r.prompt, r.max_new) for r in a.requests] \
            == [(r.rid, r.arrival_ms, r.prompt, r.max_new) for r in b.requests]


# ----------------------------------------------------------------------------
# hygiene
# ----------------------------------------------------------------------------

def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_reference():
    banned = {"jax", "jaxlib", "repro"}
    files = _port_files()
    # the scan covers the port's copy of every module of the reference's
    # obs layer (pure Python, imported nowhere from the reference)
    obs = {p.name for p in files if p.parent.name == "obs"}
    assert obs >= {p.name for p in (ROOT / "src" / "repro" / "obs").glob("*.py")}
    # and the launch layer's mesh, specs, rules, roofline, cost model and
    # dry run, with the activation hints
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in files
             if p.name != "chip_smoke.py"}
    assert names >= {"launch/mesh.py", "launch/specs.py", "launch/sharding.py",
                     "launch/roofline.py", "launch/cost.py",
                     "launch/dryrun.py", "models/sharding_hints.py"}
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in banned, f"{path}: imports {n}"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """In the checkout, and copied alone into an empty directory, the smoke
    script exits non-zero at its device check, before any model is built,
    and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "is_available() is False" in p.stderr


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    pm = build_model(get_reduced("qwen2-7b"))
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        pm.init(torch.Generator(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        PagedCachePool(pm, max_slots=2, block_size=4, num_blocks=8,
                       max_blocks_per_slot=2)


def test_cli_runs_on_cpu_and_refuses_unported_flags(capsys, tmp_path):
    """least_loaded, ``--hedge`` and ``--router ensemble`` serve on the
    CPU; a chaos run writes ``--trace``, ``--metrics``, ``--alerts`` and
    ``--flight-recorder`` files that ``tools/trace_check.py`` passes;
    ``--rules`` or ``--flight-recorder`` without ``--alerts``, a quantized
    ``--single`` and an unported arch exit 2."""
    from repro_torch.launch.serve import main
    for extra in (["--router", "least_loaded"], ["--hedge"],
                  ["--router", "ensemble"]):
        main(["--device", "cpu", "--arch", "qwen2-7b", "--requests", "4",
              "--max-new", "3", "--max-prompt", "8", "--slots", "2", *extra])
        out = capsys.readouterr().out
        assert "completed=4 rejected=0" in out and "stream digest" in out
    obs = {k: str(tmp_path / f"o.{k}") for k in ("trace", "metrics",
                                                 "alerts")}
    bundles = tmp_path / "pm"
    main(["--device", "cpu", "--arch", "qwen2-7b", "--requests", "6",
          "--max-new", "3", "--max-prompt", "8", "--slots", "2", "--faults",
          "preempt=1@2+40", "--trace", obs["trace"], "--metrics",
          obs["metrics"], "--alerts", obs["alerts"], "--flight-recorder",
          str(bundles)])
    out = capsys.readouterr().out
    assert "completed=6 rejected=0" in out and f"wrote {obs['trace']}" in out
    dumped = sorted(str(b) for b in bundles.iterdir())
    assert dumped and f"{len(dumped)} postmortem bundle(s)" in out
    sys.path.insert(0, str(ROOT / "tools"))
    import trace_check
    assert trace_check.main([*obs.values(), *dumped]) == 0
    for argv in (["--rules", "r.json"], ["--flight-recorder", "d"],
                 ["--arch", "whisper-tiny"],
                 ["--single", "--cache-dtype", "int8"]):
        with pytest.raises(SystemExit) as e:
            main(["--device", "cpu", *argv])
        assert e.value.code == 2, argv


@pytest.mark.parametrize("cache_dtype", ["int8", "fp8"])
def test_cli_serves_quantized_pools_on_cpu(capsys, cache_dtype):
    """``--cache-dtype int8|fp8`` serves the fleet through the quantized
    pools; the KV bytes count one fp32 scale per stored row."""
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--arch", "qwen2-7b", "--requests", "4",
          "--max-new", "3", "--max-prompt", "8", "--slots", "2",
          "--cache-dtype", cache_dtype])
    out = capsys.readouterr().out
    assert "completed=4 rejected=0" in out and "stream digest" in out
    cfg = get_reduced("qwen2-7b")
    per_token = cfg.num_layers * 2 * (cfg.num_kv_heads * cfg.resolved_head_dim + 4)
    kv_bytes = int(out.split("kv_bytes = ")[1].split()[0])
    assert kv_bytes > 0 and kv_bytes % per_token == 0
