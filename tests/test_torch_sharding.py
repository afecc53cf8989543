"""The port's meshes, shape stand-ins, sharding rules and activation hints
(``repro_torch.launch.mesh`` / ``specs`` / ``sharding``,
``repro_torch.models.sharding_hints``) held against the JAX reference's.

* the device-free meshes: the production, codist and host meshes' axes,
  sizes and row-major device ids, ``pod_index_of_device`` against the
  reference's on a duck-typed mesh of device ids;
* the specs: every assigned arch x input shape, the meta stand-ins' shapes
  and dtypes equal the reference's ``jax.eval_shape`` results (train with
  n_stack 2 and microbatch 4, prefill, decode tokens, the cache, the
  params and the stacked params), leaf for leaf and path for path; nothing
  is allocated and the kernels refuse a meta tensor;
* the rules: every assigned arch at full size, the spec of every leaf of
  the stacked codist state (params and SGD moments) and of the single
  model's params equals the reference's ``PartitionSpec`` on (16, 16) and
  (2, 16, 16), with ``fsdp_axis`` "data" and None, ``moe_expert_axis``
  "data" and ``two_d_ffn``; the batch and cache specs for every arch x
  shape; ``local_shape`` divides each leaf;
* the hints: ``hint_spec`` equals the spec the reference's ``hint``
  applies (``jax.lax.with_sharding_constraint`` captured by monkeypatch)
  for every kind, including each fallback.

The reference's ``jax.eval_shape`` trees are built once per module.
"""
from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsh
from repro.launch import specs as jsp
from repro.models import build_model as jax_build_model
from repro.models import sharding_hints as jhints
from repro.optim import make_optimizer as jax_make_optimizer
from repro.train.state import CodistState as JCodistState
from repro.train.state import TrainState as JTrainState
from repro_torch import resolve_device
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.kernels import fused_cross_entropy, paged_scatter
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding as psh
from repro_torch.launch import specs as psp
from repro_torch.models import build_model
from repro_torch.models.sharding_hints import (activation_sharding,
                                               current_hint_spec, hint_spec)

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"fsdp": {}, "tp_only": {"fsdp_axis": None},
         "experts": {"moe_expert_axis": "data"}, "2d": {"two_d_ffn": True}}
DT = {jnp.dtype("bfloat16"): torch.bfloat16, jnp.dtype("float32"):
      torch.float32, jnp.dtype("int32"): torch.int32}


def _cfgs(arch):
    """The dry run's numerics: bf16 params and activations."""
    return (replace(jax_get_config(arch), dtype="bfloat16",
                    param_dtype="bfloat16"),
            replace(get_config(arch), dtype="bfloat16",
                    param_dtype="bfloat16"))


def _jflat(tree):
    return {jsh._path_str(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pflat(tree):
    return dict(psh.tree_flatten_with_path(tree))


@pytest.fixture(scope="module")
def trees():
    """arch -> the reference's and the port's stand-ins, built once."""
    out = {}
    j_init, _ = jax_make_optimizer("sgdm", dtype="bfloat16")
    for arch in ASSIGNED_ARCHS:
        jcfg, pcfg = _cfgs(arch)
        jm, pm = jax_build_model(jcfg), build_model(pcfg)
        jstack = jsp.stacked_params_specs(jm, 2)
        jparams = jsp.params_specs(jm)
        jstate = JCodistState(jstack, jax.eval_shape(j_init, jstack),
                              jax.ShapeDtypeStruct((), jnp.int32), None, None)
        jtrain = JTrainState(jparams, jax.eval_shape(j_init, jparams),
                             jax.ShapeDtypeStruct((), jnp.int32))
        out[arch] = SimpleNamespace(
            jcfg=jcfg, pcfg=pcfg, jm=jm, pm=pm, jparams=jparams,
            jstate=jstate, jtrain=jtrain,
            pparams=psp.params_specs(pm),
            pstate=psp.train_state_specs(pm, 2, "sgdm", torch.bfloat16),
            ptrain=psp.train_state_specs(pm, 0, "sgdm", torch.bfloat16))
    return out


def _same_shapes(jtree, ptree, what):
    j, p = _jflat(jtree), _pflat(ptree)
    assert set(j) == set(p), (what, sorted(set(j) ^ set(p))[:8])
    for path, x in j.items():
        y = p[path]
        assert y.is_meta, (what, path)
        assert tuple(y.shape) == tuple(x.shape), (what, path, y.shape, x.shape)
        assert y.dtype == DT[jnp.dtype(x.dtype)], (what, path, y.dtype,
                                                   x.dtype)


# ----------------------------------------------------------------------------
# meshes
# ----------------------------------------------------------------------------

def test_meshes_have_the_reference_axes_and_row_major_ids():
    prod = pmesh.make_production_mesh()
    multi = pmesh.make_production_mesh(multi_pod=True)
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert pmesh.mesh_chips(multi) == 512
    assert pmesh.make_codist_mesh().shape == {"pod": 2, "data": 8,
                                              "model": 16}
    assert pmesh.make_host_mesh().shape == {"pod": 2, "data": 2, "model": 2}
    assert (multi.devices == np.arange(512).reshape(2, 16, 16)).all()
    assert multi.groups("pod")[:2] == [[0, 256], [1, 257]]
    assert multi.groups("model")[0] == list(range(16))
    assert multi.groups(("pod", "data"))[0] == [16 * i for i in range(32)]
    for sizes, names in MESHES.values():
        am = jmesh.abstract_mesh(sizes, names)
        assert pmesh.abstract_mesh(sizes, names).shape == dict(am.shape)


@pytest.mark.parametrize("which", ["multi", "codist", "single"])
def test_pod_index_of_device_equals_the_reference(which):
    mesh = {"multi": pmesh.make_production_mesh(multi_pod=True),
            "codist": pmesh.make_codist_mesh(),
            "single": pmesh.make_production_mesh()}[which]
    devs = np.vectorize(lambda i: SimpleNamespace(id=int(i)),
                        otypes=[object])(mesh.devices)
    ref = SimpleNamespace(devices=devs, axis_names=mesh.axis_names)
    for d in range(0, mesh.size, 7):
        assert pmesh.pod_index_of_device(mesh, d) == \
            jmesh.pod_index_of_device(ref, d), (which, d)


# ----------------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_specs_equal_the_reference_eval_shape(trees, arch):
    t = trees[arch]
    _same_shapes(t.jparams, t.pparams, "params")
    _same_shapes(t.jstate, t.pstate, "codist state")
    _same_shapes(t.jtrain, t.ptrain, "train state")
    for name, shape in INPUT_SHAPES.items():
        js = J_SHAPES[name]
        for kw in ({}, {"n_stack": 2, "microbatch": 4}):
            if shape.kind != "train" and kw:
                continue
            _same_shapes(jsp.train_batch_specs(t.jcfg, js, **kw),
                         psp.train_batch_specs(t.pcfg, shape, **kw),
                         f"train batch {name} {kw}")
        _same_shapes(jsp.prefill_batch_specs(t.jcfg, js),
                     psp.prefill_batch_specs(t.pcfg, shape), "prefill")
        _same_shapes({"t": jsp.decode_token_specs(js)},
                     {"t": psp.decode_token_specs(shape)}, "decode tokens")
        if shape.kind == "decode":
            _same_shapes(jsp.cache_specs(t.jm, t.jcfg, js),
                         psp.cache_specs(t.pm, t.pcfg, shape), f"cache {name}")


def test_the_reference_spec_cases():
    """The reference's own cases (tests/test_dryrun_helpers.py)."""
    shape = INPUT_SHAPES["train_4k"]
    b = psp.train_batch_specs(get_config("qwen2-7b"), shape, n_stack=2,
                              microbatch=4)
    assert tuple(b["tokens"].shape) == (2, 4, 32, 4096)
    b = psp.train_batch_specs(get_config("internvl2-76b"), shape)
    assert tuple(b["patches"].shape) == (256, 256, 8192)
    assert b["tokens"].shape[1] + 256 == 4096
    b = psp.train_batch_specs(get_config("whisper-tiny"), shape)
    assert tuple(b["frames"].shape) == (256, 1500, 384)
    cfg = get_config("qwen1.5-0.5b")
    cache = psp.cache_specs(build_model(cfg), cfg, INPUT_SHAPES["decode_32k"])
    k = cache["sub0"]["k"]
    assert tuple(k.shape) == (24, 128, 32768, 16, 64)
    assert k.dtype == torch.bfloat16 and k.is_meta


def test_meta_allocates_nothing_and_the_kernels_refuse_it():
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("meta", meta=True).type == "meta"
    cfg = get_config("arctic-480b")      # ~960 GB in bf16
    params = psp.params_specs(build_model(cfg))
    leaves = [v for _, v in psh.tree_flatten_with_path(params)]
    assert leaves and all(v.is_meta for v in leaves)
    logits = torch.empty((4, 512), device="meta")
    labels = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fused_cross_entropy(logits, labels)
    pool = torch.empty((8, 16, 2, 32), device="meta")
    with pytest.raises(ValueError, match="meta"):
        paged_scatter(pool, torch.empty((4, 2, 32), device="meta"),
                      torch.empty((8,), dtype=torch.int32, device="meta"),
                      torch.empty((8,), dtype=torch.int32, device="meta"))


# ----------------------------------------------------------------------------
# rules
# ----------------------------------------------------------------------------

def _specs_equal(jtree, ptree, what):
    j, p = _jflat(jtree), _pflat(ptree)
    assert set(j) == set(p), (what, sorted(set(j) ^ set(p))[:8])
    bad = [(k, tuple(v.spec), tuple(p[k])) for k, v in j.items()
           if tuple(v.spec) != tuple(p[k])]
    assert not bad, (what, len(bad), bad[:4])
    return len(j)


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_state_rules_equal_the_reference_on_every_leaf(trees, arch,
                                                       mesh_name, rule):
    t = trees[arch]
    sizes, names = MESHES[mesh_name]
    jm, pm = jmesh.abstract_mesh(sizes, names), pmesh.abstract_mesh(sizes,
                                                                     names)
    kw = RULES[rule]
    n = _specs_equal(jsh.state_shardings(t.jstate, jm, stacked=True, **kw),
                     psh.state_shardings(t.pstate, pm, stacked=True, **kw),
                     "codist state")
    n += _specs_equal(jsh.state_shardings(t.jtrain, jm, **kw),
                      psh.state_shardings(t.ptrain, pm, **kw), "train state")
    jp = jsh.params_shardings(t.jparams, jm, **{k: v for k, v in kw.items()
                                                if k == "fsdp_axis"})
    pp = psh.params_shardings(t.pparams, pm, **{k: v for k, v in kw.items()
                                                if k == "fsdp_axis"})
    n += _specs_equal(jp, pp, "params")
    jo = jsh.optstate_shardings(t.jtrain.opt, jp, jm)
    po = psh.optstate_shardings(t.ptrain.opt, pp, pm)
    _specs_equal(jo, po, "opt state")
    assert n > 3
    # every placed leaf divides (local_shape raises where it does not)
    flat = _pflat(psh.state_shardings(t.pstate, pm, stacked=True, **kw))
    for path, leaf in _pflat(t.pstate).items():
        psh.local_shape(tuple(leaf.shape), flat[path], pm)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_batch_and_cache_rules_equal_the_reference(trees, arch, mesh_name):
    t = trees[arch]
    sizes, names = MESHES[mesh_name]
    jm, pm = jmesh.abstract_mesh(sizes, names), pmesh.abstract_mesh(sizes,
                                                                     names)
    for name, shape in INPUT_SHAPES.items():
        js = J_SHAPES[name]
        for stacked, k in ((False, 1), (True, 4), (False, 4)):
            if shape.kind != "train" and (stacked or k > 1):
                continue
            kw = {"n_stack": 2 if stacked else 0, "microbatch": k}
            _specs_equal(
                jsh.batch_shardings(jsp.train_batch_specs(t.jcfg, js, **kw),
                                    jm, stacked=stacked,
                                    microbatched=k > 1),
                psh.batch_shardings(psp.train_batch_specs(t.pcfg, shape,
                                                          **kw),
                                    pm, stacked=stacked, microbatched=k > 1),
                f"batch {name} {kw}")
        _specs_equal(
            jsh.batch_shardings({"t": jsp.decode_token_specs(js)}, jm,
                                shard_seq_when_b1=True),
            psh.batch_shardings({"t": psp.decode_token_specs(shape)}, pm,
                                shard_seq_when_b1=True), "tokens")
        if shape.kind == "decode":
            jc = jsp.cache_specs(t.jm, t.jcfg, js)
            pc = psp.cache_specs(t.pm, t.pcfg, shape)
            for prefer in (False, True):
                _specs_equal(
                    jsh.cache_shardings(jc, jm, js.global_batch, prefer),
                    psh.cache_shardings(pc, pm, shape.global_batch, prefer),
                    f"cache {name} {prefer}")


PARAM_CASES = [
    # path, shape, mesh, kwargs (the reference's tests/test_launch_units.py
    # cases and more)
    ("layers/sub0/mix/wq", (28, 3584, 28, 128), "single", {"scanned": True}),
    ("layers/sub0/mix/wq", (95, 8192, 64, 128), "single", {"scanned": True}),
    ("dec_layers/ffn/w_up", (4, 384, 1536), "single", {"scanned": True}),
    ("layers/sub0/ffn/w_up", (64, 8, 6144, 32768), "single",
     {"scanned": True, "moe_expert_axis": "data"}),
    ("layers/sub0/ffn/w_down", (64, 8, 32768, 6144), "single",
     {"scanned": True, "moe_expert_axis": "data"}),
    ("layers/sub0/ffn/w_up", (96, 8192, 22016), "single", {"scanned": True}),
    ("layers/sub0/ffn/w_up", (2, 24, 1024, 2816), "multi",
     {"stacked": True, "scanned": True}),
    ("layers/sub0/ffn/w_up", (28, 3584, 18944), "single",
     {"scanned": True, "two_d_ffn": True}),
    ("layers/sub0/mix/wo", (28, 3584, 3584), "single", {"scanned": True}),
    ("embed/tokens", (152064, 3584), "single", {"two_d_ffn": True}),
    ("layers/sub0/mix/bq", (28, 28, 128), "single", {"scanned": True}),
]


@pytest.mark.parametrize("path,shape,mesh_name,kw", PARAM_CASES)
def test_param_spec_equals_the_reference(path, shape, mesh_name, kw):
    sizes, names = MESHES[mesh_name]
    jm, pm = jmesh.abstract_mesh(sizes, names), pmesh.abstract_mesh(sizes,
                                                                     names)
    got = psh.param_spec(path, shape, pm, **kw)
    assert got == tuple(jsh.param_spec(path, shape, jm, **kw))
    local = psh.local_shape(shape, got, pm)
    assert np.prod(local) * np.prod([pm.shape[a] for a in
                                     psh.spec_axes(got)]) == np.prod(shape)


def test_local_shape_and_replicated():
    m = pmesh.abstract_mesh((16, 16), ("data", "model"))
    assert psh.local_shape((512, 64, 3), (("data", "model"), None), m) == \
        (2, 64, 3)
    assert psh.local_shape((32, 64), ("data",), m) == (2, 64)
    with pytest.raises(ValueError):
        psh.local_shape((10, 7), ("data", None), m)
    assert psh.replicated(m) == () and psh.P("data", None) == ("data", None)


# ----------------------------------------------------------------------------
# hints
# ----------------------------------------------------------------------------

HINT_CASES = [
    # kind, shape, batch_axes, tp, tp_size
    ("btd", (4, 8, 64), ("data",), "model", 16),
    ("btd", (2, 4, 8, 64), ("pod", "data"), "model", 16),   # padded left
    ("btd_carry", (4, 8, 64), ("data",), "model", 16),
    ("btd_carry", (4, 8, 40), ("data",), "model", 16),      # d indivisible
    ("btd_carry", (4, 8, 8), ("data",), "model", 16),       # d < tp
    ("btv", (4, 8, 512), ("data",), "model", 16),
    ("btv", (4, 8, 512), None, "model", 16),
    ("wire", (2, 4, 8, 64), ("data",), "model", 16),
    ("wire", (2, 4), ("data",), "model", 16),
    ("wire", (5,), ("data",), "model", 16),                 # rank mismatch
    ("scores", (2, 32, 16, 16), ("data",), "model", 16),    # heads
    ("scores", (2, 56, 16, 16), ("data",), "model", 16),    # 56 -> queries
    ("scores", (2, 56, 8, 8), ("data",), "model", 16),      # neither
    ("scores", (2, 2, 4, 32, 16, 16), ("data",), "model", 16),
    ("scores", (2, 12, 16, 16), ("data",), None, 0),
    ("other", (4, 8), ("data",), "model", 16),
]


@pytest.mark.parametrize("kind,shape,batch_axes,tp,tp_size", HINT_CASES)
def test_hint_spec_equals_the_reference_hint(monkeypatch, kind, shape,
                                             batch_axes, tp, tp_size):
    seen = []

    def capture(x, spec):
        seen.append(spec)
        return x

    monkeypatch.setattr(jax.lax, "with_sharding_constraint", capture)
    with jhints.activation_sharding(batch_axes, tp, tp_size):
        jhints.hint(jnp.zeros(shape, jnp.float32), kind)
    want = tuple(seen[0]) if seen else None
    got = hint_spec(kind, shape, batch_axes, tp, tp_size)
    assert (None if got is None else tuple(got)) == want, (kind, shape)
    with activation_sharding(batch_axes, tp, tp_size):
        assert current_hint_spec(kind, shape) == got
    assert current_hint_spec(kind, shape) is None
