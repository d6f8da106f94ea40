"""The port's sharding rules and layouts (``repro_torch.distributed.
{sharding,api,compression}``, ``repro_torch.launch.mesh``,
``data.pipeline.shard_batch``, ``Model.specs``) against the JAX
package's, on the CPU; and the checkpointer across meshes.

Structural parity, exact: ``spec_for``, ``param_shardings``,
``batch_shardings`` and ``cache_shardings`` give the JAX specs for every
leaf of every full-size arch on stand-in meshes of 16x16, 4x2, 2x2, 1x4
and 2x16x16 (nothing allocated), and ``Model.specs()`` is the JAX tree.
On gloo groups of ranks on localhost (``tests/_torch_sharding_ranks.py``):
``shard_batch`` gives ``make_batch``'s global batch bit for bit;
``cross_pod_int8_psum`` over two ranks equals the JAX function under
``jax.vmap(..., axis_name="pod")``, exactly; a checkpoint written under
2x2 restores under 1x1 and under 2x2 bit for bit; the local-shard helpers
for the ops torch 2.11's DTensor refuses give the unsharded values.  The sharded step itself
is ``tests/test_torch_sharded_step.py``, the CLI's
``tests/test_torch_sharded_cli.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sharding_ranks as R
import repro.distributed.compression as JC
import repro.distributed.sharding as JS
from repro.configs import ARCHS as JARCHS
from repro.configs import SMOKES as JSMOKES
from repro.models.config import SHAPES as JSHAPES
from repro.models.registry import build_model as jbuild
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ARCHS as PARCHS
from repro_torch.configs import SMOKES as PSMOKES
from repro_torch.distributed import sharding as PS
from repro_torch.distributed.api import (activation_sharding, call_local,
                                         shard_act)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import _family, model_dtype
from repro_torch.models.registry import build_model as pbuild
from repro_torch.optim.adamw import AdamW, constant_lr
from repro_torch.train.train_step import init_train_state

ARCHS = list(PSMOKES)
BATCH = 4


class _FakeMesh:
    def __init__(self, **axes):
        self.shape = dict(axes)


MESHES = [(_FakeMesh(data=16, model=16), False),
          (_FakeMesh(data=4, model=2), False),
          (_FakeMesh(data=2, model=2), False),
          (_FakeMesh(data=1, model=4), False),
          (_FakeMesh(pod=2, data=16, model=16), True)]
MESH_IDS = ["16x16", "4x2", "2x2", "1x4", "2x16x16"]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _layouts_specs(tree):
    return {p: tuple(x.spec) for p, x in _leaves(tree)}


def _jax_specs(tree):
    return {p: tuple(x) for p, x in _leaves(tree)}


@pytest.fixture
def jax_specs_only(monkeypatch):
    """The JAX layout functions on a stand-in mesh: each NamedSharding
    they build is its PartitionSpec."""
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)


# =============================================================================
# Structural parity (no process group)
# =============================================================================
@pytest.mark.parametrize("mesh,multi_pod", MESHES, ids=MESH_IDS)
def test_spec_for_and_param_shardings_equal_the_jax_ones(mesh, multi_pod):
    jr = JS.default_rules(multi_pod)
    pr = PS.default_rules(multi_pod)
    assert pr.rules == jr.rules
    for name in PARCHS:
        jm, pm = jbuild(JARCHS[name]), pbuild(PARCHS[name])
        specs, abstract = jm.specs(), jm.abstract()
        layouts = PS.param_shardings(mesh, pr, pm.specs(), pm.defs)
        got = _layouts_specs(layouts)
        for path, spec in _leaves(specs):
            shape = dict(_leaves(abstract))[path].shape
            want = tuple(JS.spec_for(mesh, jr, spec, shape))
            assert PS.spec_for(mesh, pr, spec, shape) == want, (name, path)
            assert got[path] == want, (name, path)


def test_the_jax_cases_of_spec_for():
    mesh, rules = _FakeMesh(data=16, model=16), PS.default_rules(False)
    assert PS.spec_for(mesh, rules, ("vocab", "embed"),
                       (256000, 4096)) == ("model", "data")
    assert PS.spec_for(mesh, rules, ("kv", None), (8, 64)) == ()
    assert PS.spec_for(mesh, rules, ("mlp", "heads"),
                       (1024, 1024)) == ("model",)
    pod = _FakeMesh(pod=2, data=16, model=16)
    assert PS.spec_for(pod, PS.default_rules(True), ("batch", None),
                       (64, 8)) == (("pod", "data"),)
    assert PS.default_rules(False, fsdp=False, tp=False).get("heads") is None
    assert PS.default_rules(False).replace(embed=None).get("embed") is None


@pytest.mark.parametrize("mesh,multi_pod", MESHES, ids=MESH_IDS)
def test_batch_and_cache_shardings_equal_the_jax_ones(mesh, multi_pod,
                                                      jax_specs_only):
    jr, pr = JS.default_rules(multi_pod), PS.default_rules(multi_pod)
    for name in PARCHS:
        jm, pm = jbuild(JARCHS[name]), pbuild(PARCHS[name])
        for shape in JSHAPES.values():
            if shape.name == "long_500k" and not JARCHS[name].sub_quadratic:
                continue
            inputs = jm.input_specs(shape)
            assert _layouts_specs(PS.batch_shardings(mesh, pr, inputs)) == \
                _jax_specs(JS.batch_shardings(mesh, jr, inputs)), \
                (name, shape.name)
            if shape.kind != "decode":
                continue
            b, s = shape.global_batch, shape.seq_len
            jcache = jm.cache_specs(b, s)
            # the port's own cache tree, on the meta device
            pcache = _family(pm.cfg)[3](pm.cfg, b, s, model_dtype(pm.cfg),
                                        torch.device("meta"))
            assert {p: tuple(x.shape) for p, x in _leaves(pcache)} == \
                {p: tuple(x.shape) for p, x in _leaves(jcache)}, name
            assert _layouts_specs(PS.cache_shardings(mesh, pr, pcache, b,
                                                     s)) == \
                _jax_specs(JS.cache_shardings(mesh, jr, jcache, b, s)), \
                (name, shape.name)


@pytest.mark.parametrize("name", list(PARCHS))
def test_model_specs_equal_the_jax_ones(name):
    pm, jm = pbuild(PARCHS[name]), jbuild(JARCHS[name])
    assert pm.specs() == jm.specs()
    # each module parameter's axes: its JAX leaf's, the layers axes left out
    flat = dict(_leaves(jm.specs()))
    for pname, spec in pm.named_specs().items():
        parts = pname.split(".")
        key = tuple(p for p in parts if not p.isdigit())
        assert flat[key][len(parts) - len(key):] == spec, pname
        assert all(a == "layers" for a in
                   flat[key][:len(parts) - len(key)]), pname


def test_placements_split_a_dim_over_two_axes_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _FakeMesh(pod=2, data=4, model=2)
    assert PS.placements_for(mesh, (("pod", "data"), "model")) == \
        (Shard(0), Shard(0), Shard(1))
    assert PS.placements_for(mesh, (None, "data")) == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        PS.placements_for(mesh, (("data", "pod"),))


def test_outside_a_mesh_shard_act_and_call_local_change_nothing():
    x = torch.randn(2, 3, 4)
    assert shard_act(x, ("batch", None, None)) is x
    out = call_local(lambda a, b, offsets: (a + b, offsets), (x, x),
                     (("batch", None, None),) * 2, ("batch", None, None))
    assert torch.equal(out[0], 2 * x) and out[1] == ((0, 0, 0), (0, 0, 0))
    seen = []
    with activation_sharding(lambda t, logical: seen.append(logical) or t):
        assert shard_act(x, ("batch", None)) is x
    assert seen == [("batch", None)]
    assert shard_act(x, ("batch", None, None)) is x


def test_a_mesh_larger_than_the_cards_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="4 cards; 1 visible"):
        make_host_mesh(2, 2, "cuda")
    with pytest.raises(ValueError):
        make_host_mesh(1, 1, "meta")


# =============================================================================
# Batches, checkpoints and the int8 all-reduce on gloo groups
# =============================================================================
@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.tree.map(np.asarray,
                        jbuild(JSMOKES[arch]).init(jax.random.PRNGKey(1)))


def _port_params(arch):
    return params_from_jax(PSMOKES[arch], _jax_params(arch))


def test_shard_batch_gives_the_global_batch_bit_for_bit(tmp_path):
    R.run_group(4, 120, R.batch_case, [(2, 2), (4, 1), (1, 4)],
                ["qwen2.5-3b", "internvl2-76b", "seamless-m4t-large-v2"],
                8, str(tmp_path))
    assert all(torch.load(tmp_path / "batch.pt")["ok"])


def test_a_checkpoint_written_under_2x2_restores_under_1x1(tmp_path):
    arch = "qwen2.5-3b"
    indir = tmp_path / "in"
    indir.mkdir()
    torch.save({k: p.detach().clone() for k, p in
                _port_params(arch).named_parameters()}, indir / f"{arch}.pt")
    R.run_group(4, 120, R.checkpoint_case, arch, str(indir), str(tmp_path))
    saved = torch.load(tmp_path / "ckpt_state.pt")
    assert saved["restored_under_2x2"]
    assert saved["count"] == 1 and saved["step"] == 1
    model = pbuild(PSMOKES[arch])
    opt = AdamW(lr=constant_lr(R.LR))
    template = init_train_state(model, opt, torch.Generator().manual_seed(5),
                                "cpu")
    step, state = Checkpointer(str(tmp_path / "ckpt")).restore_latest(
        template)
    assert step == 1 and int(state.step) == 1 and int(state.opt.count) == 1
    want = saved["state"]
    for k, p in state.params.named_parameters():
        assert torch.equal(p.detach(), want["params"][k]), k
    for k in want["m"]:
        assert torch.equal(state.opt.m[k], want["m"][k]), k
        assert torch.equal(state.opt.v[k], want["v"][k]), k


def test_cross_pod_int8_psum_equals_the_jax_one(tmp_path):
    rng = np.random.default_rng(0)
    grads = {"w": rng.standard_normal((2, 64, 16)).astype(np.float32),
             "b": (rng.standard_normal((2, 16)) * 1e-3).astype(np.float32),
             "z": np.zeros((2, 8), np.float32)}
    path = tmp_path / "stacked.pt"
    torch.save({k: torch.from_numpy(v) for k, v in grads.items()}, path)
    R.run_group(2, 120, R.int8_case, str(path), str(tmp_path))
    want = jax.vmap(functools.partial(JC.cross_pod_int8_psum,
                                      axis_name="pod"), axis_name="pod")(
        {k: jnp.asarray(v) for k, v in grads.items()})
    for rank in range(2):
        got = torch.load(tmp_path / f"int8-{rank}.pt")
        for k, v in want.items():
            assert np.array_equal(got[k].numpy(), np.asarray(v)[rank]), k


def test_the_local_helpers_equal_the_unsharded_ops_on_a_2x2_mesh(tmp_path):
    """``api.index_add_``, the MoE's ``combine_experts`` and the mLSTM
    decode's read-out on local shards (the ops torch 2.11's DTensor
    refuses: ``index_add_``, and views that flatten a split dim) give
    the unsharded op's values exactly."""
    R.run_group(4, 120, R.local_helpers_case, str(tmp_path))
    pairs = torch.load(tmp_path / "local_helpers.pt")
    assert len(pairs) == 4
    for name, (got, want) in pairs.items():
        assert torch.equal(got, want), name


def test_the_sharded_backward_runs_on_the_calling_thread():
    """On a card the autograd engine runs a backward pass, remat
    recomputes included, on a thread of its own, where neither the
    forward's thread-local resolver nor DTensor's thread-local implicit
    replication is in force.  Under the sharded step's context every
    backward op runs on the thread that asked for the gradients."""
    import threading

    seen = set()
    x = torch.ones(3, requires_grad=True)
    y = (x * 2).sum()
    y.grad_fn.register_prehook(
        lambda g: seen.add(threading.get_ident()) or None)
    resolver = PS.ActResolver(_FakeMesh(data=1, model=1),
                              PS.default_rules(multi_pod=False))
    with activation_sharding(resolver):
        assert not torch.autograd.is_multithreading_enabled()
        torch.autograd.grad(y, x)
    assert seen == {threading.get_ident()}
    assert torch.autograd.is_multithreading_enabled()
