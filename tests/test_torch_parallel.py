"""The parallel layer: mesh shapes, the ShardingEnv, and the sharding rules
against the JAX package's, then ZeRO-1 on a 2-rank gloo world.

The rule tests need no world: for every parameter of a tiny Llama and a
tiny BERT (Flax params converted by each model's ``flax_to_state_dict``),
under every strategy (dp, fsdp, tp, dp_tp, fsdp_tp, sp, dp_sp, dp_zero) on
meshes over 8 devices, the port's DTensor placements must equal the JAX
``param_sharding`` PartitionSpec and, under "zero", ``zero_opt_sharding``'s,
read on the Flax layout (a port dense ``weight`` is a Flax ``kernel``
transposed). The world test trains an MLP under "dp" and "dp_zero" on two
CPU ranks: equal losses and parameters (1e-6: the same arithmetic, the
update split by rows), each rank's Adam moments half of the sharded leaves,
and both equal to one process training on the whole batch (1e-5: the
gradient average sums in another order). Under "fsdp" on {"fsdp": 2} the
same MLP, which declares no logical axes, trains replicated with the "dp"
losses and parameters, as the JAX Trainer replicates an unannotated leaf.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

import torch_runner_fns
from maggy_tpu.models.bert import BertConfig as JaxBertConfig
from maggy_tpu.models.bert import BertEncoder as JaxBertEncoder
from maggy_tpu.models.llama import Llama as JaxLlama
from maggy_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from maggy_tpu.parallel import make_mesh as jax_make_mesh
from maggy_tpu.parallel import sharding as jax_sharding
from maggy_tpu_torch.models import bert as port_bert
from maggy_tpu_torch.models import llama as port_llama
from maggy_tpu_torch.parallel import ShardingEnv, make_mesh, sharding
from maggy_tpu_torch.parallel.mesh import resolve_mesh_shape
from maggy_tpu_torch.train import Trainer, adam, cross_entropy_loss

pytestmark = [pytest.mark.torch, pytest.mark.timeout(120)]

STRATEGIES = ("dp", "fsdp", "tp", "dp_tp", "fsdp_tp", "sp", "dp_sp", "dp_zero")
MESHES = ({"data": 2, "fsdp": 2, "model": 2}, {"data": 4, "model": 2},
          {"fsdp": 8}, {"data": 2, "seq": 4})


def test_mesh_shapes_match_jax():
    for shape in ({"data": 8}, {"data": -1, "model": 2}, {"data": 2, "seq": -1}):
        assert resolve_mesh_shape(shape, 8) == dict(jax_make_mesh(shape).shape)
    assert resolve_mesh_shape({}, 8) == {"data": 8}
    for bad in ({"data": 3}, {"data": -1, "seq": -1}, {"data": -1, "model": 3}):
        with pytest.raises(ValueError):
            jax_make_mesh(bad)
        with pytest.raises(ValueError):
            resolve_mesh_shape(bad, 8)
    with pytest.raises(ValueError, match="devices"):
        resolve_mesh_shape({"data": 3}, 8)


def test_a_mesh_larger_than_the_world_is_refused():
    # No process group: the world is this rank alone.
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh({"data": 2}, device_type="cpu")
    mesh = make_mesh({"data": -1, "seq": 1}, device_type="cpu")
    assert tuple(mesh.mesh_dim_names) == ("data", "seq") and mesh.size() == 1


def test_sharding_env_batch_on_a_world_of_one():
    env = ShardingEnv(make_mesh({"data": 1}, device_type="cpu"))
    assert (env.axis_names, env.num_devices, env.current_shard, env.shard_count) == (
        ("data",), 1, 0, 1)
    assert env.data_group is None and env.group("seq") is None
    batch = {"x": np.ones((16, 4), np.float32), "y": np.zeros((16,), np.int32),
             "inputs": (np.arange(8).reshape(2, 4),)}
    placed = env.shard_batch(batch)
    assert placed["x"].shape == (16, 4) and placed["x"].device == torch.device("cpu")
    assert placed["inputs"][0].tolist() == batch["inputs"][0].tolist()
    # The JAX env's spec for the same batch: the data axis on dim 0.
    jenv_spec = jax_make_mesh({"data": 8})
    assert P(*sharding.batch_sharding({"data": 8}, shape=(16, 4))) == \
        jax_sharding.batch_sharding(jenv_spec, shape=(16, 4)).spec == P(("data",), None)


def test_batch_sharding_and_axis_rules_match_jax():
    mesh = jax_make_mesh({"data": 2, "seq": 4})
    axes = {"data": 2, "seq": 4}
    for shape in ((8, 64), (8, 10), (8, 64, 3), (8,)):
        assert P(*sharding.batch_sharding(axes, shape=shape)) == \
            jax_sharding.batch_sharding(mesh, shape=shape).spec, shape
        assert P(*sharding.cached_batch_sharding(axes, shape)) == \
            jax_sharding.cached_batch_sharding(mesh, shape).spec
    for strategy in STRATEGIES + ("dp_sp_ep", "fsdp_tp"):
        assert sharding.logical_axis_rules(strategy) == jax_sharding.logical_axis_rules(strategy)
    with pytest.raises(ValueError, match="Unknown strategy"):
        sharding.logical_axis_rules("dp_magic")


def _marked(params):
    """``params`` with every leaf replaced by distinct consecutive numbers
    (the leaf's offset plus its element index), so a converted tensor names
    its Flax leaf and shows whether it was transposed."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    marked, offset = [], 0
    for leaf in leaves:
        n = int(np.prod(np.shape(leaf)))
        marked.append(np.arange(offset, offset + n, dtype=np.float64).reshape(np.shape(leaf)))
        offset += n
    return leaves, marked, treedef.unflatten(marked)


def _jax_params():
    llama = JaxLlama(JaxLlamaConfig.tiny(lora_rank=4))
    lp = llama.init(jax.random.key(0), jnp.ones((1, 16), jnp.int32))
    bert = JaxBertEncoder(JaxBertConfig.tiny())
    bp = bert.init(jax.random.key(0), jnp.ones((1, 16), jnp.int32))
    return {"llama": (nn.meta.unbox(lp)["params"], port_llama.flax_to_state_dict),
            "bert": (nn.meta.unbox(bp)["params"], port_bert.flax_to_state_dict)}


def _expected(jax_spec, leaf, marked_leaf, port_tensor):
    """The JAX spec of ``leaf`` as port placements: transposed with the
    tensor when the conversion transposed it."""
    spec = tuple(jax_spec) + (None,) * (np.ndim(leaf) - len(tuple(jax_spec)))
    t = port_tensor.numpy()
    if t.ndim == 2 and not np.array_equal(t, marked_leaf) and np.array_equal(t, marked_leaf.T):
        spec = spec[::-1]
    return spec


@pytest.mark.parametrize("model", ["llama", "bert"])
def test_parameter_placements_equal_jax_partition_specs(model):
    params, convert = _jax_params()[model]
    leaves, marked, marked_tree = _marked(params)
    state = convert(marked_tree)
    starts = np.cumsum([0] + [int(np.prod(np.shape(x))) for x in leaves])
    checked = 0
    for axes in MESHES:
        mesh = jax_make_mesh(axes)
        for strategy in STRATEGIES:
            if strategy == "dp_zero" and "data" not in axes:
                continue
            for name, t in state.items():
                i = int(np.searchsorted(starts, float(t.reshape(-1)[0]), side="right")) - 1
                leaf = leaves[i]
                spec = jax_sharding.param_sharding(mesh, leaf, strategy).spec
                want = sharding.spec_to_placements(
                    axes, _expected(spec, leaf, marked[i], t) if tuple(spec) else ())
                assert sharding.param_placements(axes, name, t.shape, strategy) == want, (
                    axes, strategy, name)
                zspec = jax_sharding.zero_opt_sharding(mesh, strategy, np.shape(leaf))
                zero = sharding.zero_placements(axes, name, t.shape, strategy)
                if zspec is None:
                    assert zero is None
                else:
                    assert zero == sharding.spec_to_placements(
                        axes, _expected(zspec.spec, leaf, marked[i], t)
                        if tuple(zspec.spec) else ()), (axes, strategy, name)
                checked += 1
    assert checked > 100


def test_rules_on_shapes_match_jax():
    mesh = jax_make_mesh({"fsdp": 8})
    shardings = jax_sharding.shard_params(mesh, {"w": np.ones((32, 16)), "b": np.ones((7,))},
                                          strategy="fsdp")
    assert sharding.param_sharding({"fsdp": 8}, (32, 16), "fsdp") == tuple(shardings["w"].spec)
    assert shardings["w"].spec == P("fsdp", None)
    assert sharding.param_sharding({"fsdp": 8}, (7,), "fsdp") == () == tuple(shardings["b"].spec)
    # A port Linear weight [16, 32] is that kernel transposed: fsdp on dim 1.
    assert sharding.shard_params({"fsdp": 8}, [("lin.weight", (16, 32))], "fsdp") == {
        "lin.weight": (Shard(1),)}
    assert sharding.param_placements({"data": 2, "fsdp": 4}, "b", (7,), "fsdp") == (
        Replicate(), Replicate())
    with pytest.raises(ValueError, match="composes with dp/sp only"):
        sharding.zero_opt_sharding({"data": 2, "fsdp": 4}, "fsdp_zero", (8,))
    with pytest.raises(ValueError, match="needs a 'data' mesh axis"):
        sharding.zero_opt_sharding({"seq": 2}, "sp_zero", (8,))
    placed = sharding.apply_zero_sharding({"mu": torch.zeros(8, 3), "count": torch.zeros(())},
                                          {"data": 2}, "dp_zero", lambda x, spec: spec)
    assert placed == {"mu": ("data", None), "count": ()}


def test_mesh_trainer_on_a_world_of_one():
    env = ShardingEnv(make_mesh({"fsdp": 1}, device_type="cpu"))
    # fsdp over one rank shards nothing: the trainer runs, eagerly.
    model = torch.nn.Linear(4, 2)
    expected = float(model(torch.ones(3, 4)).sum().detach())
    trainer = Trainer(model, adam(1e-3), lambda o, b: o.sum(), env=env,
                      strategy="fsdp").init(state_dict=model.state_dict())
    assert trainer._slot is None
    assert float(trainer.step(trainer.place_batch({"inputs": (np.ones((3, 4), np.float32),)}))) \
        == pytest.approx(expected, abs=1e-6)
    with pytest.raises(ValueError, match="Unknown strategy"):
        Trainer(model, adam(1e-3), lambda o, b: o.sum(), env=env, strategy="dp_magic")


@pytest.fixture(scope="module")
def zero_world(tmp_path_factory):
    rng = np.random.default_rng(0)
    model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.ReLU(), torch.nn.Linear(64, 2))
    state = {k: torch.tensor(rng.normal(0, 0.2, size=tuple(v.shape)).astype(np.float32))
             for k, v in model.state_dict().items()}
    x = rng.normal(size=(16, 32)).astype(np.float32)
    y = rng.integers(0, 2, size=16).astype(np.int64)
    out_dir = str(tmp_path_factory.mktemp("zero_world"))
    ranks = torch_runner_fns.run_world(torch_runner_fns.zero_rank, 2, out_dir,
                                       (state, x, y, 5, 1e-2))
    return state, x, y, ranks


def test_dp_zero_shards_the_moments_and_keeps_the_math(zero_world):
    state, x, y, ranks = zero_world
    model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.ReLU(), torch.nn.Linear(64, 2))
    alone = Trainer(model, adam(1e-2), lambda o, b: cross_entropy_loss(o, b["labels"]),
                    device="cpu").init(state_dict=state)
    batch = {"inputs": (torch.tensor(x),), "labels": torch.tensor(y)}
    ref = [float(alone.step(batch)) for _ in range(5)]
    for r in ranks:
        assert r["dp"]["losses"] == ranks[0]["dp"]["losses"]
        np.testing.assert_allclose(r["dp"]["losses"], ref, rtol=1e-5)
        np.testing.assert_allclose(r["dp_zero"]["losses"], r["dp"]["losses"], rtol=1e-6)
        for name, p in alone.model.state_dict().items():
            np.testing.assert_allclose(r["dp"]["params"][name], p.numpy(), atol=1e-5)
            np.testing.assert_allclose(r["dp_zero"]["params"][name], r["dp"]["params"][name],
                                       atol=1e-6)
        # Flax kernel [in, out] leading dim over "data": a port weight's dim 1.
        assert r["dp_zero"]["moments"] == {"0.weight": (64, 16), "0.bias": (32,),
                                           "2.weight": (2, 32), "2.bias": (1,)}
        assert r["dp"]["moments"]["0.weight"] == (64, 32)
        # No declared logical axes: replicated under fsdp, the dp numbers.
        assert r["fsdp"]["shard_shapes"] == {}
        assert r["fsdp"]["losses"] == r["dp"]["losses"]
        assert r["fsdp"]["moments"] == r["dp"]["moments"]
        for name, p in r["dp"]["params"].items():
            np.testing.assert_array_equal(r["fsdp"]["params"][name], p)
