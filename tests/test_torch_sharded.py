"""Sharded parameters on the mesh Trainer: placements from the models'
logical axes, and fsdp and tp training, against the JAX package.

Placements (no world): every parameter of the tiny Llama (LoRA rank 4),
the MoE Llama, BERT and ViT under "fsdp", "tp", "fsdp_tp", "dp_tp",
"dp_ep" and "fsdp_ep" on meshes over 8 devices must get the spec the JAX
Trainer gives its Flax leaf (``trainer.shardings``, from the modules'
``nn.with_logical_partitioning`` annotations), in the port's dim order; a
module that declares nothing (a plain ``nn.Sequential``, a bare Flax
``nn.Dense``) is replicated, and BERT's pooler under "fsdp" shards its
input dim only (``tests/test_models.py:292-306``).

Training (a 2-rank gloo world of CPU processes): the tiny Llama under "tp"
on {"model": 2} (2 query and 1 kv head a rank) and "fsdp" on {"fsdp": 2},
three adam steps from the JAX Trainer's weights, against the JAX Trainer
on the same mesh (``sharded_parity``'s tolerances); each rank holds half
of every cut parameter. The tp run once more with the vocab-chunked loss
of the hidden states and the still-cut head (24-column chunks: the
vocab-parallel softmax over both ranks' columns), against the same JAX
run of the dense loss. A head count that does not divide "model" raises.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sharded_parity as sp
import torch_runner_fns
from maggy_tpu.models.bert import BertConfig as JaxBertConfig
from maggy_tpu.models.bert import BertEncoder as JaxBertEncoder
from maggy_tpu.models.llama import Llama as JaxLlama
from maggy_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from maggy_tpu.models.vit import ViT as JaxViT
from maggy_tpu.models.vit import ViTConfig as JaxViTConfig
from maggy_tpu.parallel import make_mesh as jax_make_mesh
from maggy_tpu.train.trainer import _unbox_and_specs
from maggy_tpu_torch.models import bert as port_bert
from maggy_tpu_torch.models import llama as port_llama
from maggy_tpu_torch.models import vit as port_vit
from maggy_tpu_torch.parallel import ShardingEnv, collectives, make_mesh, sharding

pytestmark = [pytest.mark.torch, pytest.mark.timeout(240)]

MESHES = ({"data": 2, "fsdp": 2, "model": 2}, {"fsdp": 8}, {"data": 4, "model": 2},
          {"data": 2, "expert": 4}, {"fsdp": 2, "expert": 4})
STRATEGIES = ("fsdp", "tp", "fsdp_tp", "dp_tp", "dp_ep", "fsdp_ep")


def _models():
    """(boxed Flax variables, port model on the meta device, converter)."""
    tokens = jnp.ones((1, 16), jnp.int32)
    llama_cfg = JaxLlamaConfig.tiny(lora_rank=4)
    moe_cfg = JaxLlamaConfig(**sp.moe_fields())
    vit_cfg = JaxViTConfig.tiny()
    out = {}
    for name, jmodel, pmodel, convert, x in (
            ("llama", JaxLlama(llama_cfg),
             port_llama.Llama(port_llama.LlamaConfig.tiny(lora_rank=4), device="meta"),
             port_llama.flax_to_state_dict, tokens),
            ("moe_llama", JaxLlama(moe_cfg),
             port_llama.Llama(port_llama.LlamaConfig(**sp.moe_fields()), device="meta"),
             port_llama.flax_to_state_dict, tokens),
            ("bert", JaxBertEncoder(JaxBertConfig.tiny()),
             port_bert.BertEncoder(port_bert.BertConfig.tiny(hidden_dim=32, intermediate_dim=64,
                                                             max_seq_len=64), device="meta"),
             port_bert.flax_to_state_dict, tokens),
            ("vit", JaxViT(vit_cfg), port_vit.ViT(port_vit.ViTConfig.tiny(), device="meta"),
             port_vit.flax_to_state_dict, jnp.ones((1, 32, 32, 3), jnp.float32))):
        out[name] = (jmodel.init(jax.random.key(0), x), pmodel, convert)
    return out


@pytest.mark.parametrize("model", ["llama", "moe_llama", "bert", "vit"])
def test_placements_from_logical_axes_equal_the_jax_trainers(model):
    variables, port, convert = _models()[model]
    checked = 0
    for axes in MESHES:
        mesh = jax_make_mesh(axes)
        for strategy in STRATEGIES:
            want = sp.jax_specs_by_port_name(variables, convert, mesh, strategy)
            got = sharding.logical_placements(port, axes, strategy)
            assert set(got) == set(want)
            for name, spec in got.items():
                assert spec == want[name] or (spec == () and not any(want[name])), (
                    axes, strategy, name, spec, want[name])
                checked += 1
    assert checked > 200


def test_bert_pooler_under_fsdp_and_plain_modules_are_replicated():
    port = port_bert.BertEncoder(port_bert.BertConfig.tiny(), device="meta")
    specs = sharding.logical_placements(port, {"fsdp": 8}, "fsdp")
    assert specs["pooler.weight"] == (None, "fsdp")  # [out, in]: the input dim
    assert specs["pooler.bias"] == (None,)
    assert specs["layers.0.ln_attn.weight"] == ()
    plain = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.ReLU(), torch.nn.Linear(64, 2))
    for strategy in ("fsdp", "tp", "fsdp_tp"):
        assert set(sharding.logical_placements(plain, {"fsdp": 2, "model": 2}, strategy)
                   .values()) == {()}
    dense = nn.Dense(2)
    variables = dense.init(jax.random.key(0), jnp.ones((1, 32)))
    _, shardings = _unbox_and_specs(variables, jax_make_mesh({"fsdp": 8}), "fsdp")
    assert {tuple(s.spec) for s in jax.tree_util.tree_leaves(shardings)} == {()}


def test_bad_head_counts_raise():
    cfg = port_llama.LlamaConfig(**dict(sp.LLAMA, num_heads=3, num_kv_heads=3))
    model = port_llama.Llama(cfg, device="cpu")
    env = ShardingEnv(make_mesh({"model": 1}, device_type="cpu"))
    assert env.axis_size("model") == 1
    with pytest.raises(ValueError, match="heads"):
        from maggy_tpu_torch.parallel import sharded

        q = model.layers[0].attn.q_proj.weight
        q._mesh_shards = {0: ("model", None, 2, 0)}
        sharded.check_heads(cfg.num_heads, cfg.num_kv_heads, q)


class _Coords:
    """A rank's place on a mesh, as ``shard_state_dict`` reads it."""

    def __init__(self, sizes, index):
        self.sizes, self.index = sizes, index

    def axis_size(self, axis):
        return self.sizes.get(axis, 1)

    def axis_index(self, axis):
        return self.index.get(axis, 0)


def test_shard_state_dict_cuts_each_ranks_blocks():
    model = port_llama.Llama(port_llama.LlamaConfig(**sp.LLAMA), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    state = model.state_dict()
    sizes = {"fsdp": 2, "model": 2}
    specs = sharding.logical_placements(model, sizes, "fsdp_tp")
    blocks = {(f, m): sharding.shard_state_dict(state, specs, _Coords(sizes, {"fsdp": f,
                                                                              "model": m}))
              for f in (0, 1) for m in (0, 1)}
    q = "layers.0.attn.q_proj.weight"  # [heads * D, H]: "model" on dim 0, "fsdp" on dim 1
    assert specs[q] == ("model", "fsdp")
    whole = torch.cat([torch.cat([blocks[(f, m)][q] for f in (0, 1)], dim=1) for m in (0, 1)])
    assert torch.equal(whole, state[q])
    norm = "layers.0.attn_norm.scale"
    assert torch.equal(torch.cat([blocks[(0, 0)][norm], blocks[(1, 0)][norm]]), state[norm])
    assert blocks[(0, 1)][norm].data_ptr() != state[norm].data_ptr()  # a copy
    with pytest.raises(ValueError, match="does not divide"):
        sharding.shard_state_dict({"w": torch.ones(3, 4)}, {"w": ("model", None)},
                                  _Coords(sizes, {}))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tokens = sp.token_batches()
    refs, runs = {}, {}
    for name, mesh, strategy in (("tp", {"model": 2}, "tp"), ("fsdp", {"fsdp": 2}, "fsdp")):
        refs[name] = sp.jax_llama_run(sp.LLAMA, mesh, strategy, tokens)
        runs[name] = {"fields": sp.LLAMA, "mesh": mesh, "strategy": strategy,
                      "state": refs[name]["state"], "tokens": tokens}
    runs.update(sp.sgd_runs(dict(runs), refs, tokens))
    for name in ("tp", "tp_sgd"):
        refs[name.replace("tp", "tp_chunked")] = refs[name]
        runs[name.replace("tp", "tp_chunked")] = dict(runs[name], model="llama_chunked",
                                                      train_kwargs={"return_hidden": True})
    ranks = sp.port_llama_runs(2, runs, str(tmp_path_factory.mktemp("sharded2")))
    return refs, ranks


@pytest.mark.parametrize("name", ["tp", "fsdp", "tp_chunked"])
def test_sharded_llama_trains_as_the_jax_trainer(two_ranks, name):
    refs, ranks = two_ranks
    sp.assert_matches_jax(ranks, name, refs[name])


@pytest.mark.parametrize("name", ["tp", "fsdp", "tp_chunked"])
def test_one_sgd_step_moves_each_parameter_as_the_jax_trainer(two_ranks, name):
    """The gradients' scale, which adam cancels: a sum over "model" or
    "fsdp" where a mean belongs would move each parameter twice as far."""
    refs, ranks = two_ranks
    sp.assert_step_matches_jax(ranks, name + "_sgd", refs[name + "_sgd"])


def test_each_rank_holds_its_blocks(two_ranks):
    _, ranks = two_ranks
    H, L = sp.LLAMA["hidden_dim"], sp.LLAMA
    tp, fsdp = ranks[0]["tp"], ranks[0]["fsdp"]
    # tp: q_proj [heads * D, H] cut on its heads (column-parallel), o_proj
    # [H, heads * D] on its input (row-parallel), the vocab of both ends.
    assert tp["shard_shapes"]["layers.0.attn.q_proj.weight"] == (
        L["num_heads"] * L["head_dim"] // 2, H)
    assert tp["shard_shapes"]["layers.0.attn.k_proj.weight"] == (
        L["num_kv_heads"] * L["head_dim"] // 2, H)
    assert tp["shard_shapes"]["layers.0.attn.o_proj.weight"] == (
        H, L["num_heads"] * L["head_dim"] // 2)
    assert tp["shard_shapes"]["embedding"] == (L["vocab_size"] // 2, H)
    assert tp["shard_shapes"]["lm_head"] == (H, L["vocab_size"] // 2)
    assert "layers.0.attn_norm.scale" not in tp["shard_shapes"]
    assert {"tp_all_reduce", "tp_grad_all_reduce", "tp_all_gather"} <= set(tp["traffic"])
    # fsdp: every leaf cut along its embedding dim, norms included.
    assert fsdp["shard_shapes"]["layers.0.attn.q_proj.weight"] == (
        L["num_heads"] * L["head_dim"], H // 2)
    assert fsdp["shard_shapes"]["layers.0.attn_norm.scale"] == (H // 2,)
    assert {"fsdp_all_gather", "fsdp_reduce_scatter"} <= set(fsdp["traffic"])
    assert "tp_all_reduce" not in fsdp["traffic"]
    # The optimizer holds the blocks: its moments are sharded as they are
    # (ZeRO-3 under fsdp), every parameter's moment its block's shape.
    for run in (tp, fsdp):
        assert run["moments"] and all(
            run["moments"][n] == run["shard_shapes"].get(n, run["moments"][n])
            for n in run["moments"])
    assert fsdp["moments"]["layers.0.attn.q_proj.weight"] == (
        L["num_heads"] * L["head_dim"], H // 2)
    # The chunked loss reads the cut head: no gather of it, the softmax's
    # statistics and h's gradient combined over "model".
    chunked = ranks[0]["tp_chunked"]["traffic"]
    assert "tp_all_gather" not in chunked
    assert {"tp_loss_all_reduce", "tp_loss_grad_all_reduce"} <= set(chunked)


def test_gather_and_reduce_scatter_give_every_rank_its_values(tmp_path):
    """fsdp's gather and reduce-scatter (the tensor forms) on a gloo world:
    the whole tensor from every rank's block, and this rank's block of the
    sum, counted under their kinds with the group's backend."""
    ranks = torch_runner_fns.run_world(torch_runner_fns.gather_scatter_rank, 2, str(tmp_path))
    whole = np.arange(48, dtype=np.float32).reshape(8, 6)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(
            res["gathered"], np.concatenate([whole[:, :3], 2 * whole[:, 3:]], axis=1))
        assert res["scattered"].tolist() == (3 * whole[4 * r:4 * r + 4]).tolist()
        assert res["transports"] == {"k_gather": "gloo", "k_scatter": "gloo"}


@pytest.mark.parametrize("op", ["all_gather_into_tensor", "reduce_scatter_tensor"])
def test_an_exchange_the_probe_did_not_run_on_cuda_raises(op):
    """The transport comes from the probe's answer, never by trying: gloo
    on CUDA tensors of a probed dtype runs the op, an unprobed dtype
    raises, and CPU tensors and other backends run as they are."""
    assert collectives.transport_of(op, "gloo", "cuda", torch.float32) == "gloo"
    assert collectives.transport_of(op, "gloo", "cuda", torch.bfloat16) == "gloo"
    assert collectives.transport_of(op, "gloo", "cpu", torch.float16) == "gloo"
    assert collectives.transport_of(op, "nccl", "cuda", torch.float16) == "nccl"
    with pytest.raises(RuntimeError, match="not probed"):
        collectives.transport_of(op, "gloo", "cuda", torch.float16)



def test_the_chunked_loss_refuses_a_target_outside_the_head():
    """A vocab-cut head that lost its note on the way to the loss (a cast
    makes a new tensor) holds only its columns: a target past them raises,
    as ``F.cross_entropy`` does, rather than give a wrong loss."""
    from maggy_tpu_torch.ops import chunked_softmax_xent

    rng = np.random.default_rng(0)
    h = torch.as_tensor(rng.standard_normal((6, 8)), dtype=torch.float32)
    head = torch.as_tensor(rng.standard_normal((8, 16)), dtype=torch.float32)
    targets = torch.as_tensor([0, 3, 15, 7, 9, 1])
    assert torch.isfinite(chunked_softmax_xent(h, head, targets, 4))
    with pytest.raises(ValueError, match="outside"):
        chunked_softmax_xent(h, head[:, :8].double().float(), targets, 4)
    with pytest.raises(ValueError, match="outside"):
        chunked_softmax_xent(h, head, torch.as_tensor([0, -1, 2, 3, 4, 5]), 4)
