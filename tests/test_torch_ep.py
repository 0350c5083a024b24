"""Expert parallelism: the MoE Llama (4 experts, top 2) under "dp_ep" on
{"data": 2, "expert": 2} and "tp_ep" on {"expert": 2, "model": 2} (tensor
parallelism inside each expert's MLP and in attention), 4-rank gloo worlds
of CPU processes, against the JAX Trainer on the same meshes
(``tests/test_parallel_strategies.py:349-371``), three adam steps from the
JAX Trainer's weights with ``sharded_parity``'s tolerances. Each rank
holds 2 of the 4 experts (and the router's matching columns, gathered
whole for routing); tokens are cut over "data" only, so the two expert
ranks of a data row see the same tokens; the load-balancing loss's
statistics are over the global batch, as GSPMD computes them."""

import pytest

import sharded_parity as sp

pytestmark = [pytest.mark.torch, pytest.mark.timeout(240)]

RUNS = {"dp_ep": {"data": 2, "expert": 2}, "tp_ep": {"expert": 2, "model": 2}}


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    tokens = sp.token_batches(seed=2)
    fields = sp.moe_fields()
    refs, runs = {}, {}
    for strategy, mesh in RUNS.items():
        refs[strategy] = sp.jax_llama_run(fields, mesh, strategy, tokens)
        runs[strategy] = {"fields": fields, "mesh": mesh, "strategy": strategy,
                          "state": refs[strategy]["state"], "tokens": tokens}
    runs.update(sp.sgd_runs(dict(runs), refs, tokens))
    ranks = sp.port_llama_runs(4, runs, str(tmp_path_factory.mktemp("ep")))
    return refs, ranks


@pytest.mark.parametrize("strategy", sorted(RUNS))
def test_moe_llama_trains_as_the_jax_trainer(ep, strategy):
    refs, ranks = ep
    sp.assert_matches_jax(ranks, strategy, refs[strategy])


@pytest.mark.parametrize("strategy", sorted(RUNS))
def test_moe_llama_sgd_step_moves_each_parameter_as_the_jax_trainer(ep, strategy):
    """The gradients' scale, which adam cancels (``sharded_parity``)."""
    refs, ranks = ep
    sp.assert_step_matches_jax(ranks, strategy + "_sgd", refs[strategy + "_sgd"])


def test_experts_are_cut_over_the_expert_axis(ep):
    _, ranks = ep
    L = sp.LLAMA
    for r in ranks:
        run = r["dp_ep"]
        assert run["shard_shapes"]["layers.0.moe_mlp.gate_proj"] == (
            2, L["hidden_dim"], L["intermediate_dim"])
        assert run["shard_shapes"]["layers.0.moe_mlp.down_proj"] == (
            2, L["intermediate_dim"], L["hidden_dim"])
        assert run["shard_shapes"]["layers.0.moe_mlp.router"] == (L["hidden_dim"], 2)
        assert "layers.0.attn.q_proj.weight" not in run["shard_shapes"]
        assert {"ep_all_reduce", "ep_grad_all_reduce", "ep_all_gather",
                "moe_stats_all_reduce"} <= set(run["traffic"])
        tp = r["tp_ep"]["shard_shapes"]
        assert tp["layers.0.moe_mlp.gate_proj"] == (2, L["hidden_dim"], L["intermediate_dim"] // 2)
