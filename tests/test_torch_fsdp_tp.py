"""fsdp and tp together: the tiny Llama under "fsdp_tp" on {"fsdp": 2,
"model": 2}, a 4-rank gloo world of CPU processes, against the JAX Trainer
on the same mesh of virtual CPU devices (``tests/test_models.py:308-330``'s
strategy), three adam steps from the JAX Trainer's weights, with
``sharded_parity``'s tolerances. Each rank holds a quarter of q_proj's
weight (its heads' rows, the fsdp half of its input dim), gathers the fsdp
half before use and reduce-scatters its gradient, and the replicated leaves'
gradients are averaged over "fsdp" alone."""

import pytest

import sharded_parity as sp

pytestmark = [pytest.mark.torch, pytest.mark.timeout(240)]

MESH = {"fsdp": 2, "model": 2}


@pytest.fixture(scope="module")
def fsdp_tp(tmp_path_factory):
    tokens = sp.token_batches(seed=1)
    ref = sp.jax_llama_run(sp.LLAMA, MESH, "fsdp_tp", tokens)
    refs = {"fsdp_tp": ref}
    runs = {"fsdp_tp": {"fields": sp.LLAMA, "mesh": MESH, "strategy": "fsdp_tp",
                        "state": ref["state"], "tokens": tokens}}
    runs.update(sp.sgd_runs(dict(runs), refs, tokens))
    ranks = sp.port_llama_runs(4, runs, str(tmp_path_factory.mktemp("fsdp_tp")))
    return refs, ranks


def test_fsdp_tp_llama_trains_as_the_jax_trainer(fsdp_tp):
    refs, ranks = fsdp_tp
    sp.assert_matches_jax(ranks, "fsdp_tp", refs["fsdp_tp"])


def test_fsdp_tp_sgd_step_moves_each_parameter_as_the_jax_trainer(fsdp_tp):
    """The gradients' scale, which adam cancels (``sharded_parity``)."""
    refs, ranks = fsdp_tp
    sp.assert_step_matches_jax(ranks, "fsdp_tp_sgd", refs["fsdp_tp_sgd"])


def test_fsdp_tp_blocks_and_exchanges(fsdp_tp):
    _, ranks = fsdp_tp
    L = sp.LLAMA
    for r in ranks:
        run = r["fsdp_tp"]
        assert run["shard_shapes"]["layers.0.attn.q_proj.weight"] == (
            L["num_heads"] * L["head_dim"] // 2, L["hidden_dim"] // 2)
        assert run["shard_shapes"]["embedding"] == (L["vocab_size"] // 2, L["hidden_dim"] // 2)
        assert {"fsdp_all_gather", "fsdp_reduce_scatter", "tp_all_reduce",
                "tp_grad_all_reduce", "tp_all_gather"} <= set(run["traffic"])
    assert sorted((r["fsdp_tp"]["coord"]["fsdp"], r["fsdp_tp"]["coord"]["model"])
                  for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
