"""Shared helpers of the sharded-training parity tests
(``test_torch_sharded.py``, ``test_torch_fsdp_tp.py``, ``test_torch_ep.py``):
the JAX Trainer's run on a mesh of virtual CPU devices, the port's mesh
Trainer on a gloo world of CPU rank processes from the weights the JAX
Trainer drew, and the comparison.

Both run fp32, adam(1e-2), ``next_token_loss`` and the same seeded token
batches, one step a batch. Tolerances: losses within rel 1e-4 (the
parity tolerance of ``test_torch_llama_sp.py``; partial sums over ranks
add in another order than GSPMD's), final parameters within 2e-3 absolute:
Adam divides each gradient by its running RMS, so where a gradient is near
zero its rounding moves the update by up to the learning rate times its
relative error (the port's own 2-rank tp run against its one-process run
differs by 3e-4 after three steps).

Adam cancels a gradient's scale, so a gradient summed where it should be
averaged (or reduce-scattered without the division) would pass those
checks. ``assert_step_matches_jax`` holds one plain SGD step (rate 1, so
each parameter moves by minus its gradient) to the JAX Trainer's: every
parameter's move within rel ``STEP_RTOL`` of JAX's, plus ``STEP_ATOL``
times the largest move of that parameter for the near-zero entries (fp32
partial sums over ranks, added in another order than GSPMD's).
"""

import itertools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax

import torch_runner_fns
from maggy_tpu.models.llama import Llama as JaxLlama
from maggy_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from maggy_tpu.parallel import make_mesh as jax_make_mesh
from maggy_tpu.train import Trainer as JaxTrainer
from maggy_tpu.train.trainer import _unbox_and_specs
from maggy_tpu.train.trainer import next_token_loss as jax_next_token_loss

LLAMA = dict(vocab_size=64, hidden_dim=32, intermediate_dim=64, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=8, max_seq_len=64, remat=False)
B, S, LR, STEPS = 4, 16, 1e-2, 3
LOSS_RTOL, PARAM_ATOL = 1e-4, 2e-3
SGD_LR, STEP_RTOL, STEP_ATOL = 1.0, 1e-3, 1e-4


def token_batches(seed=0, steps=STEPS, vocab=LLAMA["vocab_size"]):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(B, S)).astype(np.int64) for _ in range(steps)]


def jax_llama_run(fields, mesh_shape, strategy, batches, opt="adam"):
    """The JAX Trainer on ``mesh_shape`` (the first devices), with
    adam(LR) or (``opt="sgd"``) sgd(SGD_LR): the weights it drew (converted
    to the port's state dict), its losses, its final weights (converted)
    and its ``shardings``."""
    from maggy_tpu_torch.models.llama import flax_to_state_dict

    world = int(np.prod(list(mesh_shape.values())))
    mesh = jax_make_mesh(mesh_shape, devices=jax.devices()[:world])
    cfg = JaxLlamaConfig(dtype=jnp.float32, **fields)
    tx = optax.sgd(SGD_LR) if opt == "sgd" else optax.adam(LR)
    trainer = JaxTrainer(JaxLlama(cfg), tx,
                         lambda logits, batch: jax_next_token_loss(logits, batch["tokens"]),
                         mesh, strategy=strategy, warm_start=False)
    trainer.init(jax.random.key(0), (jnp.ones((1, S), jnp.int32),))
    first = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, trainer.variables["params"]))
    losses = [float(trainer.step(trainer.place_batch({"inputs": (t.astype(np.int32),),
                                                      "tokens": t.astype(np.int32)})))
              for t in batches]
    final = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, trainer.variables["params"]))
    return {"state": {k: v.numpy() for k, v in first.items()}, "losses": losses,
            "final": {k: v.numpy() for k, v in final.items()}, "shardings": trainer.shardings}


def port_llama_runs(world, runs, out_dir):
    """``torch_runner_fns.mesh_train_rank`` on a gloo world of ``world``
    ranks: {name: {"fields", "mesh", "strategy", "state", "tokens"}} ->
    each rank's results."""
    spec = {name: dict(model=r.get("model", "llama"), fields=r["fields"], state=r["state"],
                       mesh=r["mesh"], strategy=r["strategy"], opt=r.get("opt", "adam"),
                       lr=SGD_LR if r.get("opt") == "sgd" else LR,
                       train_kwargs=r.get("train_kwargs"),
                       batches=[{"inputs": (t,), "tokens": t} for t in r["tokens"]])
            for name, r in runs.items()}
    return torch_runner_fns.run_world(torch_runner_fns.mesh_train_rank, world, out_dir, (spec,))


def assert_matches_jax(ranks, name, ref):
    losses = ranks[0][name]["losses"]
    assert all(r[name]["losses"] == losses for r in ranks), [r[name]["losses"] for r in ranks]
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    for r in ranks:
        state = r[name]["state"]
        assert set(state) == set(ref["final"])
        for k, want in ref["final"].items():
            np.testing.assert_allclose(state[k], want, atol=PARAM_ATOL, err_msg=k)


def sgd_runs(runs, refs, batches, fields=None):
    """Each of ``runs`` again for one SGD step on ``batches[0]``, under the
    name ``<name>_sgd``, beside its JAX reference in ``refs``."""
    out = {}
    for name, run in runs.items():
        fields_ = fields or run["fields"]
        ref = jax_llama_run(fields_, run["mesh"], run["strategy"], batches[:1], opt="sgd")
        refs[name + "_sgd"] = ref
        out[name + "_sgd"] = dict(run, opt="sgd", state=ref["state"], tokens=batches[:1])
    return out


def assert_step_matches_jax(ranks, name, ref):
    """One SGD step: each parameter moved as the JAX Trainer moved it."""
    np.testing.assert_allclose(ranks[0][name]["losses"], ref["losses"], rtol=LOSS_RTOL)
    moved = 0
    for r in ranks:
        state = r[name]["state"]
        for k, start in ref["state"].items():
            want = ref["final"][k] - start
            got = state[k] - start
            np.testing.assert_allclose(got, want, rtol=STEP_RTOL,
                                       atol=STEP_ATOL * float(np.abs(want).max()), err_msg=k)
            moved += bool(np.abs(want).max() > 0)
    assert moved, "no parameter moved"


# ------------------------------------------------------------- placements


def marked(params):
    """``params`` with every leaf replaced by distinct consecutive numbers,
    so that a converted tensor names its Flax leaf and its layout."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    out, offset = [], 0
    for leaf in leaves:
        n = int(np.prod(np.shape(leaf)))
        out.append(np.arange(offset, offset + n, dtype=np.float64).reshape(np.shape(leaf)))
        offset += n
    return leaves, out, treedef.unflatten(out)


def jax_specs_by_port_name(variables, convert, mesh, strategy):
    """{port parameter name: the JAX Trainer's spec of its Flax leaf, in the
    port's dim order} for the boxed Flax ``variables`` on ``mesh``: the
    specs ``_unbox_and_specs`` gives (``trainer.shardings``), each leaf
    found by its marked values and its dims by the permutation the
    conversion applied."""
    _, shardings = _unbox_and_specs(variables, mesh, strategy)
    specs = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda s: tuple(s.spec), shardings["params"],
                               is_leaf=lambda s: hasattr(s, "spec")),
        is_leaf=lambda x: isinstance(x, tuple))
    params = nn.meta.unbox(variables)["params"]
    leaves, marks, tree = marked(params)
    starts = np.cumsum([0] + [int(np.prod(np.shape(x))) for x in leaves])
    out = {}
    for name, t in convert(tree).items():
        t = t.numpy()
        i = int(np.searchsorted(starts, float(t.reshape(-1)[0]), side="right")) - 1
        spec = tuple(specs[i]) + (None,) * (np.ndim(leaves[i]) - len(specs[i]))
        perm = next(p for p in itertools.permutations(range(t.ndim))
                    if np.array_equal(np.transpose(marks[i], p), t))
        out[name] = tuple(spec[d] for d in perm)
    return out


def moe_fields(**kw):
    return dict(LLAMA, num_experts=4, **kw)
