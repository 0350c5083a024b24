"""Module-level train functions for the port's process-runner tests.

A spawned runner process unpickles its train function by import path, so
these live in a module that imports neither jax nor the JAX package: a child
that imported the test module would load jax, and the sweep would prove
nothing about the port's own imports."""

import os
import signal
import time


def _claim(flag):
    """True for the one caller that creates ``flag`` (O_EXCL)."""
    try:
        os.close(os.open(flag, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        return False
    return True


def train_crash(lr, units, flag, reporter=None):
    """The first trial to claim ``flag`` kills its own runner process: no
    FINAL, no further heartbeats."""
    if _claim(flag):
        os._exit(42)
    return {"metric": 1.0 - (lr - 0.1) ** 2}


def train_wedge(lr, units, flag, reporter=None):
    """The first trial to claim ``flag`` SIGSTOPs its own runner process: it
    stays alive but frozen, heartbeat thread included, like a runner wedged
    in a native call. Only the driver's kill on heartbeat loss reaps it."""
    if _claim(flag):
        os.kill(os.getpid(), signal.SIGSTOP)
        os._exit(43)  # reached only if something resumed the process
    return {"metric": 1.0 - (lr - 0.1) ** 2}


def train_remote(lr, units, reporter=None):
    """A remote agent's trial (``python -m maggy_tpu_torch.runner --train
    torch_runner_fns:train_remote``): the closed form of the JAX package's
    ``tests/remote_train_module.py:train_fn``, with the agent's pid."""
    acc = 1.0 - ((lr - 0.1) ** 2 + ((units - 32) / 64.0) ** 2)
    if reporter is not None:
        reporter.broadcast(acc, step=0)
    return {"metric": acc, "pid": os.getpid()}


def train_remote_gated(lr, units, reporter=None):
    """``train_remote`` that first waits (at most 30 s) until two agent
    processes have each entered a trial, marked under
    MAGGY_TEST_AGENT_DIR: the sweep is then served by both agents, whatever
    their start-up skew."""
    gate = os.environ["MAGGY_TEST_AGENT_DIR"]
    open(os.path.join(gate, str(os.getpid())), "w").close()
    deadline = time.monotonic() + 30
    while len(os.listdir(gate)) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    return train_remote(lr, units, reporter)


# ------------------------------------------------------------ gloo worlds
#
# The port's distributed tests run their ranks as spawned processes of one
# gloo world each: at most one world a test module (started by a
# module-scoped fixture), a FileStore under the test's tmp dir for the
# rendezvous (no port to collide on), one intra-op thread a rank, every
# process joined with a bound and killed if it outlives it. Each rank's
# fatal signals dump its threads to ``rank<r>.stderr``, which a failed
# world's error quotes. A rank that wrote its result leaves with
# ``os._exit``: under load, a rank of a 4-rank world was seen to abort in
# the interpreter's teardown after its work ("Fatal Python error: Aborted",
# no Python frame), in native code the test does not exercise.

WORLD_TIMEOUT_S = 120


def _world_entry(fn, rank, world, out_dir, args):
    import faulthandler
    import pickle
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    log = open(os.path.join(out_dir, "rank{}.stderr".format(rank)), "w")
    faulthandler.enable(log)
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(out_dir, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=timedelta(seconds=WORLD_TIMEOUT_S))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, "rank{}.pkl".format(rank)), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, "rank{}.err".format(rank)), "w") as f:
            f.write(traceback.format_exc())
        raise
    log.close()
    os._exit(0)


def run_world(fn, world, out_dir, args=(), timeout=WORLD_TIMEOUT_S):
    """Run ``fn(rank, world, *args)`` on ``world`` spawned gloo ranks and
    return their results in rank order; raises with the ranks' tracebacks
    when one fails, and kills every rank still alive at ``timeout``."""
    import multiprocessing as mp
    import pickle

    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_world_entry, args=(fn, r, world, out_dir, args),
                         name="world-rank-{}".format(r)) for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(out_dir, "rank{}.err".format(r))
            if os.path.exists(err):
                errors.append(open(err).read())
            elif p.is_alive() or p.exitcode != 0:
                log = os.path.join(out_dir, "rank{}.stderr".format(r))
                errors.append("rank {}: {}{}".format(
                    r, "alive at the {} s bound".format(timeout) if p.is_alive()
                    else "exit code {}".format(p.exitcode),
                    "\n" + open(log).read()[-4000:] if os.path.exists(log) else ""))
        if errors:
            raise RuntimeError("gloo world failed:\n" + "\n".join(errors))
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, "rank{}.pkl".format(r)), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)


def _np(t):
    return t.detach().float().numpy()


def ring_rank(rank, world, cases):
    """Each case ({"q", "k", "v", "do": global numpy arrays, "causal",
    "impl", "fn": "ring" | "ulysses"}) on this rank's sequence shard:
    the output shard and the shards' gradients of sum(out * do)."""
    import torch

    from maggy_tpu_torch.parallel import (ShardingEnv, make_mesh, ring_attention,
                                          split_sequence, ulysses_attention)

    env = ShardingEnv(make_mesh({"seq": world}, device_type="cpu"))
    group = env.group("seq")
    out = {}
    for name, case in cases.items():
        q, k, v, do = (split_sequence(torch.tensor(case[x]), world, rank).clone()
                       for x in ("q", "k", "v", "do"))
        for t in (q, k, v):
            t.requires_grad_()
        fn = ring_attention if case["fn"] == "ring" else ulysses_attention
        try:
            o = fn(q, k, v, group, causal=case["causal"], impl=case["impl"])
        except ValueError as e:
            out[name] = {"error": str(e)}
            continue
        (o.float() * do).sum().backward()
        out[name] = {"out": _np(o), "dq": _np(q.grad), "dk": _np(k.grad), "dv": _np(v.grad)}
    return out


def llama_sp_rank(rank, world, fields, state, tokens, steps_tokens, lr, mesh_shape):
    """The ring Llama on a {"data", "seq"} mesh of ``world`` ranks: this
    rank's logits shard for ``tokens`` under the converted weights ``state``,
    then the mesh Trainer (dp_sp, adam(lr), the sharded next-token loss)
    over ``steps_tokens``: the averaged loss of each step."""
    import dataclasses

    import torch

    from maggy_tpu_torch.models import Llama, LlamaConfig
    from maggy_tpu_torch.ops import next_token_labels, sharded_next_token_loss
    from maggy_tpu_torch.parallel import ShardingEnv, make_mesh
    from maggy_tpu_torch.train import Trainer, adam

    env = ShardingEnv(make_mesh(mesh_shape, device_type="cpu"), rank, world)
    cfg = dataclasses.replace(LlamaConfig(dtype=torch.float32, **fields),
                              attention_impl="ring", seq_mesh=env.mesh)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(state)
    local = env.shard_batch({"tokens": torch.tensor(tokens, dtype=torch.long)})["tokens"]
    with torch.no_grad():
        logits = model(local)
    n_seq = env.axis_size("seq")
    trainer = Trainer(Llama(cfg, device="cpu"), adam(lr),
                      lambda out, b: sharded_next_token_loss(out[0], out[1], b["labels"], n_seq),
                      train_kwargs={"return_hidden": True}, env=env,
                      strategy="dp_sp").init(state_dict=state)
    losses = []
    for toks in steps_tokens:
        toks = torch.tensor(toks, dtype=torch.long)
        batch = trainer.place_batch({"inputs": (toks,), "labels": next_token_labels(toks)})
        losses.append(float(trainer.step(batch)))
    return {"coord": (env.axis_index("data"), env.axis_index("seq")), "logits": _np(logits),
            "losses": losses}


def zero_rank(rank, world, state, x, y, steps, lr):
    """A two-layer MLP on a {"data": world} mesh under "dp" and "dp_zero",
    and on an {"fsdp": world} mesh under "fsdp" (adam(lr), cross entropy,
    the same global batch each step): the averaged losses, the final
    parameters and the shapes of the Adam moments each rank holds."""
    import torch

    from maggy_tpu_torch.parallel import ShardingEnv, make_mesh
    from maggy_tpu_torch.train import Trainer, adam, cross_entropy_loss

    env = ShardingEnv(make_mesh({"data": world}, device_type="cpu"), rank, world)
    out = {}
    fsdp = ShardingEnv(make_mesh({"fsdp": world}, device_type="cpu"), rank, world)
    for strategy, mesh_env in (("dp", env), ("dp_zero", env), ("fsdp", fsdp)):
        model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.ReLU(),
                                    torch.nn.Linear(64, 2))
        trainer = Trainer(model, adam(lr), lambda o, b: cross_entropy_loss(o, b["labels"]),
                          env=mesh_env, strategy=strategy).init(state_dict=state)
        batch = trainer.place_batch({"inputs": (x,), "labels": y})
        losses = [float(trainer.step(batch)) for _ in range(steps)]
        moments = {name: tuple(trainer.optimizer.state[p]["exp_avg"].shape)
                   for group in trainer.optimizer.param_groups for p, name in
                   zip(group["params"], [n for n, _ in trainer.model.named_parameters()])}
        out[strategy] = {"losses": losses, "moments": moments,
                         "params": {k: _np(v) for k, v in trainer.model.state_dict().items()},
                         "shard_shapes": trainer.shard_shapes}
    return out


def mesh_model(kind, fields, device="cpu"):
    """A port model for ``mesh_train_rank``: "llama" (``LlamaConfig``
    fields, fp32), "bert" (``BertConfig`` fields, fp32), "resnet"
    (``ResNet`` keyword arguments) or "mlp" (a 32-64-2 Sequential)."""
    import torch

    from maggy_tpu_torch.models import BertConfig, BertEncoder, Llama, LlamaConfig, ResNet

    if kind in ("llama", "llama_chunked"):
        return Llama(LlamaConfig(dtype=torch.float32, **fields), device=device)
    if kind == "bert":
        return BertEncoder(BertConfig(dtype=torch.float32, **fields), device=device)
    if kind == "resnet":
        return ResNet(device=device, **fields)
    return torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.ReLU(), torch.nn.Linear(64, 2))


def mesh_loss(kind):
    """The loss of ``mesh_model(kind)``: "llama" the dense next-token loss
    of its logits, "llama_chunked" the vocab-chunked one of its hidden
    states and head (``train_kwargs={"return_hidden": True}``)."""
    from maggy_tpu_torch.ops import chunked_next_token_loss, next_token_loss
    from maggy_tpu_torch.train import cross_entropy_loss

    if kind == "llama":
        return lambda out, b: next_token_loss(out, b["tokens"])
    if kind == "llama_chunked":
        return lambda out, b: chunked_next_token_loss(out[0], out[1], b["tokens"], 24)
    return lambda out, b: cross_entropy_loss(out, b["labels"])


def mesh_train_rank(rank, world, runs):
    """Each run ({"model", "fields", "state", "mesh", "strategy", "opt",
    "lr", "batches", "train_kwargs", "aux"}) on its own mesh over this
    world: the mesh Trainer (adam(lr), or sgd(lr) with ``opt="sgd"``) from
    the whole ``state`` for one step a batch.
    Returns per run the averaged losses, the whole final state (gathered),
    the block shapes of the cut parameters and the exchanges made."""
    import torch

    from maggy_tpu_torch.parallel import ShardingEnv, collectives, make_mesh, sharded
    from maggy_tpu_torch.train import Trainer, adam

    out = {}
    for name, run in runs.items():
        env = ShardingEnv(make_mesh(run["mesh"], device_type="cpu"), rank, world)
        opt = _sgd(run["lr"]) if run.get("opt") == "sgd" else adam(run["lr"])
        trainer = Trainer(mesh_model(run["model"], run["fields"]), opt,
                          mesh_loss(run["model"]), train_kwargs=run.get("train_kwargs"),
                          has_aux_collections=run.get("aux", False), env=env,
                          strategy=run["strategy"]).init(
            state_dict={k: torch.as_tensor(v) for k, v in run["state"].items()})
        collectives.reset_traffic()
        losses = []
        for batch in run["batches"]:
            losses.append(float(trainer.step(trainer.place_batch(batch))))
        traffic = collectives.traffic()
        moments = {n: tuple(trainer.optimizer.state[p]["exp_avg"].shape)
                   for n, p in trainer.model.named_parameters()
                   if "exp_avg" in trainer.optimizer.state.get(p, {})}
        state = {k: _np(v) for k, v in sharded.full_state_dict(trainer.model).items()}
        out[name] = {"losses": losses, "state": state, "shard_shapes": trainer.shard_shapes,
                     "moments": moments,
                     "traffic": traffic,
                     "coord": {a: env.axis_index(a) for a in env.axis_names}}
    return out


def gather_scatter_rank(rank, world):
    """fsdp's gather and reduce-scatter on this rank's block of a seeded
    [8, 6] tensor: both results, and the transports ``traffic()`` named."""
    import torch

    from maggy_tpu_torch.parallel import collectives

    group = torch.distributed.group.WORLD
    full = torch.arange(48, dtype=torch.float32).reshape(8, 6) * (rank + 1)
    block = full[:, 3 * rank:3 * rank + 3].contiguous()
    collectives.reset_traffic()
    return {"gathered": _np(collectives._gather_dim(block, group, 1, "k_gather")),
            "scattered": _np(collectives._reduce_scatter_dim(full, group, 0, "k_scatter")),
            "transports": {k: v["transport"] for k, v in collectives.traffic().items()}}


def _tanh_stage(p, a):
    import torch

    return a + torch.tanh(a @ p["w"])


def _mse(out, tgt):
    return ((out - tgt) ** 2).mean()


def pipeline_rank(rank, world, cases):
    """Each case on its own mesh ({"mesh", "M"} and either "lm": a
    ``PipelinedLM`` from the JAX params ``params`` on ``tokens``, or "w"
    [n, D, D] stacked tanh stages with ``x`` and ``targets``): this rank's
    stage through ``pipeline_apply`` (the output, and for the tanh stages
    the GPipe loss and stage gradient by autograd, averaged over the
    data-like axes) and ``pipeline_1f1b_grads``; the rank's coordinates."""
    import math

    import torch

    from maggy_tpu_torch.parallel import ShardingEnv, collectives, make_mesh
    from maggy_tpu_torch.parallel import pipeline as pp

    out = {}
    for name, case in cases.items():
        env = ShardingEnv(make_mesh(case["mesh"], device_type="cpu"), rank, world)
        stage = pp.stage_param_sharding(env)
        res = {"coord": {a: env.axis_index(a) for a in env.axis_names}}
        try:
            if "lm" in case:
                lm = pp.PipelinedLM(*case["lm"], dtype=torch.float32, stages=[stage],
                                    device="cpu")
                lm.load_state_dict(pp.pipelined_lm_state(case["params"], [stage]))
                logits = lm.apply(torch.as_tensor(case["tokens"]), env,
                                  num_microbatches=case["M"])
                res["out"] = _np(logits.detach())
                # The stage's gradient of the mean square logit, averaged
                # over the data-like axes (each rank's rows are equal).
                logits.square().mean().backward()
                data = pp._data_group(env)
                grads = {k: getattr(lm, k).grad[0].clone() for k in pp.STAGE_LEAVES}
                for g in grads.values():
                    if data is not None:
                        collectives.all_reduce_(g, data)
                        g /= torch.distributed.get_world_size(data)
                res["grads"] = {k: _np(g) for k, g in grads.items()}
            else:
                M = case["M"]
                w = torch.tensor(case["w"][stage], requires_grad=True)
                x, tgt = torch.as_tensor(case["x"]), torch.as_tensor(case["targets"])
                y = pp.pipeline_apply(_tanh_stage, {"w": w}, x, env, num_microbatches=M)
                t_rows = pp._data_rows(pp._microbatches(tgt, M), env)
                y_mb = y.reshape(t_rows.shape)
                loss = torch.stack([_mse(y_mb[m], t_rows[m]) for m in range(M)]).mean()
                loss.backward()
                data = pp._data_group(env)
                grad, loss = w.grad.clone(), loss.detach().reshape(1)
                if data is not None:
                    dp = torch.distributed.get_world_size(data)
                    collectives.all_reduce_(grad, data)
                    collectives.all_reduce_(loss, data)
                    grad, loss = grad / dp, loss / dp
                l1, g1 = pp.pipeline_1f1b_grads(_tanh_stage, _mse, {"w": w.detach()}, x, tgt,
                                                env, num_microbatches=M)
                res.update(out=_np(y), gpipe_loss=float(loss[0]), gpipe_grad=_np(grad),
                           loss_1f1b=float(l1), grad_1f1b=_np(g1["w"]),
                           finite=math.isfinite(float(l1)))
        except ValueError as e:
            res["error"] = str(e)
        out[name] = res
    return out


# ----------------------------------------------- DistributedConfig workers


def _sgd(lr):
    import torch

    def factory(model):
        opt = torch.optim.SGD(model.parameters(), lr=lr)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 1.0)

    return factory


def dp_train_fn(sharding_env, reporter=None):
    """``tests/test_distributed.py``'s DP step on the port: linear regression
    (64 x 8, sgd 0.1, 60 steps), the batch sharded over "data" and the
    gradients averaged by the mesh Trainer. Also reports what this rank saw
    of the mesh: its batch rows, and the refusal of a mesh larger than the
    world."""
    import numpy as np
    import torch

    from maggy_tpu_torch.parallel import make_mesh
    from maggy_tpu_torch.train import Trainer

    import multiprocessing

    if multiprocessing.current_process().name != "MainProcess":
        torch.set_num_threads(1)  # a spawned rank; thread workers share the test's process
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 8)).astype(np.float32)
    y = X @ rng.normal(size=(8, 1)).astype(np.float32)
    model = torch.nn.Linear(8, 1, bias=False)
    trainer = Trainer(model, _sgd(0.1), lambda out, b: ((out - b["y"]) ** 2).mean(),
                      env=sharding_env, strategy="dp").init(
        state_dict={"weight": torch.zeros(1, 8)})
    batch = trainer.place_batch({"inputs": (X,), "y": y})
    loss = None
    for i in range(60):
        loss = trainer.step(batch)
        if reporter is not None and i % 20 == 0:
            reporter.broadcast(loss, step=i)
    n = sharding_env.axis_size("data")
    rows = batch["inputs"][0].numpy()
    shard = 64 // n * sharding_env.axis_index("data")
    seen = {"rows_match": bool(np.array_equal(rows, X[shard:shard + 64 // n])),
            "rows": int(rows.shape[0]), "axis_names": list(sharding_env.axis_names),
            "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
    try:
        make_mesh({"data": sharding_env.num_devices + 1}, device_type="cpu")
    except ValueError as e:
        seen["bad_mesh"] = str(e)
    out_dir = os.environ.get("MAGGY_TEST_DIST_DIR")
    if out_dir:
        import json

        with open(os.path.join(out_dir, "rank{}.json".format(sharding_env.process_index)),
                  "w") as f:
            json.dump({**seen, "pid": os.getpid(), "loss": float(loss)}, f)
    return {"metric": float(loss)}


def failing_rank1_train_fn(sharding_env, reporter=None):
    """Rank 1 raises; rank 0 waits in a collective rank 1 never joins (a
    world whose failed rank would hang its survivors until the group's
    timeout) after writing its pid where the test can find it. Rank 1
    raises only once rank 0's pid is written (or after 30 s), so the
    driver's kill always meets a rank 0 inside its train function."""
    import torch
    import torch.distributed as dist

    out_dir = os.environ["MAGGY_TEST_DIST_DIR"]
    path = os.path.join(out_dir, "pid{}".format(sharding_env.process_index))
    with open(path + ".tmp", "w") as f:
        f.write(str(os.getpid()))
    os.replace(path + ".tmp", path)
    if sharding_env.process_index == 1:
        deadline = time.monotonic() + 30
        while not os.path.exists(os.path.join(out_dir, "pid0")) and time.monotonic() < deadline:
            time.sleep(0.01)
        raise RuntimeError("rank 1 exploded")
    if dist.is_initialized():
        dist.all_reduce(torch.zeros(1))
    return {"metric": 0.0}


# ------------------------------------------------------------------- gangs


def gang_loss_rank(rank, world, spec, lrs):
    """A rank of a gang world computing ``gang.reference_gang_loss`` for
    each learning rate: the world of ``run_world`` is the gang's."""
    import torch

    from maggy_tpu_torch import gang
    from maggy_tpu_torch.fleet.agent import DEVICE_ENV

    os.environ[DEVICE_ENV] = "cpu"
    gang._WORLD = {"rank": rank, "world": world, "device": torch.device("cpu"),
                   "backend": "gloo"}
    info = {"chips": list(range(world)), "members": list(range(world)), "leader": 0,
            "mesh": spec["mesh"], "strategy": spec["strategy"]}
    losses = [gang.reference_gang_loss(lr, info) for lr in lrs]
    # Every rank is past its last collective before the world goes.
    torch.distributed.barrier()
    return losses


#: The tiny BERT gang's sequence length.
GANG_BERT_S = 64


def gang_bert_batch(step, n=8):
    """The global batch of step ``step`` of the tiny BERT gang: numpy, from
    a seed."""
    import numpy as np

    rng = np.random.default_rng(100 + step)
    tokens = rng.integers(2, 64, size=(n, GANG_BERT_S)).astype(np.int64)
    lens = rng.integers(8, GANG_BERT_S + 1, size=n)
    mask = np.arange(GANG_BERT_S)[None, :] < lens[:, None]
    labels = rng.integers(0, 2, size=n).astype(np.int64)
    return tokens, mask, labels


def train_gang_bert(x, gang, reporter, ctx):
    """A rank of a 2-chip "dp" gang training the tiny BERT of
    ``MAGGY_TEST_GANG_BERT`` ({"state", "fields", "out", "lr"}) for 3 steps
    on the mesh Trainer, from the saved weights; records its losses and
    world."""
    import json

    import torch
    import torch.distributed as dist

    from maggy_tpu_torch.models import BertConfig, BertEncoder
    from maggy_tpu_torch.train import Trainer, adamw, cross_entropy_loss

    del x, gang
    spec = json.loads(os.environ["MAGGY_TEST_GANG_BERT"])
    lr = spec["lr"]
    env = ctx.gang.sharding_env()
    trainer = Trainer(BertEncoder(BertConfig(dtype=torch.float32, **spec["fields"]),
                                  device="cpu"),
                      adamw(lr), lambda logits, b: cross_entropy_loss(logits, b["labels"]),
                      device="cpu", env=env, strategy="dp").init(
        state_dict=torch.load(spec["state"]))
    losses = []
    for step in range(3):
        tokens, mask, labels = gang_bert_batch(step)
        loss = trainer.step(trainer.place_batch({"inputs": (tokens, mask), "labels": labels}))
        losses.append(float(loss))
        reporter.broadcast(loss, step=step)
    with open(os.path.join(spec["out"], "rank{}.json".format(ctx.gang.process_id)), "w") as f:
        json.dump({"losses": losses, "world": dist.get_world_size(),
                   "backend": dist.get_backend(), "pid": os.getpid()}, f)
    return {"metric": losses[-1]}


def train_gang_failing(x, gang, ctx):
    """Rank 1 of a gang raises; rank 0 waits to be killed."""
    del x, gang
    if ctx.gang.process_id == 1:
        raise RuntimeError("rank 1 refuses")
    time.sleep(60)
    return {"metric": 0.0}


def train_gang_printing(x, gang, ctx):
    """Every rank of a gang prints its rank; the result is rank 0's."""
    del gang
    print("gang rank {} prints".format(ctx.gang.process_id))
    return {"metric": float(x)}


# ------------------------------------------------------------------ elastic


def train_elastic(lr, units, budget=1, reporter=None):
    """Marks (budget, the lease's chip count, pid) so a test can assert each
    trial ran on the lease its budget calls for (``tests/test_experiment.py:
    380-390``)."""
    from maggy_tpu_torch.core.runner_pool import lease_chips

    n = len(lease_chips())
    marker = os.path.join(os.environ["MAGGY_TPU_ELASTIC_DIR"],
                          "{}_{}_{}".format(int(budget), n, os.getpid()))
    with open(marker, "a") as f:
        f.write("x")
    time.sleep(0.05)
    if reporter is not None:
        reporter.broadcast(1.0 - (lr - 0.1) ** 2, step=0)
    return {"metric": 1.0 - (lr - 0.1) ** 2}
