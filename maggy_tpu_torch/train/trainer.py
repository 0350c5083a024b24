"""Per-trial training harness: init + step, loss broadcast lazily.

Counterpart of ``maggy_tpu/train/trainer.py``'s `Trainer` for one device,
with its warm path (``maggy_tpu/train/trainer.py:408-641``): trials of one
program reuse one warm slot (``train/warm.py``). The JAX package keeps a
compiled executable per batch shape; here a trial's step is captured once
per batch-shape signature as a ``torch.cuda.CUDAGraph`` (forward, loss,
backward and optimizer step) after one eager warm-up step, and replayed;
the retired trial's module, optimizer and graphs (its **unit**) are
re-initialized in place for the next trial of the program. The step
returns the loss as an un-synced 0-d tensor, which the `Reporter`
materializes on its heartbeat thread; ``fit`` steps over batches with the
JAX Trainer's reporting and callbacks (``maggy_tpu/train/trainer.py:
622-640``).

On a mesh (``env``, a ``parallel.ShardingEnv``, with a ``strategy``) the
Trainer is the counterpart of ``init_train_state`` / ``make_train_step``
(``maggy_tpu/train/trainer.py:33-57, 315``). Parameters are placed as the
JAX Trainer places them: by the logical axes the model declares, through
``logical_axis_rules(strategy)`` (``sharding.logical_placements``); an
undeclared parameter is replicated. Every rank first draws (or loads) the
whole values, then keeps its block of each cut parameter
(``parallel/sharded.py``), and the optimizer is built over the blocks, so
fsdp's moments are sharded (ZeRO-3). Under fsdp the model gathers a block
before use and reduce-scatters its gradient; under tp and ep it computes
on its blocks (``models/llama.py``, ``bert.py``, ``moe.py``). The
gradients are averaged over the data-like and "seq" axes (the all-reduce
GSPMD emits in JAX: over the axes a reduce-scatter has not summed yet),
the loss returned is that average too, and a "zero" strategy part shards
the optimizer moments over "data" (ZeRO-1: each rank updates its slice of
every parameter whose leading dim, in the JAX package's layout, divides,
then the slices are gathered). A training-mode BatchNorm computes its
batch statistics over the data-like axes' whole batch, as GSPMD does
(``models/resnet.py``). Such a step runs eagerly, without the warm path: a
gloo collective cannot sit in a CUDA graph.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from torch.nn.parameter import is_lazy

from maggy_tpu_torch import device_gate
from maggy_tpu_torch.models import variables
from maggy_tpu_torch.train import warm


def cross_entropy_loss(logits, labels):
    """Mean softmax cross entropy in fp32 (``maggy_tpu`` `trainer.py:22-25`)."""
    return F.cross_entropy(logits.float(), labels.long())


def _on_meta(model: torch.nn.Module) -> bool:
    p = next(model.parameters(), None)
    return p is not None and p.is_meta


def materialize_lazy(model: torch.nn.Module, example_inputs) -> None:
    """Give a model's lazy modules (``nn.LazyLinear``) their shapes: one
    forward of ``example_inputs`` without gradients, on the meta device when
    the model is built there (no storage, no arithmetic), else on the
    model's device. A no-op for a model without lazy parameters."""
    if not any(is_lazy(p) for p in model.parameters()):
        return
    if example_inputs is None:
        raise ValueError("the model has lazy modules (nn.LazyLinear): pass example_inputs "
                         "to init() so that they get their shapes before the optimizer "
                         "and the captured step see them")
    meta = any(p.is_meta for p in model.parameters())
    device = torch.device("meta") if meta else next(
        (p.device for p in model.parameters() if not is_lazy(p)), torch.device("cpu"))
    inputs = _tree_map(lambda x: torch.empty_like(torch.as_tensor(x), device=device) if meta
                       else torch.as_tensor(x).to(device), tuple(example_inputs))
    with torch.no_grad(), variables.sowing_losses(), variables.mutable_buffers(False):
        model(*inputs)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _copy_into(static, batch) -> None:
    """Copy ``batch``'s array leaves into a graph's static inputs."""
    if isinstance(static, dict):
        for k, v in static.items():
            _copy_into(v, batch[k])
    elif isinstance(static, (tuple, list)):
        for s, b in zip(static, batch):
            _copy_into(s, b)
    elif isinstance(static, torch.Tensor) and static is not batch:
        static.copy_(torch.as_tensor(batch), non_blocking=True)


@contextlib.contextmanager
def _no_cyclic_gc():
    """No cyclic garbage collection during a capture. A dead graph that a
    reference cycle keeps (a dropped trainer's) is destroyed by the cyclic
    collector on whichever thread triggers it, and a graph destroyed on the
    capturing thread invalidates the capture (CUDAGraph reset: "operation
    not permitted when stream is capturing")."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def capture_step(slot, unit, device, batch, run):
    """Capture ``run(inputs)`` (one training step on copies of ``batch``'s
    arrays) as a CUDA graph into ``unit.pool`` under the capture gate: the
    capture records the step without running it, and the caller replays it.
    Returns (graph, inputs, run's outputs, the flash launches recorded), or
    None after an error, which clears ``slot.graph_ok``, is noted in the
    trial's compile record and counted."""
    from maggy_tpu_torch.ops import attention

    with device_gate.capture(), _no_cyclic_gc():
        t0 = time.perf_counter()
        try:
            # The memory pools of destroyed graphs are freed only by a
            # cache release, and the allocator cannot release during a
            # capture: an allocation that needs that memory would fail.
            torch.cuda.empty_cache()
            inputs = _tree_map(
                lambda x: torch.as_tensor(x).to(device, copy=True)
                if isinstance(x, (torch.Tensor, np.ndarray)) else x, batch)
            if unit.pool is None:
                unit.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            current = torch.cuda.current_stream(device)
            stream = torch.cuda.Stream(device=device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream), attention.recording_launches(stream) as launches:
                graph.capture_begin(pool=unit.pool, capture_error_mode="thread_local")
                try:
                    outputs = run(inputs)
                except BaseException:
                    try:
                        graph.capture_end()
                    except Exception:  # noqa: BLE001 - the body's error is the one to keep
                        pass
                    raise
                graph.capture_end()
            current.wait_stream(stream)
        except Exception as e:  # noqa: BLE001 - a failed capture steps eagerly, noted
            slot.graph_ok = False
            slot.graph_error = "{}: {}".format(type(e).__name__, e)[:500]
            warm.note_compile(graph_ok=False, graph_error=slot.graph_error)
            warm._count("graph_failures")
            return None
        warm.note_compile(compile_ms=(time.perf_counter() - t0) * 1e3)
        warm._count("graph_captures")
    return graph, inputs, outputs, dict(launches)


class _Graph:
    """One captured step: the graph, its static inputs, its loss and summed
    auxiliary loss outputs and the flash-kernel launches recorded at capture
    (added per replay)."""

    __slots__ = ("graph", "inputs", "loss", "aux_loss", "launches")

    def __init__(self, graph, inputs, loss, aux_loss, launches):
        self.graph, self.inputs, self.loss = graph, inputs, loss
        self.aux_loss, self.launches = aux_loss, launches


class _Unit:
    """What a retired trial hands the next trial of its program: the
    module, the optimizer with the factory arguments it was built from, and
    on the card the step's graphs per batch-shape signature (one memory
    pool), the shapes already warmed up eagerly, and the optimizer's state
    and learning-rate tensors that the graphs read."""

    __slots__ = ("model", "optimizer", "opt_kwargs", "graphs", "warmed", "pool",
                 "capturable", "state_ref", "groups_ref", "lr")

    def __init__(self, model, optimizer, opt_kwargs):
        self.model, self.optimizer, self.opt_kwargs = model, optimizer, opt_kwargs
        self.graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self.warmed: set = set()
        self.pool = None
        self.capturable = False
        self.state_ref = self.groups_ref = None
        self.lr: list = []

    def drop_graphs(self) -> None:
        """Drop the graphs, and with them their memory pool: once no graph
        holds it the allocator retires the pool, and a capture into its
        handle again trips the allocator (``use_count > 0``), so the next
        capture takes a fresh one."""
        self.graphs.clear()
        self.warmed.clear()
        self.pool = None

    def release(self) -> None:
        """Free the graphs and their memory pool: the pool's blocks return
        once no tensor allocated in it lives, and the gradients the capture
        allocated are such tensors."""
        self.drop_graphs()
        for p in self.model.parameters():
            p.grad = None

    def make_capturable(self, device: torch.device) -> None:
        """Prepare the optimizer for capture: each param group's learning
        rate in a 0-d tensor on the card (which the host rewrites for each
        step: its LambdaLR, and a trial that assigns a rate) and
        ``capturable=True`` with its step counts on the card. False for an
        optimizer without a capturable mode (its step would bake the rate
        into a graph)."""
        opt = self.optimizer
        if not all("capturable" in g for g in opt.param_groups):
            self.capturable = False
            return
        for group in opt.param_groups:
            lr = group["lr"]
            if not (isinstance(lr, torch.Tensor) and lr.device == device and lr.ndim == 0):
                group["lr"] = torch.tensor(float(lr), dtype=torch.float32, device=device)
            group["capturable"] = True
        for p, state in opt.state.items():
            step = state.get("step")
            if isinstance(step, torch.Tensor) and step.device != p.device:
                state["step"] = step.to(device=p.device, dtype=torch.float32)
        # Warm-up steps run capturable updates outside a capture on purpose.
        opt._warned_capturable_if_run_uncaptured = True
        self.state_ref, self.groups_ref = opt.state, opt.param_groups
        self.lr = [g["lr"] for g in opt.param_groups]
        self.capturable = True


class Trainer:
    """``Trainer(model, optimizer, loss_fn, device, train_kwargs, step_key,
    warm_start, has_aux_collections)``: ``optimizer`` is a factory ``model ->
    (optimizer, lr_scheduler)`` such as ``train.optim.adamw(...)`` (every
    parameter), ``train.lora.only_lora(adamw(...))`` (the adapters alone) or
    ``swept_transform(adamw, learning_rate=lr)``; ``loss_fn(outputs, batch)``
    returns a scalar, where ``outputs`` is what the model returns (a tuple
    such as ``(hidden, head)`` included). The model is called as
    ``model(*batch["inputs"], **train_kwargs)`` (dropout off, as the JAX
    Trainer calls its model without ``train``).

    **Auxiliary collections** (``maggy_tpu/train/trainer.py:271-310``;
    ``models/variables.py``). Every loss a module sows in the step's forward
    (MoE's load balancing) is added to the objective, always, and their sum
    is ``aux_loss`` after the step (None when nothing was sowed). A forward
    may update the model's buffers (BatchNorm's running statistics, JAX's
    ``batch_stats``, with ``train_kwargs={"train": True}``) only with
    ``has_aux_collections=True``, as a Flax ``apply`` needs them mutable;
    a captured step updates them in place on each replay.

    **Warm path (default).** The program key is derived as the JAX
    package's: the model's ``identity`` (type and frozen config), the
    device, ``loss_fn`` (by object: a per-call lambda never shares), the
    train kwargs' repr and the optimizer family of a ``swept_transform``
    factory. Trials whose key matches share one warm slot: a hit takes the
    unit a finished trial retired (``retire_to_warm_cache``) and writes this
    trial's initial values into it in place (weights from ``seed``, the
    optimizer's state zeroed, this trial's learning-rate schedule); a miss
    materializes the model (built on ``device="meta"``, it costs nothing
    until then) and builds the optimizer. A plain factory, or a module
    without an identity, gets a private slot: no sharing, the graphs and
    the telemetry kept. ``has_aux_collections`` joins either key.
    ``step_key`` replaces the derived key (trials with
    equal ``step_key``, identity, device, loss_fn and train kwargs share). A
    unit whose optimizer arguments differ from this trial's factory's gets
    a new optimizer, and its graphs are dropped, so no value of another
    trial is ever baked into a replayed step. On a hit ``trainer.model`` is
    the unit's module, not the one passed in. On the card each step of a
    batch-shape signature after the first is replayed from a CUDA graph; a
    capture that raises clears the slot's ``graph_ok``, is noted in the
    trial's compile record (``graph_ok``, ``graph_error``) and counted
    (``graph_failures``), and the slot's trials then step eagerly. On the
    CPU nothing is captured. ``warm_start=False`` (or the executor's
    ``config.warm_start=False``) is the eager build-per-trial path: no
    slot, no graph."""

    def __init__(self, model: torch.nn.Module, optimizer: Callable, loss_fn: Callable,
                 device="cuda", train_kwargs: Optional[Dict[str, Any]] = None,
                 step_key: Optional[tuple] = None, warm_start: Optional[bool] = None,
                 has_aux_collections: bool = False, env=None, strategy: str = "dp"):
        self.env = env
        self.strategy = strategy
        self._zero, self._zero_rows = False, []
        self.shard_shapes: Dict[str, tuple] = {}
        if env is not None:
            from maggy_tpu_torch.parallel import sharding

            sharding.logical_axis_rules(strategy)  # raises on an unknown strategy
            self._zero = sharding.validate_zero_strategy(env.mesh, strategy)
            device, warm_start = env.device, False
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda') needs a CUDA device; pass "
                               "device='cpu' to train on the CPU")
        self.model = model if _on_meta(model) else model.to(self.device)
        self.optimizer_factory = optimizer
        self.loss_fn = loss_fn
        self.train_kwargs = dict(train_kwargs or {})
        self.has_aux_collections = bool(has_aux_collections)
        self.aux_loss: Optional[torch.Tensor] = None
        self.optimizer = None
        self.scheduler = None
        self._warm_enabled = warm.enabled() if warm_start is None else bool(warm_start)
        self._slot = self._resolve_slot(step_key) if self._warm_enabled else None
        self._unit: Optional[_Unit] = None
        warm.register_trainer(self)

    def _resolve_slot(self, step_key) -> warm.WarmSlot:
        identity = getattr(self.model, "identity", None)
        tkr = repr(sorted(self.train_kwargs.items()))
        family = warm.opt_family(self.optimizer_factory)
        aux = self.has_aux_collections
        if step_key is not None:
            key = ("manual", step_key, self.model if identity is None else identity,
                   self.device, aux, self.loss_fn, tkr)
        elif family is not None and identity is not None:
            key = ("auto", identity, self.device, aux, self.loss_fn, tkr, family)
        else:
            return warm.WarmSlot(None)
        try:
            return warm.warm_cache().slot(key)[0]
        except TypeError:
            # An unhashable identity: the default path must not reject a
            # model that trains, so it degrades to a private slot.
            return warm.WarmSlot(None)

    # ------------------------------------------------------------- init

    def init(self, seed: Optional[int] = None,
             state_dict: Optional[Dict[str, torch.Tensor]] = None,
             example_inputs=None) -> "Trainer":
        """Fresh parameters — from ``state_dict`` when given, else the
        model's ``init_weights`` under a generator seeded with ``seed`` — and
        a fresh optimizer state, built, or on a warm hit written into the
        retired unit in place. ``example_inputs`` (the model's positional
        inputs, e.g. ``batch["inputs"]``) give a model's lazy modules their
        shapes (``materialize_lazy``), as the JAX Trainer's init traces the
        model on them. Inside a trial its host time is noted as the trial's
        ``init_ms`` and its outcome as ``warm``
        (``maggy_tpu/train/trainer.py:497-528``)."""
        t0 = time.perf_counter()
        self._unit = None
        unit = None if self._slot is None else self._slot.entry.take_retired()
        if unit is not None:
            self._adopt(unit, seed, state_dict)
        else:
            materialize_lazy(self.model, example_inputs)
            self._build(seed, state_dict)
        if self._slot is not None:
            warm.record_warm_event(unit is not None)
        warm.note_compile(warm=unit is not None, init_ms=(time.perf_counter() - t0) * 1e3)
        return self

    def _init_values(self, seed, state_dict) -> None:
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0 if seed is None else int(seed))
            self.model.init_weights(gen)

    def _build(self, seed, state_dict) -> None:
        if _on_meta(self.model):
            self.model = self.model.to_empty(device=self.device)
        self._init_values(seed, state_dict)
        if self.env is not None:
            self._shard_on_mesh()
        self.optimizer, self.scheduler = self.optimizer_factory(self.model)
        if self.env is not None:
            self._place_zero()
        if self._slot is not None:
            self._unit = _Unit(self.model, self.optimizer,
                               getattr(self.optimizer_factory, "kwargs", None))
            if self.device.type == "cuda":
                self._unit.make_capturable(self.device)

    def _adopt(self, unit: _Unit, seed, state_dict) -> None:
        self.model = unit.model
        self._init_values(seed, state_dict)
        factory = self.optimizer_factory
        kwargs = getattr(factory, "kwargs", None)
        if hasattr(factory, "scheduler") and kwargs is not None and kwargs == unit.opt_kwargs:
            self.scheduler = warm.rebind_hyperparams(unit.optimizer, factory)
            self.optimizer = unit.optimizer
        else:
            # Other optimizer arguments than the unit's: a new optimizer,
            # whose tensors no graph has read.
            self.optimizer, self.scheduler = factory(self.model)
            unit.optimizer, unit.opt_kwargs = self.optimizer, kwargs
            unit.drop_graphs()
            if self.device.type == "cuda":
                unit.make_capturable(self.device)
        self._unit = unit

    def retire_to_warm_cache(self) -> None:
        """Hand this trainer's unit (module, optimizer, graphs) to its warm
        slot, where the next trial of the program takes it and writes its
        own values into it; a private slot has no next trial, so its unit's
        graphs are freed instead. Called by the executor's trial scope at
        trial end; after it the trainer holds no model or optimizer."""
        slot, unit = self._slot, self._unit
        if slot is None or unit is None:
            return
        if slot.key is None:
            unit.release()
        else:
            slot.entry.store_retired(unit)
        self._unit = None
        self.model = self.optimizer = self.scheduler = None

    # ------------------------------------------------------------- step

    def place_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """numpy/tensor leaves of ``batch`` -> tensors on the device; on a
        mesh, this rank's slice of the global batch (``ShardingEnv.
        shard_batch``)."""
        if self.env is not None:
            return self.env.shard_batch(batch)

        def put(x):
            if isinstance(x, (tuple, list)):
                return type(x)(put(v) for v in x)
            t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
            return t.to(self.device, non_blocking=True)

        return {k: put(v) for k, v in batch.items()}

    def _objective(self, batch):
        """(objective, summed auxiliary losses or None): ``loss_fn`` of the
        model's outputs plus each loss sowed in the forward, in the order
        sowed. Only the forward runs inside the sowing block, so a layer
        that rematerialization runs again in the backward sows nothing. On
        a mesh, batch statistics are over the data-like axes."""
        stats = None if self.env is None else self.env.data_group
        with variables.sowing_losses() as sown, \
                variables.mutable_buffers(self.has_aux_collections), \
                variables.batch_stats_over(stats):
            out = self.model(*batch["inputs"], **self.train_kwargs)
        loss, aux = self.loss_fn(out, batch), None
        for leaf in sown:
            loss = loss + leaf
            aux = leaf if aux is None else aux + leaf
        return loss, aux

    def _eager_step(self, batch) -> torch.Tensor:
        loss, aux = self._objective(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        self.aux_loss = None if aux is None else aux.detach()
        return loss.detach()

    def fit(self, batches, reporter=None, report_every: int = 1, callbacks=()) -> float:
        """Step over ``batches`` (dicts of arrays or tensors, placed on the
        device); returns the final loss. Every ``report_every``-th step's
        loss is broadcast unsynced (the ``Reporter`` reads it on its
        heartbeat thread), and each callback (``callbacks.BatchEnd``-style)
        is called as ``cb({"loss": loss}, step=i)`` with the same tensor
        (``maggy_tpu/train/trainer.py:622-640``)."""
        loss = None
        for i, batch in enumerate(batches):
            loss = self.step(self.place_batch(batch))
            if reporter is not None and i % report_every == 0:
                reporter.broadcast(loss, step=i)
            for cb in callbacks:
                cb({"loss": loss}, step=i)
        return float(loss) if loss is not None else float("nan")

    # ------------------------------------------------------------- mesh

    def _shard_on_mesh(self) -> None:
        """Place the parameters by the model's logical axes and the
        strategy's rules: every rank drew the same values from the same
        seed, so a replicated parameter is placed already, and a cut one is
        replaced by this rank's block (``sharded.shard_module``; the whole
        values are freed). ``shard_shapes`` maps each cut parameter to its
        block's shape."""
        from maggy_tpu_torch.parallel import sharded, sharding

        specs = sharding.logical_placements(self.model, self.env.mesh, self.strategy)
        self.shard_shapes = sharded.shard_module(self.model, self.env, specs)

    def _place_zero(self) -> None:
        """Under "zero" the optimizer's param groups get each rank's slice
        of every parameter that ``zero_placements`` shards over "data"
        (views of the parameter's storage), so the moments it creates are
        that slice's alone."""
        from torch.distributed.tensor import Shard

        from maggy_tpu_torch.parallel import sharding

        env = self.env
        self._zero_rows = []
        n, i = env.axis_size("data"), env.axis_index("data")
        if not self._zero or n == 1:
            return
        names = {id(p): name for name, p in self.model.named_parameters()}
        data_axis = env.axis_names.index("data")
        for group in self.optimizer.param_groups:
            params = []
            for p in group["params"]:
                placement = sharding.zero_placements(env.mesh, names[id(p)], p.shape,
                                                     self.strategy)[data_axis]
                if isinstance(placement, Shard):
                    dim = placement.dim
                    rows = p.shape[dim] // n
                    shard = torch.nn.Parameter(p.detach().narrow(dim, i * rows, rows))
                    self._zero_rows.append((p, shard, dim, i * rows, rows))
                    p = shard
                params.append(p)
            group["params"] = params

    def _reduce(self, tensors, kind: str, summed=()) -> None:
        """Average ``tensors`` in place over the mesh's reduce axes (the
        data-like axes and "seq"): summed over those of them not in
        ``summed`` (axes a reduce-scatter already summed them over), one flat
        buffer a dtype, each all-reduce counted under ``kind``
        (``collectives.traffic``), then divided by the reduce axes' size."""
        from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

        from maggy_tpu_torch.parallel import collectives

        env = self.env
        n = math.prod(env.axis_size(a) for a in env.reduce_axes)
        if n == 1:
            return
        group = env.group(*(a for a in env.reduce_axes if a not in summed))
        by_dtype: Dict[torch.dtype, list] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = _flatten_dense_tensors(ts)
            if group is not None:
                collectives.all_reduce_(flat, group, kind=kind)
            flat /= n
            for t, reduced in zip(ts, _unflatten_dense_tensors(flat, ts)):
                t.copy_(reduced)

    def _mesh_step(self, batch) -> torch.Tensor:
        """The eager distributed step: backward, gradients averaged over the
        reduce axes, the update (under "zero" each rank's slices, gathered
        after), and the loss averaged like the gradients."""
        from maggy_tpu_torch.parallel import collectives

        loss, aux = self._objective(batch)
        # The model's: under "zero" the optimizer holds slices, not these.
        self.model.zero_grad(set_to_none=True)
        loss.backward()
        # Every rank reduces the same buffers: a trained parameter without a
        # gradient here contributes zeros. A gradient that fsdp's
        # reduce-scatter summed over an axis is not summed over it again.
        from maggy_tpu_torch.parallel import sharded

        grads: Dict[tuple, list] = {}
        for p in self.model.parameters():
            if p.requires_grad:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                summed = tuple(a for a in sharded.shard_groups(p)
                               if a in sharded.GATHERED_AXES)
                grads.setdefault(summed, []).append(p.grad)
        for summed, gs in grads.items():
            self._reduce(gs, "grad_all_reduce", summed)
        for p, shard, dim, start, rows in self._zero_rows:
            shard.grad = p.grad.narrow(dim, start, rows)
        self.optimizer.step()
        self.scheduler.step()
        group = self.env.group("data")
        for p, shard, dim, _, _ in self._zero_rows:
            with torch.no_grad():
                p.copy_(torch.cat(collectives.all_gather(shard.detach(), group), dim=dim))
        self.aux_loss = None if aux is None else aux.detach()
        loss = loss.detach().float().reshape(1)
        self._reduce([loss], "loss_all_reduce")
        return loss[0]

    def step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One optimizer step; returns the loss (lazy 0-d tensor)."""
        if self.env is not None:
            return self._mesh_step(batch)
        if self.device.type != "cuda":
            return self._eager_step(batch)
        graph = self._graph_for(batch)
        with device_gate.step():
            if graph is None:
                return self._eager_step(batch)
            _copy_into(graph.inputs, batch)
            graph.graph.replay()
            if graph.launches:
                from maggy_tpu_torch.ops import attention

                attention.add_launches(graph.launches)
            warm._count("graph_replays")
            loss = graph.loss.clone()
            self.aux_loss = None if graph.aux_loss is None else graph.aux_loss.clone()
            self.scheduler.step()
            return loss

    def _graph_for(self, batch) -> Optional[_Graph]:
        """The unit's graph for the batch's shape, captured now if the shape
        had its eager warm-up step; None for an eager step: no unit or no
        capturable optimizer, the shape's first step (it creates the
        optimizer's state and loads every kernel the capture records), or a
        failed capture."""
        unit = self._unit
        if unit is None or not unit.capturable or not self._slot.graph_ok:
            return None
        self._check_unit(unit)
        key = warm.shape_key(batch)
        graph = unit.graphs.get(key)
        if graph is not None:
            unit.graphs.move_to_end(key)
            return graph
        if key in unit.warmed:
            graph = self._capture(unit, key, batch)
        else:
            unit.warmed.add(key)
        if graph is None:
            warm._count("eager_steps")
        return graph

    def _check_unit(self, unit: _Unit) -> None:
        """Hold the unit's graphs to the tensors they read: an optimizer
        that was replaced or reloaded (``load_state_dict`` swaps its state
        tensors) drops them, to be captured again; a learning rate assigned
        as a number is written into the graphs' tensor."""
        opt = self.optimizer
        if opt is not unit.optimizer or opt.state is not unit.state_ref \
                or opt.param_groups is not unit.groups_ref:
            unit.optimizer = opt
            unit.drop_graphs()
            unit.make_capturable(self.device)
        for group, lr in zip(opt.param_groups, unit.lr):
            value = group["lr"]
            if value is not lr:
                if isinstance(value, torch.Tensor):
                    lr.copy_(value)
                else:
                    lr.fill_(float(value))
                group["lr"] = lr

    def _capture(self, unit: _Unit, key, batch) -> Optional[_Graph]:
        """Capture one step for ``key``'s batch shape into the unit's memory
        pool (``capture_step``); on an error the optimizer's gradients are
        dropped and None returned."""
        def run(inputs):
            loss, aux = self._objective(inputs)
            loss.backward()
            self.optimizer.step()
            return loss, aux

        self.optimizer.zero_grad(set_to_none=True)
        captured = capture_step(self._slot, unit, self.device, batch, run)
        if captured is None:
            self.optimizer.zero_grad(set_to_none=True)
            return None
        graph, inputs, (loss, aux), launches = captured
        captured = _Graph(graph, inputs, loss.detach(), None if aux is None else aux.detach(),
                          launches)
        unit.graphs[key] = captured
        while len(unit.graphs) > warm.PER_SLOT_SHAPES:
            unit.graphs.popitem(last=False)
        return captured
