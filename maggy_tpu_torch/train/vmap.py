"""Vectorized lanes: K trials of one program trained as one step.

Counterpart of ``maggy_tpu/train/vmap.py`` (``VmapTrainer``, ``:81-341``).
A small model leaves the card idle between a trial's kernels; K trials that
differ only in their learning rate train in lockstep instead, as ONE step
over stacked state:

- **State.** Each parameter and each buffer (BatchNorm's running
  statistics, JAX's ``batch_stats``) is one stacked tensor ``[K, ...]``;
  lane i's values are its row. Every lane starts from one scalar init (the
  seed or state dict a scalar ``Trainer`` of the program would start from),
  written into each row (JAX ``:153-193``).
- **The step** is ``torch.func.vmap(torch.func.grad_and_value(objective),
  in_dims=(0, 0, None))`` over ``torch.func.functional_call`` of the unit's
  module with lane i's parameter and buffer rows: the batch is broadcast
  across lanes, and the gradients land in a preallocated stacked buffer.
  The buffers enter as vmapped inputs, not module state, so a forward with
  ``has_aux_collections`` (``models/variables.py``) updates each lane's
  running statistics in place in its own row and never the module's
  unbatched buffers; each loss a module sows joins its lane's objective
  inside the vmapped function (JAX ``build_step_fn``, ``trainer.py:
  286-310``), and their sum is ``aux_loss`` [K] after the step. The flash
  kernels run under it through their batching rules (``ops/attention.py``),
  one launch for all K lanes.
- **The optimizer** is the scalar path's ``torch.optim.AdamW`` with one
  param group a lane: lane i's parameters are ``nn.Parameter`` views of the
  stacked rows, their ``.grad`` views of the gradient buffer's, and its
  learning rate the group's (on the card a 0-d tensor, ``capturable``), set
  each step from the lane's own schedule. So lane i's update is the scalar
  path's arithmetic on its row, and ``step()`` updates the stacked storage
  in place. Only ``learning_rate`` may differ between lanes: AdamW's betas,
  eps and weight decay are Python floats, baked into the family by value
  (``train/optim.py``, ROADMAP queue 3 item 11).
- **On the card** a batch shape's first step runs eagerly and later steps
  replay a CUDA graph captured once into the unit's memory pool, through
  the process's capture gate (``device_gate``). Everything the graph writes is written in
  place (parameters, buffers, optimizer state, gradient buffer, learning
  rates): a rebound tensor would leave the replayed graph writing the old
  one.
- **Masking** (``mask_lane``) retires a lane on the host: its row keeps
  computing, the other lanes' values do not move by a bit, and goodput
  bills the masked tail to ``lane_idle``. ``refill_lane`` writes a fresh
  trial's init, a zeroed optimizer state and its rate into the lane's row
  in place; the captured graphs stay valid.
- **Warm path.** A finished block retires its K-lane unit (module, stacked
  state, optimizer, graphs) into its program's ``WarmSlot.vmap_entry``; the
  next block of the program and K writes its own initial values into it in
  place, the stacked buffers reset with the parameters (the counterpart of
  JAX's donated broadcast re-init, ``:195-212``). ``has_aux_collections``
  joins the program key, as it joins the scalar one.

- **A LoRA family** (``lambda learning_rate: only_lora(adamw(
  learning_rate))``, ``train/lora.py``): only the adapters are stacked and
  trained. The frozen base is frozen and cast to the compute dtype as
  ``only_lora`` does for a scalar trial, and each frozen parameter is held
  ONCE, unstacked: the module's own tensor, with no gradient buffer and no
  optimizer state, entering the vmapped step with ``in_dims`` None. The
  port's ``only_lora`` never moves the base, so every lane's base is the
  same tensor, and holding it once computes what stacking would. A LoRA
  block's lanes share that base, so a refill starts from the block's own
  init. The family carries ``only_lora``, so a LoRA block never takes a
  full-training unit, nor the reverse.
- **Rematerialization** (``cfg.remat``) runs under the step's transforms
  (``models/remat.py``), and so does the vocab-chunked loss
  (``ops/losses.py``, whose batching rule folds the lanes into rows over
  the unbatched frozen head), so a Llama LoRA sweep trains in lanes as it
  does in scalar trials. A model with lazy modules (``nn.LazyLinear``)
  gets its shapes from ``init(..., example_inputs=...)``, as ``Trainer``'s.

Only the learning rate differs between lanes (JAX ``:81-90``):
``lora_rank`` and ``lora_alpha`` are model settings, part of the program,
so a swept ``lora_alpha`` cannot ride the lane axis.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from maggy_tpu_torch import device_gate
from maggy_tpu_torch.models import variables
from maggy_tpu_torch.train import warm
from maggy_tpu_torch.train.optim import swept_transform
from maggy_tpu_torch.train.trainer import _copy_into, _on_meta, capture_step, materialize_lazy


def stack_trees(trees: Sequence[Any]):
    """Stack K congruent trees (dicts, lists, tuples of tensors) along a new
    leading lane axis (JAX ``:45-50``)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(stack_trees([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack([torch.as_tensor(t) for t in trees])


def _set_lr(group, value: float) -> None:
    """A param group's rate, in place where it is a tensor (a captured
    graph reads it)."""
    if isinstance(group["lr"], torch.Tensor):
        group["lr"].fill_(value)
    else:
        group["lr"] = value


def rebind_hyperparams_stacked(optimizer, lane_hparams: List[Dict[str, Any]]):
    """Write each lane's ``learning_rate`` into its param group's rate: the
    counterpart of JAX ``:53-78``, whose injected hyperparameters ride the
    stacked optimizer state."""
    for group, hp in zip(optimizer.param_groups, lane_hparams):
        value = hp.get("learning_rate")
        if value is not None and not callable(value):
            _set_lr(group, float(value))
    return optimizer


class _LaneSchedules:
    """One learning-rate schedule a lane over the optimizer's param groups:
    group i's rate at lane i's update t is ``schedules[i](t)``, what the
    scalar path's LambdaLR (base rate 1) gives a trial. A refilled lane's
    count restarts at 0."""

    def __init__(self, optimizer, schedules: List[Callable[[int], float]]):
        self.groups = optimizer.param_groups
        self.schedules = list(schedules)
        self.counts = [0] * len(self.schedules)
        for i in range(len(self.schedules)):
            self._write(i)

    def _write(self, i: int) -> None:
        _set_lr(self.groups[i], float(self.schedules[i](self.counts[i])))

    def step(self) -> None:
        for i in range(len(self.schedules)):
            self.counts[i] += 1
            self._write(i)

    def reset_lane(self, i: int, schedule: Callable[[int], float]) -> None:
        self.schedules[i], self.counts[i] = schedule, 0
        self._write(i)


class _LaneGraph:
    """One captured K-lane step: the graph, its static inputs, its [K] loss
    and summed auxiliary loss outputs and the flash-kernel launches
    recorded at capture."""

    __slots__ = ("graph", "inputs", "losses", "aux", "launches")

    def __init__(self, graph, inputs, losses, aux, launches):
        self.graph, self.inputs, self.losses = graph, inputs, losses
        self.aux, self.launches = aux, launches


class _VmapUnit:
    """What a retired block hands the next block of its program and K: the
    module (the scalar init's target), the stacked trained parameters,
    buffers and gradient buffer, the frozen parameters (the module's own,
    unstacked; none outside a LoRA family), the per-lane optimizer and the
    step's graphs by batch shape."""

    __slots__ = ("model", "stacked", "frozen", "buffers", "grads", "lane_params", "optimizer",
                 "opt_kwargs", "graphs", "warmed", "pool")

    def __init__(self, model, stacked, frozen, buffers, grads, lane_params, optimizer,
                 opt_kwargs):
        self.model, self.stacked, self.buffers, self.grads = model, stacked, buffers, grads
        self.frozen = frozen
        self.lane_params, self.optimizer, self.opt_kwargs = lane_params, optimizer, opt_kwargs
        self.graphs: "OrderedDict[tuple, _LaneGraph]" = OrderedDict()
        self.warmed: set = set()
        self.pool = None

    def release(self) -> None:
        self.graphs.clear()
        self.warmed.clear()


class VmapTrainer:
    """``VmapTrainer(model, opt_factory, lane_hparams, loss_fn, device,
    train_kwargs, warm_start, has_aux_collections, **statics)``: K =
    ``len(lane_hparams)`` lanes of the family ``swept_transform(opt_factory,
    **statics, **hp_i)`` (``adam``, ``adamw``, or a factory of
    ``only_lora`` builders such as ``lambda learning_rate:
    only_lora(adamw(learning_rate))``), e.g. ``lane_hparams=
    [{"learning_rate": 1e-3}, ...]``. ``loss_fn(outputs, batch)`` and the
    model call are ``Trainer``'s. ``step(batch)`` returns the lazy ``[K]``
    loss tensor; ``has_aux_collections`` lets the forward update the
    stacked buffers (BatchNorm with ``train_kwargs={"train": True}``). The
    warm slot is the scalar ``Trainer``'s of the same program; see the
    module docstring."""

    def __init__(self, model: torch.nn.Module, opt_factory: Callable, lane_hparams,
                 loss_fn: Callable, device="cuda", train_kwargs: Optional[Dict[str, Any]] = None,
                 warm_start: Optional[bool] = None, has_aux_collections: bool = False,
                 **statics: Any):
        if not lane_hparams:
            raise ValueError("need at least one lane")
        names = sorted(lane_hparams[0])
        if any(sorted(hp) != names for hp in lane_hparams):
            raise ValueError(
                "every lane must sweep the SAME hyperparameter names (one program family); "
                "got {}".format([sorted(hp) for hp in lane_hparams]))
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VmapTrainer(device='cuda') needs a CUDA device; pass "
                               "device='cpu' to train on the CPU")
        self.model = model if _on_meta(model) else model.to(self.device)
        self.opt_factory = opt_factory
        self.statics = dict(statics)
        self.lane_hparams = [dict(hp) for hp in lane_hparams]
        self.k = len(self.lane_hparams)
        self.loss_fn = loss_fn
        self.train_kwargs = dict(train_kwargs or {})
        self.has_aux_collections = bool(has_aux_collections)
        self.aux_loss: Optional[torch.Tensor] = None
        builds = [self._build_for(hp) for hp in self.lane_hparams]
        self.family = warm.opt_family(builds[0])
        for build in builds:
            if not (hasattr(build, "schedule") and hasattr(build, "kwargs")):
                raise ValueError("VmapTrainer needs an optimizer factory like train.adam or "
                                 "train.adamw (a builder with .schedule and .kwargs)")
            if warm.opt_family(build) != self.family or build.kwargs != builds[0].kwargs \
                    or getattr(build, "freeze", None) is not getattr(builds[0], "freeze", None):
                raise ValueError("every lane must share the block's optimizer family; only "
                                 "learning_rate may differ between lanes")
        self._builds = builds
        # A LoRA family (train.lora.only_lora): freezes the base and names
        # the parameters it trains.
        self._freeze = getattr(builds[0], "freeze", None)
        self._warm_enabled = warm.enabled() if warm_start is None else bool(warm_start)
        self._slot = self._resolve_slot() if self._warm_enabled else None
        self._entry = None if self._slot is None else self._slot.vmap_entry(("vmap", self.k),
                                                                            self.k)
        self._unit: Optional[_VmapUnit] = None
        self.optimizer = None
        self.scheduler: Optional[_LaneSchedules] = None
        self._mask = [False] * self.k
        self._seed: Optional[int] = None
        self._state_dict = None
        self._sown = False
        warm.register_trainer(self)

    def _build_for(self, hparams):
        return swept_transform(self.opt_factory, **self.statics, **hparams)

    def _resolve_slot(self) -> warm.WarmSlot:
        """The scalar ``Trainer``'s slot of the same program (JAX ``:120-131``)."""
        identity = getattr(self.model, "identity", None)
        if self.family is None or identity is None:
            return warm.WarmSlot(None)
        tkr = repr(sorted(self.train_kwargs.items()))
        key = ("auto", identity, self.device, self.has_aux_collections, self.loss_fn, tkr,
               self.family)
        try:
            return warm.warm_cache().slot(key)[0]
        except TypeError:
            return warm.WarmSlot(None)

    # ------------------------------------------------------------- init

    def _scalar_init(self, model, seed, state_dict) -> None:
        """The values a scalar cold trial of the program starts from, in
        ``model``'s own parameters (``Trainer._init_values``)."""
        if state_dict is not None:
            model.load_state_dict(state_dict)
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0 if seed is None else int(seed))
            model.init_weights(gen)

    def init(self, seed: Optional[int] = None,
             state_dict: Optional[Dict[str, torch.Tensor]] = None,
             example_inputs=None) -> "VmapTrainer":
        """Stacked K-lane init from one scalar init (``seed`` or
        ``state_dict``), built, or on a warm hit written into the retired
        K-lane unit in place: parameters and buffers, optimizer state
        zeroed, the lanes' learning rates (JAX ``:153-193``).
        ``example_inputs`` (the model's positional inputs) give a model's
        lazy modules their shapes before the build (``materialize_lazy``),
        as the JAX package's ``init(rng, example_inputs)`` traces them."""
        t0 = time.perf_counter()
        self._seed, self._state_dict = seed, state_dict
        unit = None if self._entry is None else self._entry.take_retired()
        if unit is not None and unit.opt_kwargs != self._builds[0].kwargs:
            unit.release()
            unit = None
        hit = unit is not None
        if unit is None:
            materialize_lazy(self.model, example_inputs)
            unit = self._build_unit()
        self._unit = unit
        self.model = unit.model
        self._scalar_init(unit.model, seed, state_dict)
        with torch.no_grad():
            for rows, values in ((unit.stacked, unit.model.named_parameters()),
                                 (unit.buffers, unit.model.named_buffers())):
                for name, value in values:
                    if name in rows:
                        rows[name].copy_(value.detach().unsqueeze(0).expand_as(rows[name]))
            for state in unit.optimizer.state.values():
                for value in state.values():
                    if hasattr(value, "zero_"):
                        value.zero_()
        self.optimizer = unit.optimizer
        self.scheduler = _LaneSchedules(unit.optimizer, [b.schedule for b in self._builds])
        self._mask = [False] * self.k
        self.aux_loss = None
        if self._slot is not None:
            warm.record_warm_event(hit)
        warm.note_compile(warm=hit, vmap_lanes=self.k,
                          init_ms=(time.perf_counter() - t0) * 1e3)
        return self

    def _build_unit(self) -> _VmapUnit:
        model = self.model
        if _on_meta(model):
            model = model.to_empty(device=self.device)
        trained = None if self._freeze is None else {id(p) for p in self._freeze(model)}
        stacked, grads, frozen = {}, {}, {}
        for name, p in model.named_parameters():
            if trained is not None and id(p) not in trained:
                frozen[name] = p.detach()
                continue
            stacked[name] = torch.zeros((self.k,) + tuple(p.shape), dtype=p.dtype,
                                        device=self.device)
            grads[name] = torch.zeros_like(stacked[name])
        buffers = {name: torch.zeros((self.k,) + tuple(b.shape), dtype=b.dtype,
                                     device=self.device)
                   for name, b in model.named_buffers()}
        lane_params = []
        for i in range(self.k):
            params = []
            for name in stacked:
                view = torch.nn.Parameter(stacked[name][i], requires_grad=False)
                view.grad = grads[name][i]
                params.append(view)
            lane_params.append(params)
        kwargs = self._builds[0].kwargs
        optimizer = torch.optim.AdamW([{"params": ps} for ps in lane_params], lr=1.0, **kwargs)
        if self.device.type == "cuda":
            # The scalar unit's capturable form (Trainer._Unit.make_capturable):
            # each lane's rate a 0-d tensor on the card, step counts on the card.
            for group in optimizer.param_groups:
                group["lr"] = torch.tensor(1.0, dtype=torch.float32, device=self.device)
                group["capturable"] = True
            optimizer._warned_capturable_if_run_uncaptured = True
        return _VmapUnit(model, stacked, frozen, buffers, grads, lane_params, optimizer, kwargs)

    # ------------------------------------------------------------- step

    def _objective(self, params, buffers, frozen, batch):
        """One lane's (objective, summed sowed losses): the
        trainer's ``loss_fn`` plus each loss sowed in the forward, which
        updates the lane's buffer rows in place where they are mutable.
        ``frozen`` (the LoRA base) is the same for every lane."""
        with variables.sowing_losses() as sown, \
                variables.mutable_buffers(self.has_aux_collections):
            out = torch.func.functional_call(self.model, (params, frozen, buffers),
                                             tuple(batch["inputs"]), self.train_kwargs)
        loss = self.loss_fn(out, batch)
        aux = torch.zeros_like(loss)
        for leaf in sown:
            loss, aux = loss + leaf, aux + leaf
        self._sown = bool(sown)
        return loss, aux.detach()

    def _run(self, unit: _VmapUnit, batch):
        """One K-lane step, in place: gradients into the unit's buffer,
        buffer rows updated by the forward, the per-lane optimizer over the
        stacked rows. Returns the [K] losses and summed sowed losses."""
        # Built per call: a transform kept on the trainer would close a
        # reference cycle through the bound objective, and the unit, its
        # graphs and their memory pool would outlive the trainer until a
        # cyclic collection.
        vstep = torch.func.vmap(torch.func.grad_and_value(self._objective, has_aux=True),
                                in_dims=(0, 0, None, None))
        grads, (losses, aux) = vstep(unit.stacked, unit.buffers, unit.frozen, batch)
        with torch.no_grad():
            for name, g in grads.items():
                unit.grads[name].copy_(g)
        # The step's own gradients go before the optimizer's state is
        # allocated (its first step): a model's worth of bytes a lane.
        del grads
        unit.optimizer.step()
        return losses, aux

    def step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One lockstep step of all K lanes; returns the lazy ``[K]`` loss
        tensor (masked lanes included)."""
        unit = self._unit
        if unit is None:
            raise RuntimeError("VmapTrainer.step before init()")
        if self.device.type != "cuda":
            losses, aux = self._run(unit, batch)
        else:
            graph = self._graph_for(unit, batch)
            with device_gate.step():
                if graph is None:
                    losses, aux = self._run(unit, batch)
                else:
                    _copy_into(graph.inputs, batch)
                    graph.graph.replay()
                    if graph.launches:
                        from maggy_tpu_torch.ops import attention

                        attention.add_launches(graph.launches)
                    warm._count("graph_replays")
                    losses, aux = graph.losses.clone(), graph.aux.clone()
        self.aux_loss = aux if self._sown else None
        self.scheduler.step()
        return losses

    def _graph_for(self, unit: _VmapUnit, batch) -> Optional[_LaneGraph]:
        """The unit's graph for the batch's shape, captured now if the shape
        had its eager warm-up step; None for an eager step (no warm slot,
        the shape's first step, or a failed capture)."""
        if self._slot is None or not self._slot.graph_ok:
            return None
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

    def _capture(self, unit: _VmapUnit, key, batch) -> Optional[_LaneGraph]:
        """Capture one K-lane step for ``key``'s batch shape into the unit's
        pool (``trainer.capture_step``)."""
        captured = capture_step(self._slot, unit, self.device, batch,
                                lambda inputs: self._run(unit, inputs))
        if captured is None:
            return None
        graph, inputs, (losses, aux), launches = captured
        unit.graphs[key] = _LaneGraph(graph, inputs, losses, aux, launches)
        while len(unit.graphs) > warm.PER_SLOT_SHAPES:
            unit.graphs.popitem(last=False)
        return unit.graphs[key]

    # ------------------------------------------------------- lane moves

    def mask_lane(self, lane: int) -> None:
        """Retire a lane on the host (JAX ``:268-273``): its row keeps
        computing until a refill or the next block; the other lanes' values
        are those of the unmasked program, bit for bit."""
        self._mask[lane] = True

    def active_lanes(self) -> List[int]:
        return [i for i in range(self.k) if not self._mask[i]]

    def refill_lane(self, lane: int, hparams: Dict[str, Any], seed: Optional[int] = None,
                    state_dict: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Refill lane ``lane`` with a fresh trial mid-block (JAX
        ``:275-315``): the scalar init (``seed`` or ``state_dict``, by
        default the block's own) written into its parameter and buffer
        rows, its optimizer state zeroed and its schedule restarted at
        ``hparams``' rate, all in place."""
        build = self._build_for(hparams)
        if warm.opt_family(build) != self.family or \
                getattr(build, "kwargs", None) != self._builds[0].kwargs:
            raise ValueError("refill hyperparams {} do not match the block's optimizer "
                             "family".format(sorted(hparams)))
        unit = self._unit
        if seed is None and state_dict is None:
            seed, state_dict = self._seed, self._state_dict
        if unit.frozen and (seed != self._seed or state_dict is not self._state_dict):
            raise ValueError("a LoRA block's lanes share one frozen base: a refill starts "
                             "from the block's own init")
        self._scalar_init(unit.model, seed, state_dict)
        with torch.no_grad():
            for rows, values in ((unit.stacked, unit.model.named_parameters()),
                                 (unit.buffers, unit.model.named_buffers())):
                for name, value in values:
                    if name in rows:
                        rows[name][lane].copy_(value.detach())
            for p in unit.lane_params[lane]:
                for value in unit.optimizer.state.get(p, {}).values():
                    if hasattr(value, "zero_"):
                        value.zero_()
        self.scheduler.reset_lane(lane, build.schedule)
        self._builds[lane] = build
        self.lane_hparams[lane] = dict(hparams)
        self._mask[lane] = False

    def lane_state_dict(self, lane: int) -> Dict[str, torch.Tensor]:
        """Lane ``lane``'s parameters and buffers by name, as a module's
        ``state_dict`` (views of the stacked rows; a LoRA base's frozen
        parameters are every lane's)."""
        unit = self._unit
        return {**unit.frozen, **{name: t[lane] for rows in (unit.stacked, unit.buffers)
                                  for name, t in rows.items()}}

    # -------------------------------------------------------- retirement

    def retire_to_warm_cache(self) -> None:
        """Hand the block's K-lane unit to its program's vectorized entry,
        where the next block of the program and K takes it (a private slot's
        unit is freed instead). Called by the executor's trial scope at block
        end; after it the trainer holds no state."""
        unit, entry = self._unit, self._entry
        if unit is None:
            return
        if entry is None or self._slot.key is None:
            unit.release()
        else:
            entry.store_retired(unit)
        self._unit = None
        self.optimizer = self.scheduler = None


__all__ = ["VmapTrainer", "rebind_hyperparams_stacked", "stack_trees"]
