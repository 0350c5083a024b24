"""Checker 3: RPC conformance.

The wire vocabulary is stringly typed — a verb or payload key that
drifts between the producing and consuming side fails SILENTLY (the
retried-FINAL race hid behind exactly such a drift). Statically:

- every verb registered in a server's ``_handlers`` table (and every
  driver ``message_callbacks`` verb) must have at least one producer — a
  ``{"type": <verb>, ...}`` dict literal somewhere outside that verb's
  own handler (reply literals do not count as producers);
- payload-key agreement per verb: a key the handler reads via
  ``msg["k"]`` must be sent by some producer (a ``.get("k")`` read is
  only checked when every producer is a closed literal — ``**spread``
  producers may carry anything); a key producers send that no consumer
  ever reads is dead vocabulary and flagged too. Reads FLOW through
  calls: a handler passing ``msg`` to a driver method is credited with
  that method's reads (bounded-depth, package-local resolution).
- every server class must time its dispatches (``rpc.handle_ms.<verb>``
  in ``handle_message``).

``# rpc-ok: <reason>`` on the registration line, a producer literal's
line, or a read line suppresses (with a written reason).

Wire augmentation: ``Client._request`` stamps ``partition_id`` and
``task_attempt`` onto every outgoing payload; those keys (and ``type``)
are exempt from key-agreement in both directions.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from maggy_tpu_torch.analysis.astindex import ModuleInfo, PackageIndex

#: Keys the transport injects / every frame carries.
WIRE_KEYS = frozenset({"type", "partition_id", "task_attempt"})

_FLOW_DEPTH = 4


class Producer:
    __slots__ = ("verb", "keys", "open", "mod", "line", "func")

    def __init__(self, verb, keys, open_, mod, line, func):
        self.verb = verb
        self.keys = keys
        self.open = open_  # had a **spread — may send more keys
        self.mod = mod
        self.line = line
        self.func = func


class Consumer:
    """One handler/callback function for a verb."""

    __slots__ = ("verb", "qual", "node", "mod", "param", "reg_line")

    def __init__(self, verb, qual, node, mod, param, reg_line):
        self.verb = verb
        self.qual = qual
        self.node = node  # FunctionDef or Lambda
        self.mod = mod
        self.param = param
        self.reg_line = reg_line


def _enclosing_functions(tree) -> List[Tuple[ast.AST, ast.AST]]:
    """(func_node, parent_stack top) pairs — used to attribute dict
    literals to their enclosing function."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            out.append(node)
    return out


def _collect_producers(index: PackageIndex) -> List[Producer]:
    producers: List[Producer] = []
    for mod in index.modules.values():
        # Map each dict literal to its enclosing function qual (class
        # methods get Class.method, module funcs get mod.func).
        func_ranges: List[Tuple[int, int, str]] = []
        for cname, cls in mod.classes.items():
            for mname, fn in cls.methods.items():
                func_ranges.append((fn.lineno, _end(fn),
                                    "{}.{}".format(cname, mname)))
        for node in mod.tree.body:
            if isinstance(node, ast.FunctionDef):
                func_ranges.append((node.lineno, _end(node),
                                    "{}.{}".format(mod.modname,
                                                   node.name)))

        def enclosing(line: int) -> str:
            best = ""
            best_span = None
            for lo, hi, qual in func_ranges:
                if lo <= line <= hi:
                    span = hi - lo
                    if best_span is None or span < best_span:
                        best, best_span = qual, span
            return best

        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Dict):
                continue
            verb = None
            keys: Set[str] = set()
            open_ = False
            for k, v in zip(node.keys, node.values):
                if k is None:
                    open_ = True  # **spread
                    continue
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.add(k.value)
                    if k.value == "type" and isinstance(v, ast.Constant) \
                            and isinstance(v.value, str):
                        verb = v.value
            if verb is None:
                continue
            producers.append(Producer(verb, keys - {"type"}, open_, mod,
                                      node.lineno, enclosing(node.lineno)))
        # var["k"] = ... augmentation of a literal assigned to a local:
        # credit the key to every producer literal assigned in the same
        # function to that name (the heartbeat's payload["rstats"]).
        for fn_node in _enclosing_functions(mod.tree):
            if isinstance(fn_node, ast.Lambda):
                continue
            assigns: Dict[str, List[int]] = {}
            for st in ast.walk(fn_node):
                if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                        and isinstance(st.targets[0], ast.Name) \
                        and isinstance(st.value, ast.Dict):
                    assigns.setdefault(st.targets[0].id,
                                       []).append(st.value.lineno)
            if not assigns:
                continue
            for st in ast.walk(fn_node):
                if isinstance(st, ast.Subscript) \
                        and isinstance(st.ctx, ast.Store) \
                        and isinstance(st.value, ast.Name) \
                        and st.value.id in assigns \
                        and isinstance(st.slice, ast.Constant) \
                        and isinstance(st.slice.value, str):
                    lines = assigns[st.value.id]
                    for p in producers:
                        if p.mod is mod and p.line in lines:
                            p.keys.add(st.slice.value)
    return producers


def _end(node) -> int:
    return getattr(node, "end_lineno", node.lineno)


def _handler_tables(index: PackageIndex) -> List[Consumer]:
    """Registered verbs from ``self._handlers[...]`` / ``.update(...)``
    and ``self.message_callbacks.update(...)`` across all classes."""
    consumers: List[Consumer] = []
    for mod in index.modules.values():
        for cname, cls in mod.classes.items():
            for mname, fn in cls.methods.items():
                for node in ast.walk(fn):
                    if isinstance(node, ast.Assign) and \
                            len(node.targets) == 1 and \
                            isinstance(node.targets[0], ast.Subscript):
                        sub = node.targets[0]
                        table = _table_name(sub.value)
                        if table and isinstance(sub.slice, ast.Constant):
                            verb = sub.slice.value
                            consumers.append(_consumer_for(
                                index, mod, cname, verb, node.value,
                                node.lineno))
                    elif isinstance(node, ast.Call) and \
                            isinstance(node.func, ast.Attribute) and \
                            node.func.attr == "update":
                        table = _table_name(node.func.value)
                        if table:
                            for kw in node.keywords:
                                if kw.arg is None:
                                    continue
                                consumers.append(_consumer_for(
                                    index, mod, cname, kw.arg, kw.value,
                                    node.lineno))
    return [c for c in consumers if c is not None]


def _table_name(node) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self" \
            and node.attr in ("_handlers", "message_callbacks"):
        return node.attr
    return None


def _consumer_for(index, mod, cname, verb, value,
                  reg_line) -> Optional[Consumer]:
    if isinstance(value, ast.Lambda):
        param = value.args.args[0].arg if value.args.args else None
        return Consumer(verb, "{}.<lambda:{}>".format(cname, verb),
                        value, mod, param, reg_line)
    if isinstance(value, ast.Attribute) and \
            isinstance(value.value, ast.Name) and value.value.id == "self":
        cls = index.class_info(cname)
        fn = index.mro_methods(cls).get(value.attr) if cls else None
        if fn is None:
            return None
        # Parameter holding the message: first non-self arg.
        args = [a.arg for a in fn.args.args if a.arg != "self"]
        param = args[0] if args else None
        owner = cname
        if value.attr not in (cls.methods if cls else {}):
            for base in (cls.bases if cls else []):
                bcls = index.class_info(base) if base else None
                if bcls is not None and value.attr in bcls.methods:
                    owner = bcls.name
                    break
        qual = "{}.{}".format(owner, value.attr)
        fmod = index.func_module.get(qual, mod)
        return Consumer(verb, qual, fn, fmod, param, reg_line)
    return None


def _reads_of(index: PackageIndex, qual: str, node, param: Optional[str],
              depth: int, seen: Set[Tuple[str, str]]
              ) -> Tuple[Dict[str, List[Tuple[ModuleInfo, int]]],
                         Dict[str, List[Tuple[ModuleInfo, int]]]]:
    """(hard_reads, soft_reads): key -> [(module, line)]. Hard =
    ``param["k"]`` subscripts (KeyError on absence); soft = ``.get`` /
    ``.pop`` with a default path. Flows into package-local callees that
    receive the param positionally."""
    hard: Dict[str, List[Tuple[ModuleInfo, int]]] = {}
    soft: Dict[str, List[Tuple[ModuleInfo, int]]] = {}
    if param is None or node is None or depth <= 0 or \
            (qual, param) in seen:
        return hard, soft
    seen = seen | {(qual, param)}
    mod = index.func_module.get(qual)
    body = node.body if isinstance(node.body, list) else [node.body]
    for st in body:
        for sub in ast.walk(st):
            if isinstance(sub, ast.Subscript) and \
                    isinstance(sub.value, ast.Name) and \
                    sub.value.id == param and \
                    isinstance(sub.slice, ast.Constant) and \
                    isinstance(sub.slice.value, str):
                hard.setdefault(sub.slice.value, []).append(
                    (mod, sub.lineno))
            elif isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in ("get", "pop") and \
                    isinstance(sub.func.value, ast.Name) and \
                    sub.func.value.id == param and sub.args and \
                    isinstance(sub.args[0], ast.Constant) and \
                    isinstance(sub.args[0].value, str):
                soft.setdefault(sub.args[0].value, []).append(
                    (mod, sub.lineno))
    # Flow through calls passing the param positionally.
    for call in index.calls:
        if call.func != qual:
            continue
        positions = [i for i, name in call.args_from_params.items()
                     if name == param]
        if not positions:
            continue
        from maggy_tpu_torch.analysis.lockorder import _resolve_callee

        callee = _resolve_callee(index, call)
        fn = index.functions.get(callee)
        if fn is None:
            continue
        params = [a.arg for a in fn.args.args]
        offset = 1 if params and params[0] == "self" else 0
        for pos in positions:
            if pos + offset < len(params):
                h, s = _reads_of(index, callee, fn,
                                 params[pos + offset], depth - 1, seen)
                for k, v in h.items():
                    hard.setdefault(k, []).extend(v)
                for k, v in s.items():
                    soft.setdefault(k, []).extend(v)
    return hard, soft


def check(index: PackageIndex) -> List["Finding"]:
    from maggy_tpu_torch.analysis import Finding

    findings: List[Finding] = []
    producers = _collect_producers(index)
    consumers = _handler_tables(index)
    verbs = sorted({c.verb for c in consumers})
    handler_quals: Dict[str, Set[str]] = {}
    for c in consumers:
        handler_quals.setdefault(c.verb, set()).add(c.qual)

    def emit(mod: ModuleInfo, line: int, msg: str) -> None:
        # Annotation may sit on the flagged line or a comment just above
        # it (multi-line reasons span two comment lines).
        ann = mod.annotation_near(line, "rpc-ok", back=2)
        if ann is not None and not ann.value:
            findings.append(Finding("rpcconf", mod.path, line,
                                    "rpc-ok suppression without a reason"))
            return
        findings.append(Finding(
            "rpcconf", mod.path, line, msg,
            suppressed=ann is not None,
            reason=ann.value if ann is not None else None))

    reads_by_verb: Dict[str, Tuple[dict, dict]] = {}
    for verb in verbs:
        hard: Dict[str, list] = {}
        soft: Dict[str, list] = {}
        for c in consumers:
            if c.verb != verb:
                continue
            h, s = _reads_of(index, c.qual, c.node, c.param,
                             _FLOW_DEPTH, set())
            for k, v in h.items():
                hard.setdefault(k, []).extend(v)
            for k, v in s.items():
                soft.setdefault(k, []).extend(v)
        reads_by_verb[verb] = (hard, soft)

    for verb in verbs:
        verb_producers = [
            p for p in producers if p.verb == verb
            and p.func not in handler_quals.get(verb, set())
            and not _is_lambda_reply(p, verb)]
        reg = next(c for c in consumers if c.verb == verb)
        if not verb_producers:
            emit(reg.mod, reg.reg_line,
                 "verb {} is registered but has no producer ({{\"type\": "
                 "\"{}\"}} literal) anywhere in the package".format(
                     verb, verb))
            continue
        sent: Set[str] = set(WIRE_KEYS)
        all_closed = True
        for p in verb_producers:
            sent |= p.keys
            all_closed &= not p.open
        hard, soft = reads_by_verb[verb]
        for key in sorted(hard):
            if key in sent:
                continue
            mod, line = hard[key][0]
            emit(mod, line,
                 "handler for {} indexes msg[{!r}] but no producer sends "
                 "it (KeyError on delivery)".format(verb, key))
        if all_closed:
            for key in sorted(soft):
                if key in sent or key in hard:
                    continue
                mod, line = soft[key][0]
                emit(mod, line,
                     "handler for {} reads key {!r} that no producer "
                     "sends".format(verb, key))
        read_keys = set(hard) | set(soft)
        for p in verb_producers:
            for key in sorted(p.keys - read_keys - WIRE_KEYS):
                emit(p.mod, p.line,
                     "producer of {} sends key {!r} that no handler or "
                     "callback ever reads (dead vocabulary)".format(
                         verb, key))

    # Dispatch timing: every class registering _handlers must go through
    # a handle_message that records rpc.handle_ms.<verb>.
    seen_classes = set()
    for c in consumers:
        cname = c.qual.split(".")[0].split("<")[0]
        if cname in seen_classes:
            continue
        seen_classes.add(cname)
        cls = index.class_info(cname)
        if cls is None:
            continue
        if not any(
            isinstance(n, ast.Constant) and isinstance(n.value, str)
            and "rpc.handle_ms." in n.value
            for fn in index.mro_methods(cls).values()
            for n in ast.walk(fn)
        ):
            # Driver classes register message_callbacks, not wire verbs —
            # only classes with a _handlers table need the timer.
            if any(_registers_wire_handlers(cls, index)):
                emit(cls.module, cls.node.lineno,
                     "server class {} has a _handlers table but no "
                     "rpc.handle_ms.<verb> dispatch timing".format(cname))
    return findings


def _registers_wire_handlers(cls, index) -> List[bool]:
    out = []
    for fn in index.mro_methods(cls).values():
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.Call)):
                tgt = node.targets[0].value if (
                    isinstance(node, ast.Assign) and node.targets and
                    isinstance(node.targets[0], ast.Subscript)) else (
                    node.func.value if isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Attribute) and
                    node.func.attr == "update" else None)
                if tgt is not None and _table_name(tgt) == "_handlers":
                    out.append(True)
    return out


def _is_lambda_reply(p: Producer, verb: str) -> bool:
    """A literal inside a lambda registered for the same verb (the QUERY
    reply) encloses in ``_register_handlers`` itself — reply, not
    producer."""
    return p.func.endswith("._register_handlers")
