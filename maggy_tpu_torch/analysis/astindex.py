"""Shared AST index for the analysis checkers.

Parses every module of the package ONCE (pure ``ast`` + ``tokenize`` —
nothing under analysis is imported) and exposes:

- per-module comment annotations (``# guarded-by:``, ``# locked-by:``,
  ``# unguarded-ok:``, ``# lock-order-ok:``, ``# rpc-ok:``,
  ``# vocab-ok:``, ``# lock:`` — see docs/analysis_torch.md);
- per-class lock declarations (``self.x = threading.Lock()`` and module
  globals), with ``Condition(other_lock)`` tracked as an alias;
- per-class attribute accesses annotated with the set of locks held at
  the access site (lexical ``with`` nesting + ``.acquire()``
  approximation + ``# locked-by:`` method contracts);
- lock acquisition events with the held-set at acquisition (the raw
  material of the acquired-while-holding graph) and a lightweight call
  graph so edges crossing method calls are seen;
- instance-attribute type inference (``self.x = ClassName(...)``) so
  ``self.server.reservations.lock`` style acquisitions resolve to the
  owning class;
- calls through a package module's name (``device_gate.quiesce()``),
  resolved to that module's function, or through the port's aliases: a
  module-level ``name = _INSTANCE.method`` of a module singleton and a
  class-level ``alias = method`` (``device_gate``'s ``step = _GATE.step``
  and ``capture = quiesce = exclusive``).
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Dict, List, Optional, Tuple

#: Annotation tags recognized in comments: ``# <tag>: <value>``.
ANNOTATION_TAGS = ("guarded-by", "locked-by", "unguarded-ok",
                   "lock-order-ok", "rpc-ok", "vocab-ok", "lock")

_ANNOT_RE = re.compile(
    r"#\s*(" + "|".join(ANNOTATION_TAGS) + r")\s*:\s*(.*?)\s*(?:#|$)")

#: Mutating method names on containers: calling one on an attribute
#: counts as a WRITE of that attribute.
MUTATORS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "setdefault", "add", "discard", "appendleft", "popleft",
    "sort", "reverse",
})

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}


class Annotation:
    __slots__ = ("tag", "value", "line")

    def __init__(self, tag: str, value: str, line: int):
        self.tag = tag
        self.value = value
        self.line = line


class LockDecl:
    """One lock allocation site: ``owner`` is the class name (or the
    module name for globals), ``attr`` the attribute/global name."""

    __slots__ = ("owner", "attr", "kind", "path", "line", "alias_of")

    def __init__(self, owner: str, attr: str, kind: str, path: str,
                 line: int, alias_of: Optional[str] = None):
        self.owner = owner
        self.attr = attr
        self.kind = kind
        self.path = path
        self.line = line
        self.alias_of = alias_of  # Condition(self.X) -> X

    @property
    def name(self) -> str:
        return "{}.{}".format(self.owner, self.attr)


class Access:
    """One read/write of ``self.<attr>`` inside a method."""

    __slots__ = ("attr", "kind", "method", "line", "held", "in_init")

    def __init__(self, attr: str, kind: str, method: str, line: int,
                 held: frozenset, in_init: bool):
        self.attr = attr
        self.kind = kind  # "read" | "write"
        self.method = method
        self.line = line
        self.held = held
        self.in_init = in_init


class Acquisition:
    """One lock acquisition (``with`` entry or ``.acquire()``)."""

    __slots__ = ("lock", "line", "func", "held")

    def __init__(self, lock: str, line: int, func: str, held: frozenset):
        self.lock = lock
        self.line = line
        self.func = func
        self.held = held


class Call:
    """A resolvable-ish call made while possibly holding locks.
    ``args_from_params``: callee-arg-position -> caller param name, for
    the rpc payload-flow pass."""

    __slots__ = ("callee", "line", "func", "held", "args_from_params",
                 "target")

    def __init__(self, callee: str, line: int, func: str, held: frozenset,
                 args_from_params: Dict[int, str],
                 target: Optional[str] = None):
        self.callee = callee
        self.line = line
        self.func = func
        self.held = held
        self.args_from_params = args_from_params
        # Qualname when the call names a package module's attribute
        # (``device_gate.quiesce()`` -> "<pkg>.device_gate.quiesce").
        self.target = target


class ClassInfo:
    def __init__(self, name: str, module: "ModuleInfo", node: ast.ClassDef):
        self.name = name
        self.module = module
        self.node = node
        self.bases = [_name_of(b) for b in node.bases]
        self.methods: Dict[str, ast.FunctionDef] = {}
        self.locks: Dict[str, LockDecl] = {}
        # attr -> (lock name, decl line) from `# guarded-by:` annotations.
        self.guard_annotations: Dict[str, Tuple[str, int]] = {}
        # attr -> first-assignment line in __init__ (declaration site).
        self.attr_decl_lines: Dict[str, int] = {}
        # attrs whose declaration line carries `# unguarded-ok:`.
        self.exempt_attrs: Dict[str, str] = {}
        self.accesses: List[Access] = []
        # Whole-class exemption: `# guarded-by: Owner._lock` on the class
        # line documents external synchronization.
        self.external_guard: Optional[str] = None
        # attr -> constructed class name (self.x = ClassName(...)).
        self.attr_types: Dict[str, str] = {}


class ModuleInfo:
    def __init__(self, path: str, modname: str, tree: ast.Module,
                 annotations: Dict[int, List[Annotation]], text: str):
        self.path = path
        self.modname = modname
        self.tree = tree
        self.annotations = annotations
        self.text = text
        self.classes: Dict[str, ClassInfo] = {}
        self.module_locks: Dict[str, LockDecl] = {}
        # Local name -> dotted name it was imported as (anywhere in the
        # module, function-level imports included).
        self.imports: Dict[str, str] = {}

    def annotation(self, line: int, tag: str) -> Optional[Annotation]:
        for ann in self.annotations.get(line, []):
            if ann.tag == tag:
                return ann
        return None

    def annotation_near(self, line: int, tag: str,
                        back: int = 1) -> Optional[Annotation]:
        """Annotation on ``line`` or up to ``back`` lines above it."""
        for ln in range(line, line - back - 1, -1):
            ann = self.annotation(ln, tag)
            if ann is not None:
                return ann
        return None


class PackageIndex:
    def __init__(self, root: Optional[str]):
        self.root = root
        self.modules: Dict[str, ModuleInfo] = {}
        self.classes: Dict[str, List[ClassInfo]] = {}
        self.acquisitions: List[Acquisition] = []
        self.calls: List[Call] = []
        # func qualname -> FunctionDef (Class.method / modname.func).
        self.functions: Dict[str, ast.FunctionDef] = {}
        self.func_module: Dict[str, ModuleInfo] = {}
        # method name -> owning qualnames (for unique-name resolution).
        self.method_owners: Dict[str, List[str]] = {}
        # alias qualname -> the qualname it names (module-level bound
        # methods of a singleton, class-level method aliases).
        self.aliases: Dict[str, str] = {}

    # --------------------------------------------------------------- lookups

    def lock_decls(self) -> List[LockDecl]:
        out = []
        for mod in self.modules.values():
            out.extend(mod.module_locks.values())
            for cls in mod.classes.values():
                out.extend(cls.locks.values())
        return out

    def decl_by_site(self) -> Dict[Tuple[str, int], LockDecl]:
        """(abspath, line) -> decl; the witness maps runtime allocation
        frames through this."""
        return {(os.path.abspath(d.path), d.line): d
                for d in self.lock_decls()}

    def classes_with_lock_attr(self, attr: str) -> List[ClassInfo]:
        return [c for cs in self.classes.values() for c in cs
                if attr in c.locks]

    def resolve_method(self, name: str) -> Optional[str]:
        """Qualname of ``name`` if exactly one class (or module) defines
        it, else None."""
        owners = self.method_owners.get(name, [])
        return owners[0] if len(owners) == 1 else None

    def method_family(self, name: str) -> List[str]:
        """Every definition of method ``name`` when there are several and
        all are methods of one class hierarchy (one package-local root,
        such as an interface and the environments that override it): a
        call by that name may reach any of them. Else []."""
        owners = self.method_owners.get(name, [])
        roots = set()
        for qual in owners:
            cls = self.class_info(qual.split(".")[0]) if qual.count(".") == 1 else None
            if cls is None:
                return []
            seen = set()
            while cls.name not in seen:
                seen.add(cls.name)
                bases = [self.class_info(b) for b in cls.bases if b]
                bases = [c for c in bases if c is not None]
                if not bases:
                    break
                cls = bases[0]
            roots.add(cls.name)
        return owners if len(owners) > 1 and len(roots) == 1 else []

    def resolve_alias(self, qual: str) -> str:
        """Follow ``aliases`` to the defining qualname (bounded)."""
        for _ in range(8):
            if qual not in self.aliases:
                break
            qual = self.aliases[qual]
        return qual

    def class_info(self, name: str) -> Optional[ClassInfo]:
        lst = self.classes.get(name, [])
        return lst[0] if len(lst) == 1 else None

    def mro_methods(self, cls: ClassInfo) -> Dict[str, ast.FunctionDef]:
        """Methods including (package-local, by-name) base classes;
        subclass wins."""
        out: Dict[str, ast.FunctionDef] = {}
        for base in reversed(cls.bases):
            base_cls = self.class_info(base) if base else None
            if base_cls is not None:
                out.update(self.mro_methods(base_cls))
        out.update(cls.methods)
        return out


# ------------------------------------------------------------------ parsing


def _name_of(node) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _comment_annotations(text: str) -> Dict[int, List[Annotation]]:
    out: Dict[int, List[Annotation]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(text).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _ANNOT_RE.search(tok.string)
            if m:
                ann = Annotation(m.group(1), m.group(2).strip(),
                                 tok.start[0])
                out.setdefault(tok.start[0], []).append(ann)
    except tokenize.TokenError:
        pass
    return out


def _lock_ctor_call(node) -> Optional[Tuple[str, Optional[str]]]:
    """(kind, alias_attr) when ``node`` is ``threading.<Lock...>(...)``.
    ``alias_attr`` is set for ``Condition(self.X)`` / ``Condition(X)``."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    name = None
    if isinstance(fn, ast.Attribute) and \
            isinstance(fn.value, ast.Name) and fn.value.id == "threading":
        name = fn.attr
    elif isinstance(fn, ast.Name):
        name = fn.id
    if name not in _LOCK_CTORS:
        return None
    alias = None
    if name == "Condition" and node.args:
        arg = node.args[0]
        if isinstance(arg, ast.Attribute) and \
                isinstance(arg.value, ast.Name) and arg.value.id == "self":
            alias = arg.attr
        elif isinstance(arg, ast.Name):
            alias = arg.id
    return name, alias


def parse_package(root: Optional[str],
                  paths: Optional[List[str]] = None) -> PackageIndex:
    index = PackageIndex(root)
    files: List[Tuple[str, str]] = []
    if paths is not None:
        for p in paths:
            files.append((p, os.path.splitext(os.path.basename(p))[0]))
    else:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, os.path.dirname(root))
                modname = rel[:-3].replace(os.sep, ".")
                if modname.endswith(".__init__"):
                    modname = modname[:-9]
                files.append((full, modname))
    for path, modname in files:
        with open(path, "r") as f:
            text = f.read()
        try:
            tree = ast.parse(text, filename=path)
        except SyntaxError:
            continue
        mod = ModuleInfo(path, modname, tree, _comment_annotations(text),
                         text)
        index.modules[modname] = mod
        _index_module(index, mod)
    for mod in index.modules.values():
        _collect_accesses(index, mod)
    return index


def _index_module(index: PackageIndex, mod: ModuleInfo) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    mod.imports[alias.asname] = alias.name
                elif "." not in alias.name:
                    mod.imports[alias.name] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            for alias in node.names:
                mod.imports[alias.asname or alias.name] = \
                    "{}.{}".format(node.module, alias.name)
    # Module singletons (``_GATE = _Gate()``) and their bound methods
    # published as module functions (``step = _GATE.step``).
    singletons: Dict[str, str] = {}
    for node in mod.tree.body:
        if not (isinstance(node, ast.Assign) and
                all(isinstance(t, ast.Name) for t in node.targets)):
            continue
        value = node.value
        if isinstance(value, ast.Call) and isinstance(value.func, ast.Name) \
                and value.func.id[:1] in ("_",) + tuple(
                    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"):
            for t in node.targets:
                singletons[t.id] = value.func.id
        elif isinstance(value, ast.Attribute) and \
                isinstance(value.value, ast.Name) and \
                value.value.id in singletons:
            for t in node.targets:
                index.aliases["{}.{}".format(mod.modname, t.id)] = \
                    "{}.{}".format(singletons[value.value.id], value.attr)
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            ctor = _lock_ctor_call(node.value)
            if ctor is not None:
                name = node.targets[0].id
                mod.module_locks[name] = LockDecl(
                    mod.modname, name, ctor[0], mod.path, node.lineno,
                    alias_of=ctor[1])
        elif isinstance(node, ast.FunctionDef):
            qual = "{}.{}".format(mod.modname, node.name)
            index.functions[qual] = node
            index.func_module[qual] = mod
            index.method_owners.setdefault(node.name, []).append(qual)
        elif isinstance(node, ast.ClassDef):
            cls = ClassInfo(node.name, mod, node)
            mod.classes[node.name] = cls
            index.classes.setdefault(node.name, []).append(cls)
            ann = mod.annotation(node.lineno, "guarded-by")
            if ann is not None:
                cls.external_guard = ann.value
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    cls.methods[item.name] = item
                    qual = "{}.{}".format(node.name, item.name)
                    index.functions[qual] = item
                    index.func_module[qual] = mod
                    index.method_owners.setdefault(
                        item.name, []).append(qual)
                elif isinstance(item, ast.Assign) and \
                        isinstance(item.value, ast.Name) and \
                        all(isinstance(t, ast.Name) for t in item.targets):
                    # Class-level method alias (``capture = quiesce =
                    # exclusive``); resolved once every method is known.
                    for t in item.targets:
                        index.aliases["{}.{}".format(node.name, t.id)] = \
                            "{}.{}".format(node.name, item.value.id)
                elif isinstance(item, ast.Assign) and \
                        len(item.targets) == 1 and \
                        isinstance(item.targets[0], ast.Name):
                    # Class-level lock attribute (EnvSing._lock style).
                    ctor = _lock_ctor_call(item.value)
                    if ctor is not None:
                        name = item.targets[0].id
                        cls.locks[name] = LockDecl(
                            node.name, name, ctor[0], mod.path,
                            item.lineno, alias_of=ctor[1])
            # Lock attrs + guard annotations + attr types from EVERY
            # method (locks are usually made in __init__ but not always).
            for mname, fnode in cls.methods.items():
                for stmt in ast.walk(fnode):
                    if isinstance(stmt, ast.Assign) and \
                            len(stmt.targets) == 1:
                        tgt, value = stmt.targets[0], stmt.value
                    elif isinstance(stmt, ast.AnnAssign):
                        # self.x: T = ... carries annotations the same
                        # way an untyped assignment does.
                        tgt, value = stmt.target, stmt.value
                    else:
                        continue
                    if not (isinstance(tgt, ast.Attribute) and
                            isinstance(tgt.value, ast.Name) and
                            tgt.value.id == "self"):
                        continue
                    ctor = _lock_ctor_call(value) if value is not None \
                        else None
                    if ctor is not None:
                        cls.locks[tgt.attr] = LockDecl(
                            cls.name, tgt.attr, ctor[0], mod.path,
                            stmt.lineno, alias_of=ctor[1])
                        continue
                    if isinstance(value, ast.Call):
                        cname = _name_of(value.func)
                        if cname and cname[:1].isupper():
                            cls.attr_types.setdefault(tgt.attr, cname)
                    if mname == "__init__":
                        cls.attr_decl_lines.setdefault(tgt.attr,
                                                       stmt.lineno)
                    ann = mod.annotation(stmt.lineno, "guarded-by")
                    if ann is not None:
                        cls.guard_annotations.setdefault(
                            tgt.attr, (ann.value, stmt.lineno))
                    ann = mod.annotation(stmt.lineno, "unguarded-ok")
                    if ann is not None and mname == "__init__":
                        cls.exempt_attrs.setdefault(tgt.attr, ann.value)


# ----------------------------------------------------- held-lock collection


class _HeldVisitor(ast.NodeVisitor):
    """Walks one function body tracking the lexically-held lock set.

    Lock references resolve to package-wide names:
    - ``self.X`` where class defines lock X           -> "Class.X"
    - bare ``X`` where the module defines global lock -> "module.X"
    - ``<expr>.Y`` where Y is a lock attr             -> owner via
      attr-type inference / var-name heuristic / ``# lock:`` annotation,
      else "?.Y" (recorded, excluded from order edges).
    Condition aliases collapse onto their underlying lock.
    """

    def __init__(self, index: PackageIndex, mod: ModuleInfo,
                 cls: Optional[ClassInfo], func: ast.FunctionDef,
                 qual: str):
        self.index = index
        self.mod = mod
        self.cls = cls
        self.func = func
        self.qual = qual
        self.held: Tuple[str, ...] = ()
        ann = mod.annotation_near(func.lineno, "locked-by", back=1)
        if ann is not None:
            for lock in ann.value.split(","):
                self.held = self.held + (self._canon_self_lock(
                    lock.strip()),)
        self.in_init = func.name == "__init__"

    # -- lock reference resolution ----------------------------------------

    def _canon_self_lock(self, attr: str) -> str:
        if "." in attr:
            return attr  # already Owner.attr
        cls = self.cls
        if cls is not None and attr in cls.locks:
            decl = cls.locks[attr]
            if decl.alias_of and decl.alias_of in cls.locks:
                return "{}.{}".format(cls.name, decl.alias_of)
            return "{}.{}".format(cls.name, attr)
        if attr in self.mod.module_locks:
            decl = self.mod.module_locks[attr]
            if decl.alias_of and decl.alias_of in self.mod.module_locks:
                return "{}.{}".format(self.mod.modname, decl.alias_of)
            return "{}.{}".format(self.mod.modname, attr)
        return "?." + attr

    def _resolve_lock_expr(self, node, line: int) -> Optional[str]:
        ann = self.mod.annotation(line, "lock")
        if isinstance(node, ast.Name):
            if node.id in self.mod.module_locks:
                return self._canon_self_lock(node.id)
            return ann.value if ann is not None else None
        if not isinstance(node, ast.Attribute):
            return None
        attr = node.attr
        base = node.value
        owners = self.index.classes_with_lock_attr(attr)
        if not owners:
            return ann.value if ann is not None else None
        if isinstance(base, ast.Name) and base.id in ("self", "cls"):
            if self.cls is not None and attr in self.cls.locks:
                return self._canon_self_lock(attr)
            # self.X in a mixin whose lock lives on the composed class.
        if ann is not None:
            return ann.value
        if len(owners) == 1:
            return "{}.{}".format(owners[0].name, attr)
        # Ambiguous attr name (.lock on Trial/Reservations/Reporter):
        # try the holder expression's inferred type, then the var-name ~
        # class-name heuristic.
        base_name = _name_of(base)
        if base_name:
            for c in ({} if self.cls is None
                      else [self.cls]):
                typ = c.attr_types.get(base_name)
                if typ and any(o.name == typ for o in owners):
                    return "{}.{}".format(typ, attr)
            for o in owners:
                if base_name.lower() == o.name.lower():
                    return "{}.{}".format(o.name, attr)
        return "?." + attr

    # -- traversal ---------------------------------------------------------

    def visit_FunctionDef(self, node):
        if node is not self.func:
            return  # nested defs analyzed separately (fresh held set)
        for stmt in node.body:
            self.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_With(self, node):
        added = []
        for item in node.items:
            ctx = item.context_expr
            target = ctx
            # with lock / with cond / with self.x.lock — strip no calls;
            # ``lock.acquire()`` handled in visit_Call.
            lock = self._resolve_lock_expr(target, node.lineno)
            if lock is not None:
                self._note_acquire(lock, node.lineno)
                added.append(lock)
            else:
                self.visit(ctx)
        self.held = self.held + tuple(added)
        for stmt in node.body:
            self.visit(stmt)
        if added:
            self.held = self.held[:len(self.held) - len(added)]

    def visit_Call(self, node):
        fn = node.func
        # lock.acquire(...): treat the REST of the enclosing function as
        # held (approximation — release is almost always in a finally).
        if isinstance(fn, ast.Attribute) and fn.attr == "acquire":
            lock = self._resolve_lock_expr(fn.value, node.lineno)
            if lock is not None:
                self._note_acquire(lock, node.lineno)
                self.held = self.held + (lock,)
        callee = None
        args_from_params: Dict[int, str] = {}
        params = {a.arg for a in self.func.args.args}
        for i, arg in enumerate(node.args):
            if isinstance(arg, ast.Name) and arg.id in params:
                args_from_params[i] = arg.id
        target = None
        if isinstance(fn, ast.Name):
            callee = fn.id
        elif isinstance(fn, ast.Attribute):
            callee = fn.attr
            if isinstance(fn.value, ast.Name) and \
                    fn.value.id in self.mod.imports:
                target = "{}.{}".format(self.mod.imports[fn.value.id],
                                        fn.attr)
        if callee:
            self.index.calls.append(Call(
                callee, node.lineno, self.qual,
                frozenset(self.held), args_from_params, target=target))
        self.generic_visit(node)

    def _note_acquire(self, lock: str, line: int) -> None:
        held = frozenset(h for h in self.held if h != lock)
        self.index.acquisitions.append(
            Acquisition(lock, line, self.qual, held))

    # -- attribute accesses -------------------------------------------------

    def _note_access(self, attr: str, kind: str, line: int) -> None:
        if self.cls is None:
            return
        self.cls.accesses.append(Access(
            attr, kind, self.func.name, line,
            frozenset(self.held), self.in_init))

    def visit_Attribute(self, node):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            kind = "write" if isinstance(node.ctx,
                                         (ast.Store, ast.Del)) else "read"
            self._note_access(node.attr, kind, node.lineno)
        self.generic_visit(node)

    def visit_Subscript(self, node):
        # self.x[k] = v  /  del self.x[k]  => WRITE of x (and a read).
        tgt = node.value
        if isinstance(tgt, ast.Attribute) and \
                isinstance(tgt.value, ast.Name) and tgt.value.id == "self" \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            self._note_access(tgt.attr, "write", node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        tgt = node.target
        if isinstance(tgt, ast.Attribute) and \
                isinstance(tgt.value, ast.Name) and tgt.value.id == "self":
            self._note_access(tgt.attr, "write", node.lineno)
        elif isinstance(tgt, ast.Subscript):
            inner = tgt.value
            if isinstance(inner, ast.Attribute) and \
                    isinstance(inner.value, ast.Name) and \
                    inner.value.id == "self":
                self._note_access(inner.attr, "write", node.lineno)
        self.generic_visit(node)


def _collect_accesses(index: PackageIndex, mod: ModuleInfo) -> None:
    for cls in mod.classes.values():
        for mname, fnode in cls.methods.items():
            qual = "{}.{}".format(cls.name, mname)
            v = _HeldVisitor(index, mod, cls, fnode, qual)
            v.visit(fnode)
            _upgrade_mutator_calls(cls, fnode)
    for node in mod.tree.body:
        if isinstance(node, ast.FunctionDef):
            qual = "{}.{}".format(mod.modname, node.name)
            v = _HeldVisitor(index, mod, None, node, qual)
            v.visit(node)


def _upgrade_mutator_calls(cls: ClassInfo, fnode: ast.FunctionDef) -> None:
    """``self.x.append(v)`` records a read of x at that line; upgrade it
    to a write when the called method mutates."""
    mut_lines: Dict[Tuple[str, int], bool] = {}
    for node in ast.walk(fnode):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATORS:
            tgt = node.func.value
            if isinstance(tgt, ast.Attribute) and \
                    isinstance(tgt.value, ast.Name) and \
                    tgt.value.id == "self":
                mut_lines[(tgt.attr, node.lineno)] = True
    if not mut_lines:
        return
    for acc in cls.accesses:
        if acc.kind == "read" and (acc.attr, acc.line) in mut_lines:
            acc.kind = "write"
