"""Effect-protocol static analysis: the determinism contract as lint rules.

The simulation's core claim — bit-identical ``charged_ms`` / billed USD
across the EventClock and VirtualClock substrates and across runs —
rests on discipline that used to be enforced only by review:

- **No wall clock in actor code** (``REPRO001``): every duration and
  deadline goes through the engine clock. A ``time.time()`` in a cost
  path silently couples the simulation to host speed.
- **No unseeded randomness** (``REPRO002``): all stochastic draws come
  from ``random.Random(zlib.crc32(token))``-style seeded generators;
  the module-level ``random.*`` functions share mutable global state
  and make two runs diverge.
- **Generator discipline** for ``*_g`` effect generators:
  shared host-state mutation after the first yield without holding the
  protecting lock (``REPRO010`` — another frame may interleave at
  every yield; applies to classes that own a ``threading.Lock``, which
  is how the codebase marks cross-actor state — frame-confined objects
  like a per-invocation ``TaskExecutor`` mutate freely), a
  threading lock held across a yield (``REPRO011`` — the frame parks
  while an OS lock stays taken: deadlock on the event substrate),
  blocking KV wrappers called inside a generator frame (``REPRO012`` —
  ``kv.get`` is ``run_effects(clock, kv.get_g(...))``, which raises
  ``RuntimeError`` inside a frame; compose with ``yield from`` instead),
  and a ``task_clock`` block not followed by ``yield ("flush",)``
  (``REPRO013`` — compute charged inside the task function is deferred
  on the event substrate; reading ``now_ms`` before flushing skews the
  recorded compute/write split).
- **Key hygiene** (``REPRO020``/``REPRO021``): ``::`` is the KV
  namespace separator — a bare key literal containing it bypasses
  prefix stripping and changes shard placement; builtin ``hash()`` is a
  per-process PYTHONHASHSEED lottery (the PR-2 bug class), placement
  and fault seeds must hash with ``zlib.crc32``.

Scope: the determinism rules (001/002/01x) apply to *actor code paths*
— ``core/``, ``platform/``, ``apps/`` under the ``repro`` package (and
any tree with no ``repro`` ancestor, so test fixtures exercise every
rule). The jax-side training/serving dirs (``runtime/``, ``launch/``,
``models/``, ``kernels/``, ``optim/``, ``data/``, ``configs/``) run
outside the simulation substrate and are exempt. Key-hygiene rules
apply everywhere.

Suppression: ``ALLOW`` grandfathers whole files that ARE the substrate
(``core/simclock.py`` implements the clocks out of ``time.*`` — that is
its job). Individual legitimate sites carry a line pragma instead::

    time.sleep(s)  # lint: allow(REPRO001) — real-sleep knob, off by default

so the rest of the file stays covered.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable

from repro_torch.analysis.findings import Finding

__all__ = ["ALL_RULES", "lint_file", "lint_source", "lint_tree"]

# rule id -> one-line description (the CLI's --explain output)
ALL_RULES: dict[str, str] = {
    "REPRO001": "wall-clock call in actor code (use the engine clock)",
    "REPRO002": "unseeded randomness in actor code (seed via zlib.crc32)",
    "REPRO010": "lock-protected host state mutated after a yield, lockless",
    "REPRO011": "threading lock held across a yield (frame parks locked)",
    "REPRO012": "blocking KV wrapper called inside a generator frame",
    "REPRO013": "task_clock block not followed by yield (\"flush\",)",
    "REPRO020": "bare key literal contains '::' (KV namespace separator)",
    "REPRO021": "builtin hash() on a key/seed (PYTHONHASHSEED lottery)",
}

# Whole-file grandfathering: path suffix (POSIX) -> exempted rules.
# Only for files that *implement* the substrate or the analysis itself.
ALLOW: dict[str, frozenset[str]] = {
    # The clock implementations are made of time.*/threading — that is
    # the one place wall-clock belongs.
    "core/simclock.py": frozenset({"REPRO001"}),
    # kvstore.py owns NAMESPACE_SEP and the '::' composition helpers.
    "core/kvstore.py": frozenset({"REPRO020"}),
    # The linter talks about the patterns it detects.
    "analysis/effects.py": frozenset(ALL_RULES),
}

# Directories (relative to the repro package root) inside the
# determinism boundary. Everything else only gets the key-hygiene rules.
ACTOR_DIRS = ("core", "platform", "apps", "analysis")

_DETERMINISM_RULES = frozenset(
    {"REPRO001", "REPRO002", "REPRO010", "REPRO011", "REPRO012", "REPRO013"})

_PRAGMA = re.compile(r"#\s*lint:\s*allow\(([\w\s,*]+)\)")

_WALLCLOCK_TIME_FNS = frozenset({
    "time", "time_ns", "monotonic", "monotonic_ns", "perf_counter",
    "perf_counter_ns", "sleep", "thread_time", "process_time",
})
_WALLCLOCK_DATETIME_FNS = frozenset({"now", "utcnow", "today"})

# random-module functions drawing from the shared global generator.
_GLOBAL_RANDOM_FNS = frozenset({
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "betavariate",
    "expovariate", "triangular", "vonmisesvariate", "paretovariate",
    "weibullvariate", "lognormvariate", "getrandbits", "randbytes",
    "seed",
})

# Blocking wrappers on the sharded KV store: each is
# ``run_effects(clock, <name>_g(...))`` and must never run inside a
# generator frame (the frame-side effect primitives raise RuntimeError).
_BLOCKING_KV_METHODS = frozenset({
    "put", "get", "mget", "publish", "put_if_absent",
    "increment_dependency", "deposit_and_increment", "register_counter",
    "register_counters", "journal_append", "journal_scan",
})
# Receivers the blocking-wrapper rule believes are KV stores: a bare
# name or terminal attribute exactly matching one of these.
_KV_RECEIVER_NAMES = frozenset({"kv", "kvstore", "store"})

# "lock"/"mutex" suffix, but not "clock"/"block" (task_clock is a
# charge context manager, not a lock).
_LOCKISH = re.compile(r"(?<![cb])(lock|mutex)s?$", re.IGNORECASE)

# Threading synchronisation constructors: a class assigning one of these
# to a self attribute declares its state *shared across actors/threads*,
# which is what brings its ``*_g`` methods under REPRO010. Effect lanes
# (``clock.lock()``) are not in this set — lane discipline is tracked
# separately via ``yield ("acquire", ...)`` / ``.release()``.
_LOCK_CTORS = frozenset(
    {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"})


def _class_owns_threading_lock(cls: ast.ClassDef) -> bool:
    """Does this class assign a threading lock to an instance attribute?"""
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _terminal_name(node.value.func) in _LOCK_CTORS:
            if any(isinstance(t, ast.Attribute) for t in node.targets):
                return True
    return False


def _terminal_name(node: ast.AST) -> str:
    """The rightmost identifier of a Name/Attribute chain ('' otherwise)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _is_lockish(node: ast.AST) -> bool:
    """Heuristic: does this expression denote a threading lock?"""
    name = _terminal_name(node)
    if name:
        return bool(_LOCKISH.search(name))
    if isinstance(node, ast.Call):
        return _is_lockish(node.func)
    return False


def _contains_yield(node: ast.AST) -> bool:
    """Yield/YieldFrom anywhere under ``node``, not crossing into nested
    function/class definitions."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(child, (ast.Yield, ast.YieldFrom)):
            return True
        if _contains_yield(child):
            return True
    return False


def _is_flush_yield(stmt: ast.stmt) -> bool:
    """``yield ("flush",)`` as a bare expression statement."""
    if not isinstance(stmt, ast.Expr) or not isinstance(stmt.value, ast.Yield):
        return False
    val = stmt.value.value
    return (isinstance(val, ast.Tuple) and val.elts
            and isinstance(val.elts[0], ast.Constant)
            and val.elts[0].value == "flush")


def _is_acquire_yield(stmt: ast.stmt) -> bool:
    """``yield ("acquire", lane)`` as a bare expression statement."""
    if not isinstance(stmt, ast.Expr) or not isinstance(stmt.value, ast.Yield):
        return False
    val = stmt.value.value
    return (isinstance(val, ast.Tuple) and val.elts
            and isinstance(val.elts[0], ast.Constant)
            and val.elts[0].value == "acquire")


def _is_release_call(stmt: ast.stmt) -> bool:
    """``<lane>.release()`` as a statement."""
    return (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
            and isinstance(stmt.value.func, ast.Attribute)
            and stmt.value.func.attr == "release")


def _self_mutation_target(stmt: ast.stmt, self_name: str) -> "ast.AST | None":
    """The ``self.attr`` / ``self.attr[...]`` target this statement
    mutates, if any."""
    targets: list[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target] if stmt.target is not None else []
    for t in targets:
        node = t
        while isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == self_name:
            return t
    return None


class _ModuleLint(ast.NodeVisitor):
    """One pass over one module: expression-level rules + the
    statement-ordered generator-discipline walk per function."""

    def __init__(self, rel: str, rules: frozenset[str]):
        self.rel = rel
        self.rules = rules
        self.findings: list[Finding] = []
        # local alias -> module ("time" / "datetime" / "random")
        self.module_aliases: dict[str, str] = {}
        # local name -> (module, original function name) for from-imports
        self.from_imports: dict[str, tuple[str, str]] = {}
        self._doc_strings: set[int] = set()  # lineno of bare string stmts
        # enclosing-class stack: True where the class owns a threading
        # lock (its instances are shared, so REPRO010 applies).
        self._class_locks: list[bool] = []

    # -- plumbing -----------------------------------------------------------
    def report(self, rule: str, node: ast.AST, message: str) -> None:
        if rule in self.rules:
            self.findings.append(Finding(
                rule=rule, path=self.rel,
                line=getattr(node, "lineno", 0),
                col=getattr(node, "col_offset", 0) + 1,
                message=message))

    # -- imports ------------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            root = alias.name.split(".")[0]
            if root in ("time", "datetime", "random"):
                self.module_aliases[alias.asname or root] = root
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module in ("time", "datetime", "random"):
            for alias in node.names:
                self.from_imports[alias.asname or alias.name] = (
                    node.module, alias.name)
        self.generic_visit(node)

    # -- expression-level rules ---------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        self._check_wallclock(node)
        self._check_random(node)
        if isinstance(node.func, ast.Name) and node.func.id == "hash" \
                and node.args:
            self.report(
                "REPRO021", node,
                "builtin hash() is salted per process (PYTHONHASHSEED); "
                "hash placement/fault seeds with zlib.crc32 instead")
        self.generic_visit(node)

    def _check_wallclock(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            base = fn.value
            # time.<fn>() via "import time"
            if isinstance(base, ast.Name) and \
                    self.module_aliases.get(base.id) == "time" and \
                    fn.attr in _WALLCLOCK_TIME_FNS:
                self.report(
                    "REPRO001", node,
                    f"time.{fn.attr}() in actor code; durations and "
                    f"deadlines must come from the engine clock")
                return
            # datetime.datetime.now() / datetime.date.today()
            if fn.attr in _WALLCLOCK_DATETIME_FNS:
                if isinstance(base, ast.Attribute) and \
                        isinstance(base.value, ast.Name) and \
                        self.module_aliases.get(base.value.id) == "datetime":
                    self.report(
                        "REPRO001", node,
                        f"datetime wall-clock read ({fn.attr}) in actor "
                        f"code; use clock.now_ms()")
                    return
                # "from datetime import datetime" -> datetime.now()
                if isinstance(base, ast.Name) and \
                        self.from_imports.get(base.id, ("", ""))[0] == \
                        "datetime":
                    self.report(
                        "REPRO001", node,
                        f"datetime wall-clock read ({fn.attr}) in actor "
                        f"code; use clock.now_ms()")
                    return
        elif isinstance(fn, ast.Name):
            mod, orig = self.from_imports.get(fn.id, ("", ""))
            if mod == "time" and orig in _WALLCLOCK_TIME_FNS:
                self.report(
                    "REPRO001", node,
                    f"time.{orig}() in actor code; durations and deadlines "
                    f"must come from the engine clock")

    def _check_random(self, node: ast.Call) -> None:
        fn = node.func
        unseeded_ctor = False
        global_fn = ""
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
                and self.module_aliases.get(fn.value.id) == "random":
            if fn.attr in _GLOBAL_RANDOM_FNS:
                global_fn = fn.attr
            elif fn.attr in ("Random", "SystemRandom") and not node.args:
                unseeded_ctor = True
        elif isinstance(fn, ast.Name):
            mod, orig = self.from_imports.get(fn.id, ("", ""))
            if mod == "random":
                if orig in _GLOBAL_RANDOM_FNS:
                    global_fn = orig
                elif orig in ("Random", "SystemRandom") and not node.args:
                    unseeded_ctor = True
        if global_fn:
            self.report(
                "REPRO002", node,
                f"random.{global_fn}() draws from the shared unseeded "
                f"global generator; use random.Random(zlib.crc32(token))")
        elif unseeded_ctor:
            self.report(
                "REPRO002", node,
                "random.Random() without a seed is nondeterministic "
                "across runs; seed it with zlib.crc32(token)")

    def visit_Expr(self, node: ast.Expr) -> None:
        # Bare string statements are documentation: exempt from the
        # '::' key-hygiene rule (RST uses '::' constantly).
        if isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, str):
            self._doc_strings.add(node.value.lineno)
        self.generic_visit(node)

    def visit_Constant(self, node: ast.Constant) -> None:
        if isinstance(node.value, str) and "::" in node.value and \
                node.lineno not in self._doc_strings:
            self.report(
                "REPRO020", node,
                "bare key literal contains '::' (the KV namespace "
                "separator); compose namespaced keys with NAMESPACE_SEP "
                "via kvstore helpers, or the key's shard placement will "
                "silently change")
        self.generic_visit(node)

    # -- generator discipline ------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_locks.append(_class_owns_threading_lock(node))
        self.generic_visit(node)
        self._class_locks.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._check_generator(node)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def _check_generator(self, fn: ast.FunctionDef) -> None:
        is_gen = _contains_yield(fn)
        if not is_gen:
            return
        self_name = fn.args.args[0].arg if fn.args.args else ""
        # REPRO010 only bites where interleaving frames can actually
        # race: methods of classes that declare shared state by owning a
        # threading lock. Frame-confined hosts (one actor drives every
        # generator of the instance) mutate freely at any point.
        shared_host = bool(self._class_locks and self._class_locks[-1])
        effect_gen = fn.name.endswith("_g") and shared_host
        state = _GenState()
        self._walk_statements(fn.body, fn, state, self_name, effect_gen,
                              lock_depth=0)

    def _walk_statements(self, body: list[ast.stmt], fn: ast.FunctionDef,
                         state: "_GenState", self_name: str,
                         effect_gen: bool, lock_depth: int) -> None:
        for i, stmt in enumerate(body):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested defs are linted on their own visit

            # REPRO010: self-state mutation after the first yield in a
            # *_g effect generator, with no lock held (neither a with-
            # lock nor an effect-lane acquired via yield ("acquire",)).
            if effect_gen and state.yielded and lock_depth == 0 \
                    and not state.effect_lock_held:
                target = _self_mutation_target(stmt, self_name)
                if target is not None:
                    self.report(
                        "REPRO010", stmt,
                        f"{fn.name} mutates host state "
                        f"({ast.unparse(target)}) after its first yield "
                        f"without holding a lock; another frame may "
                        f"interleave at every yield — mutate before the "
                        f"first yield or under a lock")

            # REPRO012: blocking KV wrapper inside a generator frame.
            for call in self._calls_in(stmt):
                cfn = call.func
                if isinstance(cfn, ast.Attribute) and \
                        cfn.attr in _BLOCKING_KV_METHODS and \
                        _terminal_name(cfn.value) in _KV_RECEIVER_NAMES:
                    self.report(
                        "REPRO012", call,
                        f"blocking kv.{cfn.attr}(...) inside generator "
                        f"{fn.name}; it re-enters run_effects (RuntimeError "
                        f"inside an event frame) — use "
                        f"'yield from kv.{cfn.attr}_g(...)'")

            if isinstance(stmt, ast.With):
                lockish = any(_is_lockish(item.context_expr)
                              for item in stmt.items)
                task_clockish = any(
                    isinstance(item.context_expr, ast.Call)
                    and _terminal_name(item.context_expr.func) == "task_clock"
                    for item in stmt.items)
                if lockish and _contains_yield(stmt):
                    # REPRO011: the frame would suspend holding an OS
                    # lock; on the event substrate every other frame
                    # shares this driver thread — deadlock.
                    self.report(
                        "REPRO011", stmt,
                        f"lock held across a yield in {fn.name}; a parked "
                        f"frame keeps the OS lock taken — use the clock's "
                        f"effect lock (yield (\"acquire\", lane) / "
                        f"lane.release()) instead")
                if task_clockish:
                    # REPRO013: the statement after the task_clock block
                    # must flush deferred compute charges.
                    nxt = body[i + 1] if i + 1 < len(body) else None
                    if nxt is None or not _is_flush_yield(nxt):
                        self.report(
                            "REPRO013", stmt,
                            f"task_clock block in {fn.name} not followed "
                            f"by yield (\"flush\",); compute charged "
                            f"inside the task is deferred on the event "
                            f"substrate and must be flushed before "
                            f"reading the clock")
                self._walk_statements(
                    stmt.body, fn, state, self_name, effect_gen,
                    lock_depth + (1 if lockish else 0))
                if _contains_yield(stmt):
                    state.yielded = True
                continue

            if _is_acquire_yield(stmt):
                state.effect_lock_held = True
                state.yielded = True
                continue
            if _is_release_call(stmt):
                state.effect_lock_held = False
                continue

            # Recurse into compound statements, threading the yielded
            # flag: a yield anywhere in a loop body makes every
            # statement of that body "after a yield" (second iteration).
            for sub in self._sub_bodies(stmt):
                if isinstance(stmt, (ast.For, ast.While)) and \
                        _contains_yield(stmt):
                    state.yielded = True
                self._walk_statements(sub, fn, state, self_name,
                                      effect_gen, lock_depth)
            if _contains_yield(stmt):
                state.yielded = True

    @staticmethod
    def _sub_bodies(stmt: ast.stmt) -> list[list[ast.stmt]]:
        bodies: list[list[ast.stmt]] = []
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if sub:
                bodies.append(sub)
        for handler in getattr(stmt, "handlers", ()):
            bodies.append(handler.body)
        return bodies

    @staticmethod
    def _calls_in(stmt: ast.stmt) -> Iterable[ast.Call]:
        """Calls in this statement's OWN expressions — compound
        statements contribute only their headers (their nested bodies
        are walked by the statement loop itself, which would otherwise
        double-report)."""
        if isinstance(stmt, (ast.If, ast.While)):
            exprs: list[ast.AST] = [stmt.test]
        elif isinstance(stmt, ast.For):
            exprs = [stmt.iter]
        elif isinstance(stmt, ast.With):
            exprs = [item.context_expr for item in stmt.items]
        elif isinstance(stmt, ast.Try):
            exprs = []
        else:
            exprs = [stmt]
        for e in exprs:
            for node in ast.walk(e):
                if isinstance(node, ast.Call):
                    yield node


class _GenState:
    __slots__ = ("yielded", "effect_lock_held")

    def __init__(self) -> None:
        self.yielded = False
        self.effect_lock_held = False


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


# Top-level dirs of the repro package, for resolving lint roots that
# point inside it (``--check src/repro`` yields paths like "core/dag.py"
# with no "repro" component to anchor on).
_REPRO_TOP_DIRS = frozenset({
    "core", "platform", "apps", "analysis", "runtime", "launch", "models",
    "kernels", "optim", "data", "configs",
})


def _rules_for(rel: str) -> frozenset[str]:
    """The rule set applying to ``rel`` (repo-relative POSIX path)."""
    parts = rel.split("/")
    if "repro" in parts:
        sub = parts[parts.index("repro") + 1:]
    elif parts and parts[0] in _REPRO_TOP_DIRS:
        sub = parts
    else:
        sub = None  # unknown tree (e.g. test fixtures): every rule applies
    rules = frozenset(ALL_RULES)
    if sub is not None and (not sub or sub[0] not in ACTOR_DIRS):
        # Outside the simulation substrate: key hygiene only.
        rules = rules - _DETERMINISM_RULES
    for suffix, exempt in ALLOW.items():
        if rel.endswith(suffix):
            rules = rules - exempt
    return rules


def lint_source(source: str, rel: str,
                rules: "frozenset[str] | None" = None) -> list[Finding]:
    """Lint one module's source text; ``rel`` is its repo-relative path
    (drives rule scoping and finding locations)."""
    if rules is None:
        rules = _rules_for(rel)
    if not rules:
        return []
    tree = ast.parse(source, filename=rel)
    lint = _ModuleLint(rel, rules)
    lint.visit(tree)
    lines = source.splitlines()
    out: list[Finding] = []
    for f in lint.findings:
        snippet = lines[f.line - 1].strip() if 0 < f.line <= len(lines) else ""
        m = _PRAGMA.search(snippet)
        if m:
            allowed = {r.strip() for r in m.group(1).split(",")}
            if "*" in allowed or f.rule in allowed:
                continue
        out.append(Finding(rule=f.rule, path=f.path, line=f.line, col=f.col,
                           message=f.message, snippet=snippet))
    return out


def lint_file(path: "str | Path", root: "str | Path | None" = None) \
        -> list[Finding]:
    p = Path(path)
    rel = p.relative_to(root).as_posix() if root is not None else p.as_posix()
    return lint_source(p.read_text(), rel)


def lint_tree(root: "str | Path") -> list[Finding]:
    """Lint every ``*.py`` under ``root`` (deterministic order)."""
    rootp = Path(root)
    findings: list[Finding] = []
    for p in sorted(rootp.rglob("*.py")):
        findings.extend(lint_file(p, rootp))
    return findings
