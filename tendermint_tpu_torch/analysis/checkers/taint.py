"""taint — inter-procedural consensus-determinism taint analysis.

The `determinism` checker is lexical and file-local: it can say
"this line calls `time.time()`" but not "this function's bytes end up
inside a signed vote". This pass closes that gap with the flowgraph
(analysis/flowgraph.py): it walks the call graph DOWNWARD from every
SINK — the functions whose output must be byte-identical on every
honest node (signed-type serialization, block/PartSet construction,
statetree hashing, the ABCI transition, WAL appends, signing) — and
flags any SOURCE of nondeterminism inside that reachable cone:

    wallclock     time.time/time_ns, datetime.now/utcnow/today
    rng           unseeded module-level random.*, os.urandom, uuid4,
                  secrets.*
    env           os.environ / os.getenv outside utils/knobs.py, and
                  knob reads (utils.knobs.knob_*) of non-blessed knobs
    order         iteration over set expressions (PYTHONHASHSEED hash
                  order) or over `.keys()/.values()/.items()` of an
                  object attribute (peer/thread arrival order), with
                  intraprocedural def-use tracking so `sorted(...)`
                  launders and `xs = self.m.values(); for x in xs`
                  still counts
    hashid        builtin id() / hash() — both interpreter- or
                  seed-dependent
    devicefloat   torch float reductions (sum/mean/dot/...), whose
                  accumulation order is backend-dependent; integer
                  bit-packing (shift/mask operands or integer dtype=)
                  is exact and laundered

Flows are cut ONLY at the BLESSED-SEAM catalog below. A seam is not an
opinion: every entry must name the parity/differential test that
proves the cut is sound, and `_stale_seams()` re-checks on every run
that the named test still exists — a blessing whose test is gone is
itself a finding, so the catalog cannot rot. The same rule keeps the
SINK catalog honest: a sink qname that no longer resolves in the
flowgraph is a finding too.

Residual findings are suppressed per-line with a ``tmlint``
``allow(taint)`` pragma — same grammar as the engine's; the engine
counts these against the global pragma budget, this module enforces
that each one still suppresses something.

The runtime counterpart — the per-height transition digest and the
dual-PYTHONHASHSEED differential replay that *executes* the property
this pass claims statically — lives in analysis/divergence.py.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

from tendermint_tpu_torch.analysis.engine import Finding, PRAGMA_RE
from tendermint_tpu_torch.analysis.flowgraph import (
    FlowGraph, FunctionInfo, _attr_chain)
from tendermint_tpu_torch.analysis.checkers.determinism import (
    _UNSEEDED_RANDOM, _WALLCLOCK_DT, _WALLCLOCK_TIME)

_SELF_REL = "tendermint_tpu_torch/analysis/checkers/taint.py"

# ---------------------------------------------------------------- sinks

#: Functions whose output is consensus-visible bytes. The taint cone is
#: everything transitively callable from these.
SINKS: Tuple[Tuple[str, str], ...] = (
    ("tendermint_tpu_torch.types.vote.sign_bytes_template",
     "canonical vote sign-bytes template"),
    ("tendermint_tpu_torch.types.vote.Vote.sign_bytes",
     "signed vote serialization"),
    ("tendermint_tpu_torch.types.proposal.Proposal.sign_bytes",
     "signed proposal serialization"),
    ("tendermint_tpu_torch.types.proposal.Heartbeat.sign_bytes",
     "signed heartbeat serialization"),
    ("tendermint_tpu_torch.types.priv_validator.PrivValidator.sign_vote",
     "vote signing"),
    ("tendermint_tpu_torch.types.priv_validator.PrivValidator.sign_proposal",
     "proposal signing"),
    ("tendermint_tpu_torch.types.block.Block.to_bytes",
     "block wire bytes"),
    ("tendermint_tpu_torch.types.block.Block.hash",
     "block hash"),
    ("tendermint_tpu_torch.types.block.Block.make_part_set",
     "proposal part-set bytes"),
    ("tendermint_tpu_torch.types.part_set.PartSet.from_data",
     "part-set construction"),
    ("tendermint_tpu_torch.types.part_set.PartSet.from_data_streaming",
     "streaming part-set construction"),
    ("tendermint_tpu_torch.storage.wal.WAL.save",
     "WAL append (replay transcript)"),
    ("tendermint_tpu_torch.storage.wal.WAL.save_end_height",
     "WAL height marker"),
    ("tendermint_tpu_torch.statetree.tree.StateTree.commit",
     "statetree node hashing + root flush"),
    ("tendermint_tpu_torch.statetree.store.leaf_hash",
     "statetree leaf node hash"),
    ("tendermint_tpu_torch.statetree.store.inner_hash",
     "statetree inner node hash"),
    ("tendermint_tpu_torch.consensus.reactor.ConsensusReactor"
     "._build_compact_locked",
     "compact-relay short-id offer assembly"),
    ("tendermint_tpu_torch.consensus.reactor.ConsensusReactor"
     "._compact_finish",
     "compact-relay block reconstruction"),
    ("tendermint_tpu_torch.state.execution.BlockExecutor.apply_block",
     "ABCI transition (app_hash, validator updates)"),
    ("tendermint_tpu_torch.consensus.state.ConsensusState._create_proposal_block",
     "block construction (reap, evidence, commit assembly)"),
    ("tendermint_tpu_torch.consensus.state.ConsensusState._decide_proposal",
     "proposal decision + signing"),
)

# ------------------------------------------------------------- blessed

@dataclass(frozen=True)
class Seam:
    kind: str      # "function" | "module" | "knob"
    target: str    # function qname / module qname prefix / knob name
    test: str      # "tests/test_x.py::test_name" proving the cut
    why: str


#: Every entry names the port's parity/differential test that justifies
#: the cut. _stale_seams() fails the lint run if the test disappears.
_NET_PARITY = ("tests/test_torch_consensus.py::"
               "test_net_matches_jax_block_for_block")
BLESSED: Tuple[Seam, ...] = (
    Seam("function", "tendermint_tpu_torch.utils.clock.now_ns",
         _NET_PARITY,
         "the one sanctioned protocol clock; a net on a pinned source "
         "gives the JAX package's blocks byte for byte"),
    Seam("function", "tendermint_tpu_torch.utils.clock.now_s",
         _NET_PARITY,
         "seconds view of the sanctioned clock (backoff/replay "
         "schedules follow the same pinnable source)"),
    Seam("function", "tendermint_tpu_torch.utils.clock.wall_ns",
         "tests/test_torch_trace.py::test_stamped_bytes_equal_jax",
         "the causal plane's pinnable wall clock: span stamps only, "
         "byte-equal to the JAX package's under a pinned source"),
    Seam("module", "tendermint_tpu_torch.telemetry", _NET_PARITY,
         "metrics/spans/profiler are observe-only; the net's blocks "
         "equal the JAX package's with the registry on (its default)"),
    Seam("module", "tendermint_tpu_torch.utils.log", _NET_PARITY,
         "structured logging renders observations, never feeds "
         "protocol bytes; covered by the same net parity"),
    Seam("module", "tendermint_tpu_torch.utils.fail",
         "tests/test_torch_fail_points.py::"
         "test_crash_at_every_index_recovers_the_jax_apphash",
         "fail-point hooks are no-ops unless armed; the crash sweep "
         "recovers the JAX package's app_hash at every index"),
    Seam("knob", "TM_CUDA_STATE_TREE",
         "tests/test_torch_statetree.py::"
         "test_crash_at_statetree_points_recovers_control_root",
         "tree-backed app_hash equals the control root under the "
         "statetree crash sweep"),
    Seam("knob", "TM_CUDA_MESH",
         "tests/test_torch_mesh.py::"
         "test_root_host_mesh_dispatch_bit_equality",
         "mesh dispatch is byte-equal to the host path"),
    Seam("knob", "TM_CUDA_PIPELINE",
         "tests/test_torch_pipeline.py::"
         "test_net_on_equals_off_equals_jax_on",
         "serial and pipelined commit give the same blocks, byte for "
         "byte, as the JAX package's pipelined net"),
    Seam("knob", "TM_CUDA_NO_NATIVE",
         "tests/test_torch_no_native.py::"
         "test_merkle_and_part_sets_take_hashlib",
         "the pure host routes give the native routes' bytes (codec, "
         "kv core, prep, sign phases, roots, proofs, part sets)"),
    Seam("knob", "TM_CUDA_VERIFIER",
         "tests/test_torch_verifier.py::"
         "test_verdicts_match_jax_on_tampered_items",
         "the backend picks between implementations whose verdicts "
         "equal the JAX package's and the oracle's"),
    Seam("knob", "TM_CUDA_AUTO_THRESHOLD",
         "tests/test_torch_verifier.py::test_small_auto_batch_stays_on_host",
         "the scalar/batch crossover only picks between oracle-equal "
         "routes"),
    Seam("knob", "TM_CUDA_COALESCE",
         "tests/test_torch_coalescer.py::"
         "test_threaded_single_vote_callers_get_their_own_verdicts",
         "a coalesced dispatch gives each caller the verdicts of a "
         "call of its own"),
    Seam("knob", "TM_CUDA_COALESCE_WAIT_MS",
         "tests/test_torch_coalescer.py::"
         "test_threaded_single_vote_callers_get_their_own_verdicts",
         "the merge window changes latency and batch size, never "
         "verdicts"),
    Seam("knob", "TM_CUDA_COALESCE_MAX_BATCH",
         "tests/test_torch_coalescer.py::"
         "test_threaded_single_vote_callers_get_their_own_verdicts",
         "the early-flush size changes the dispatch shape, never "
         "verdicts"),
    Seam("knob", "TM_CUDA_MESH_FORCE_DEVICES",
         "tests/test_torch_mesh.py::"
         "test_batch_verifier_mesh_verdicts_equal_jax",
         "logical devices change the sharding, never the verdicts"),
    Seam("knob", "TM_CUDA_DIVERGENCE",
         "tests/test_torch_divergence.py::"
         "test_dual_hash_seed_replay_identical_on_cpu",
         "the divergence recorder observes the transition, never "
         "alters it; dual-seed replay proves digest streams match"),
)

# ------------------------------------------------------------- sources

_KNOB_READERS = frozenset((
    "knob_raw", "knob_str", "knob_spec", "knob_bool", "knob_set",
    "knob_flag3", "knob_int", "knob_float"))

_RNG_MODULE_FUNCS = _UNSEEDED_RANDOM
_FLOAT_REDUCE = frozenset((
    "sum", "mean", "dot", "matmul", "einsum", "prod", "cumsum",
    "average", "std", "var"))
_DEVICE_MODULES = frozenset(("torch",))

#: wrapping one of these around an order-tainted iterable launders it
_ORDER_LAUNDER = frozenset((
    "sorted", "min", "max", "sum", "len", "set", "frozenset", "dict",
    "any", "all"))
#: these preserve order-taint from argument to result
_ORDER_KEEP = frozenset((
    "list", "tuple", "enumerate", "zip", "map", "filter", "reversed",
    "iter"))
_ORDER_METHODS = frozenset(("keys", "values", "items"))
_COMP_NODES = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


def _dedupe(hits: List["_Hit"]) -> List["_Hit"]:
    seen, out = set(), []
    for h in hits:
        key = (h.lineno, h.kind, h.detail)
        if key not in seen:
            seen.add(key)
            out.append(h)
    return out


@dataclass
class _Hit:
    lineno: int
    kind: str
    detail: str


def _iter_calls(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            yield n


def _resolves_to(imports: Dict[str, str], name: str, module: str) -> bool:
    """Does local `name` denote stdlib module `module` here?"""
    return imports.get(name, name if name == module else None) == module


class _SourceScan:
    """One pass over a reachable function's AST collecting source hits,
    with statement-order def-use tracking for order taint."""

    def __init__(self, fi: FunctionInfo, imports: Dict[str, str],
                 in_knobs_py: bool, blessed_knobs: Set[str]):
        self.fi = fi
        self.imports = imports
        self.in_knobs_py = in_knobs_py
        self.blessed_knobs = blessed_knobs
        self.hits: List[_Hit] = []
        self.tainted: Set[str] = set()   # names bound to order-sources
        #: comprehension node ids excluded from the standalone generator
        #: check (laundered, content-order-free, or assign-tainted)
        self._skip_comps: Set[int] = set()
        #: id()/hash() call node ids in key/compare position (the value
        #: never reaches output bytes)
        self._benign_hashid: Set[int] = set()

    # -- entry ---------------------------------------------------------

    def run(self) -> List[_Hit]:
        self._premark()
        self._scan_body(self.fi.node.body)
        for call in _iter_calls(self.fi.node):
            self._scan_call(call)
        for n in ast.walk(self.fi.node):
            if isinstance(n, (ast.ListComp, ast.GeneratorExp)) and \
                    id(n) not in self._skip_comps:
                for gen in n.generators:
                    self._check_iter(gen.iter)
            elif isinstance(n, ast.Attribute) and n.attr == "environ":
                chain = _attr_chain(n)
                if chain and _resolves_to(self.imports, chain[0], "os") \
                        and not self.in_knobs_py:
                    self.hits.append(_Hit(
                        n.lineno, "env", "os.environ read"))
        return _dedupe(self.hits)

    def _premark(self) -> None:
        for n in ast.walk(self.fi.node):
            if isinstance(n, ast.Call):
                chain = _attr_chain(n.func)
                if chain and len(chain) == 1 and \
                        chain[0] in _ORDER_LAUNDER:
                    # sorted(x for x in m.items()) — output order is
                    # imposed by the wrapper, the inner walk is fine
                    for a in n.args:
                        if isinstance(a, _COMP_NODES):
                            self._skip_comps.add(id(a))
                if isinstance(n.func, ast.Attribute) and \
                        n.func.attr in ("get", "pop", "setdefault") \
                        and n.args:
                    for c in ast.walk(n.args[0]):
                        if isinstance(c, ast.Call):
                            self._benign_hashid.add(id(c))
            elif isinstance(n, (ast.DictComp, ast.SetComp)):
                # builds content, not an ordered stream; iteration of
                # the *result* is caught via the tainted-name rule
                self._skip_comps.add(id(n))
            elif isinstance(n, (ast.Subscript, ast.Compare)):
                # d[id(x)] / id(a) == id(b): the value is a lookup
                # key or identity test, never output bytes
                target = n.slice if isinstance(n, ast.Subscript) else n
                for c in ast.walk(target):
                    if isinstance(c, ast.Call):
                        self._benign_hashid.add(id(c))

    # -- call-shaped sources ------------------------------------------

    def _scan_call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if not chain:
            return
        root, attr = chain[0], chain[-1]

        if len(chain) >= 2 and _resolves_to(self.imports, root, "time") \
                and attr in _WALLCLOCK_TIME:
            self.hits.append(_Hit(node.lineno, "wallclock",
                                  f"time.{attr}()"))
        elif attr in _WALLCLOCK_DT and "datetime" in (
                self.imports.get(root, root), root):
            self.hits.append(_Hit(node.lineno, "wallclock",
                                  f"datetime {attr}()"))
        elif len(chain) == 1 and attr in _WALLCLOCK_TIME and \
                self.imports.get(attr, "").startswith("time."):
            self.hits.append(_Hit(node.lineno, "wallclock", f"{attr}()"))

        if len(chain) >= 2 and _resolves_to(self.imports, root, "random") \
                and attr in _RNG_MODULE_FUNCS:
            self.hits.append(_Hit(node.lineno, "rng",
                                  f"unseeded random.{attr}()"))
        elif len(chain) >= 2 and _resolves_to(self.imports, root, "os") \
                and attr == "urandom":
            self.hits.append(_Hit(node.lineno, "rng", "os.urandom()"))
        elif len(chain) >= 2 and _resolves_to(
                self.imports, root, "uuid") and attr.startswith("uuid"):
            self.hits.append(_Hit(node.lineno, "rng", f"uuid.{attr}()"))
        elif len(chain) >= 2 and _resolves_to(
                self.imports, root, "secrets"):
            self.hits.append(_Hit(node.lineno, "rng",
                                  f"secrets.{attr}()"))

        if len(chain) >= 2 and _resolves_to(self.imports, root, "os") \
                and attr == "getenv" and not self.in_knobs_py:
            self.hits.append(_Hit(node.lineno, "env", "os.getenv()"))

        if attr in _KNOB_READERS and not self.in_knobs_py:
            self._scan_knob_read(node, attr)

        if len(chain) == 1 and attr in ("id", "hash") and \
                attr not in self.imports and \
                id(node) not in self._benign_hashid:
            self.hits.append(_Hit(
                node.lineno, "hashid",
                f"builtin {attr}() is interpreter/seed-dependent"))

        if len(chain) >= 2 and attr in _FLOAT_REDUCE and \
                self.imports.get(root, "") in _DEVICE_MODULES and \
                not _integer_evidence(node):
            self.hits.append(_Hit(
                node.lineno, "devicefloat",
                f"{root}.{attr}() float accumulation order is "
                f"backend-dependent"))

    def _scan_knob_read(self, node: ast.Call, reader: str) -> None:
        if not node.args:
            return
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if arg.value not in self.blessed_knobs:
                self.hits.append(_Hit(
                    node.lineno, "knob",
                    f"{reader}({arg.value!r}) — knob not in the "
                    f"blessed-seam catalog"))
        else:
            self.hits.append(_Hit(
                node.lineno, "knob",
                f"{reader}(<dynamic name>) — unresolvable knob read"))

    # -- order sources (statement-order def-use) ----------------------

    def _scan_body(self, body: Iterable[ast.stmt]) -> None:
        for stmt in body:
            self._scan_stmt(stmt)

    def _scan_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            taint = self._order_taint(stmt.value)
            if isinstance(stmt.value, _COMP_NODES):
                # the taint (if any) moves onto the bound name; the
                # comp itself is not reported standalone
                self._skip_comps.add(id(stmt.value))
            for tgt in stmt.targets:
                for name in _target_names(tgt):
                    if taint:
                        self.tainted.add(name)
                    else:
                        self.tainted.discard(name)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._check_iter(stmt.iter)
            if isinstance(stmt.iter, _COMP_NODES):
                self._skip_comps.add(id(stmt.iter))
            for name in _target_names(stmt.target):
                self.tainted.discard(name)
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                self._scan_stmt(child)

    def _check_iter(self, expr: ast.expr) -> None:
        why = self._order_taint(expr)
        if why:
            self.hits.append(_Hit(expr.lineno, "order", why))

    def _order_taint(self, expr: ast.expr) -> Optional[str]:
        """Non-None (the reason) when `expr` is iteration-order-unstable."""
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return "iteration over a set expression (hash order)"
        if isinstance(expr, (ast.ListComp, ast.GeneratorExp,
                             ast.DictComp)):
            for gen in expr.generators:
                why = self._order_taint(gen.iter)
                if why:
                    return why
            return None
        if isinstance(expr, ast.Name) and expr.id in self.tainted:
            return (f"iteration over {expr.id!r}, bound to an "
                    f"order-unstable expression above")
        if isinstance(expr, ast.Call):
            chain = _attr_chain(expr.func)
            if chain and len(chain) == 1:
                name = chain[0]
                if name in ("set", "frozenset"):
                    return "iteration over set()/frozenset() (hash order)"
                if name in _ORDER_LAUNDER:
                    return None
                if name in _ORDER_KEEP and expr.args:
                    return self._order_taint(expr.args[0])
            if chain and chain[-1] in _ORDER_METHODS and \
                    isinstance(expr.func, ast.Attribute) and \
                    isinstance(expr.func.value, ast.Attribute):
                recv = ".".join(chain[:-1])
                return (f"iteration over {recv}.{chain[-1]}() — "
                        f"attribute map insertion order is not "
                        f"consensus-replicated by construction")
            if chain and chain[-1] in _ORDER_METHODS and \
                    isinstance(expr.func, ast.Attribute) and \
                    isinstance(expr.func.value, ast.Name) and \
                    expr.func.value.id in self.tainted:
                return (f"iteration over tainted "
                        f"{expr.func.value.id}.{chain[-1]}()")
        return None


def _integer_evidence(call: ast.Call) -> bool:
    """Bit-packing reductions (shift/mask operands, integer dtype=) are
    exact integer math — order-independent, not float accumulation."""
    for kw in call.keywords:
        if kw.arg == "dtype":
            chain = _attr_chain(kw.value)
            leaf = chain[-1] if chain else ""
            if leaf.startswith(("uint", "int")):
                return True
    for arg in call.args:
        for n in ast.walk(arg):
            if isinstance(n, ast.BinOp) and isinstance(
                    n.op, (ast.LShift, ast.RShift, ast.BitOr,
                           ast.BitAnd, ast.BitXor)):
                return True
    return False


def _target_names(tgt: ast.expr) -> List[str]:
    if isinstance(tgt, ast.Name):
        return [tgt.id]
    if isinstance(tgt, (ast.Tuple, ast.List)):
        out = []
        for e in tgt.elts:
            out.extend(_target_names(e))
        return out
    return []


# ----------------------------------------------------------- the pass

@dataclass
class TaintReport:
    findings: List[Finding]
    stats: dict


def _blessed_functions() -> Set[str]:
    return {s.target for s in BLESSED if s.kind == "function"}


def _blessed_modules() -> Tuple[str, ...]:
    return tuple(s.target for s in BLESSED if s.kind == "module")


def blessed_knobs() -> Set[str]:
    return {s.target for s in BLESSED if s.kind == "knob"}


def _stale_seams(root: str) -> List[Finding]:
    """A blessing whose named test no longer exists is a finding."""
    out = []
    for seam in BLESSED:
        rel, _, test_name = seam.test.partition("::")
        path = os.path.join(root, rel)
        ok = False
        if test_name and os.path.isfile(path):
            with open(path, encoding="utf-8") as f:
                ok = f"def {test_name}(" in f.read()
        if not ok:
            out.append(Finding(
                "taint", _SELF_REL, 1,
                f"stale blessed seam {seam.kind}:{seam.target} — "
                f"named test {seam.test} no longer exists"))
    return out


def run_taint(root: str = ".",
              graph: Optional[FlowGraph] = None) -> TaintReport:
    root = os.path.abspath(root)
    if graph is None:
        graph = FlowGraph.build(root)

    findings: List[Finding] = list(_stale_seams(root))
    cut_fns = _blessed_functions()
    cut_mods = _blessed_modules()
    bknobs = blessed_knobs()

    # BFS downward from every resolvable sink; remember the sink and
    # the parent edge so findings can show the reachability witness.
    origin: Dict[str, Tuple[str, Optional[str]]] = {}
    frontier: List[str] = []
    for qname, why in SINKS:
        if qname not in graph.functions:
            findings.append(Finding(
                "taint", _SELF_REL, 1,
                f"sink catalog entry no longer resolves: {qname} "
                f"({why}) — update the SINKS catalog"))
            continue
        origin[qname] = (qname, None)
        frontier.append(qname)

    n_cut = 0
    while frontier:
        qname = frontier.pop()
        fi = graph.functions[qname]
        for cs in fi.calls:
            for target in cs.targets:
                if target in origin:
                    continue
                if target in cut_fns or \
                        any(target.startswith(m + ".") for m in cut_mods):
                    n_cut += 1
                    continue
                tfi = graph.functions.get(target)
                if tfi is None:
                    continue
                origin[target] = (origin[qname][0], qname)
                frontier.append(target)

    # scan every reachable function for sources
    n_hits = 0
    for qname in sorted(origin):
        fi = graph.functions[qname]
        mod = graph.modules[fi.module]
        in_knobs = fi.module == "tendermint_tpu_torch.utils.knobs"
        hits = _SourceScan(fi, mod.imports, in_knobs, bknobs).run()
        if not hits:
            continue
        sink, parent = origin[qname]
        via = f" via {parent}" if parent and parent != sink else ""
        for h in hits:
            n_hits += 1
            findings.append(Finding(
                "taint", fi.rel, h.lineno,
                f"{h.kind} source in {qname} reaches consensus sink "
                f"{sink}{via}: {h.detail}"))

    findings, pragma_findings = _apply_pragmas(root, graph, findings)
    findings.extend(pragma_findings)
    findings.sort(key=lambda f: (f.path, f.line))

    return TaintReport(findings=findings, stats={
        "sinks": len(SINKS),
        "reachable_functions": len(origin),
        "blessed_seams": len(BLESSED),
        "seam_cuts": n_cut,
        "raw_source_hits": n_hits,
        "findings": len(findings),
    })


def _apply_pragmas(root: str, graph: FlowGraph,
                   findings: List[Finding]):
    """Suppress findings covered by an ``allow(taint)`` pragma on the
    same or previous line; flag taint pragmas that suppress nothing.
    (Justification text and the global budget are enforced by the
    engine's pragma checker, which sees the same files.)"""
    pragmas: Dict[str, Dict[int, bool]] = {}
    for mod in graph.modules.values():
        path = os.path.join(root, mod.rel)
        if not os.path.isfile(path):
            continue
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, start=1):
                m = PRAGMA_RE.search(line)
                if m and m.group(1) == "taint":
                    pragmas.setdefault(mod.rel, {})[i] = False

    kept: List[Finding] = []
    for f in findings:
        by_line = pragmas.get(f.path, {})
        covered = None
        for ln in (f.line, f.line - 1):
            if ln in by_line:
                covered = ln
                break
        if covered is not None:
            by_line[covered] = True
        else:
            kept.append(f)

    stale = [
        Finding("taint", rel, ln,
                "taint pragma suppresses nothing — remove it")
        for rel, by_line in pragmas.items()
        for ln, used in sorted(by_line.items()) if not used
    ]
    return kept, stale
