"""ambient-singleton — module-level mutable process state must be
blessed, not accreted.

The shard plane made node assembly a VALUE: N chains in one process,
nothing chain-scoped living in module globals. This checker is the
ratchet that keeps it that way — the globals the shard refactor purged
cannot silently return. Two shapes are findings:

1. ``global NAME`` rebinding: a function rebinds a module-level name
   (lazy singletons, config snapshots, caches). This is exactly how
   every ambient singleton in the tree is built, so the detector has
   no false-negative gap for the class it polices.
2. mutated module-level containers: a module-level dict/list/set
   display (or comprehension) that function-scope code mutates in
   place (``NAME[k] = ...``, ``NAME.append(...)``) — ambient state
   without a ``global`` statement. Read-only lookup tables built at
   import time are NOT findings.

Everything that predates the ratchet — the process-default verifier,
the telemetry registry state, the profiler/queue-watch singletons, the
kernel-library and native-library caches — is enumerated in
``BLESSED`` below. Adding a
NEW ambient singleton therefore requires either threading the state
through values (the preferred fix: Node/ShardSet assembly, explicit
registries), a reviewed entry here, or a justified tmlint allow
pragma for ``ambient-singleton`` at the binding line.

Constructor-call singletons that are never rebound and never mutated
through a module-level name (e.g. a module-level ``SLOTracker()``
mutated only via its methods) are caught by rule 1 the moment any code
needs to swap or reset them — the lifecycle moment that makes
ambient state dangerous."""

from __future__ import annotations

import ast

from tendermint_tpu_torch.analysis.engine import Checker, FileContext

CHECKER_ID = "ambient-singleton"

#: method names that mutate a container in place
_MUTATORS = frozenset((
    "append", "appendleft", "extend", "insert", "add", "update",
    "setdefault", "pop", "popitem", "popleft", "remove", "discard",
    "clear",
))

#: the blessed ambient catalog: every module-level mutable singleton of
#: the port, as "repo/relative/path:name". New entries need review — the
#: default answer is value-scoping.
BLESSED = frozenset((
    # verification plane (the JAX package's, under the port's names)
    "tendermint_tpu_torch/models/verifier.py:_default",
    "tendermint_tpu_torch/ops/merkle.py:_mesh_state",
    "tendermint_tpu_torch/ops/ed25519.py:_predecomp_stats",
    "tendermint_tpu_torch/ops/ed25519.py:_sign_params_cache",
    "tendermint_tpu_torch/parallel/mesh.py:_mesh_cache",
    "tendermint_tpu_torch/utils/ed25519_fast.py:_b_table",
    "tendermint_tpu_torch/types/encoding.py:_codec",
    # the port's own: kernel libraries built and loaded once a process
    # (keyed by source digest), the per-device constant tables, and the
    # counts the kernel wrappers, the host prep and the native cores
    # keep for chip_smoke and the node's kernel line (plain integers
    # read beside the telemetry families)
    "tendermint_tpu_torch/ops/_build.py:_libs",
    "tendermint_tpu_torch/ops/ladder.py:_tables",
    "tendermint_tpu_torch/ops/ladder.py:_device_tables",
    "tendermint_tpu_torch/ops/ladder.py:launches",
    "tendermint_tpu_torch/ops/ed25519.py:_prep_stats",
    "tendermint_tpu_torch/native.py:_mod",
    "tendermint_tpu_torch/native.py:_aead_checked",
    "tendermint_tpu_torch/native.py:_ext_mods",
    # TM_CUDA_NO_NATIVE, read once a process (the JAX loaders' _tried)
    "tendermint_tpu_torch/native.py:_no_native",
    "tendermint_tpu_torch/types/encoding.py:_stats",
    "tendermint_tpu_torch/types/part_set.py:_builds",
    "tendermint_tpu_torch/pipeline.py:_stats",
    "tendermint_tpu_torch/abci/apps/kvstore.py:_routes",
    # telemetry planes (process-wide by design; the registry IS the
    # blessed ambient every instrument rides on)
    "tendermint_tpu_torch/telemetry/causal.py:_configured",
    "tendermint_tpu_torch/telemetry/causal.py:_node",
    "tendermint_tpu_torch/telemetry/causal.py:_rtt_provider",
    "tendermint_tpu_torch/telemetry/causal.py:_cap",
    "tendermint_tpu_torch/telemetry/queues.py:_configured",
    "tendermint_tpu_torch/telemetry/queues.py:_watch_thread",
    "tendermint_tpu_torch/telemetry/queues.py:_probes",
    "tendermint_tpu_torch/telemetry/queues.py:_kinds",
    "tendermint_tpu_torch/telemetry/queues.py:_callbacks",
    "tendermint_tpu_torch/telemetry/profile.py:_configured",
    "tendermint_tpu_torch/telemetry/profile.py:_configured_hz",
    "tendermint_tpu_torch/telemetry/profile.py:_prof",
    "tendermint_tpu_torch/telemetry/slo.py:_configured_mode",
    "tendermint_tpu_torch/telemetry/slo.py:_configured_sample",
    "tendermint_tpu_torch/telemetry/slo.py:_on_cache",
    "tendermint_tpu_torch/telemetry/slo.py:_rate_cache",
    # knob snapshots (configure() writes, resolve() reads)
    "tendermint_tpu_torch/chaos/__init__.py:_cfg_mode",
    "tendermint_tpu_torch/chaos/__init__.py:_cfg_seed",
    "tendermint_tpu_torch/pipeline.py:_configured",
    "tendermint_tpu_torch/ops/merkle.py:_mesh_config",
    # misc process plumbing; the clock's pinnable wall and monotonic
    # sources are the seams the tests pin (utils/clock.py)
    "tendermint_tpu_torch/p2p/switch.py:_protocol_error_types",
    "tendermint_tpu_torch/utils/clock.py:_source",
    "tendermint_tpu_torch/utils/clock.py:_wall_source",
    "tendermint_tpu_torch/utils/clock.py:_mono_source",
    "tendermint_tpu_torch/utils/log.py:_configured",
    "tendermint_tpu_torch/utils/log.py:_context",
    "tendermint_tpu_torch/utils/fail.py:_counter",
    "tendermint_tpu_torch/utils/fail.py:_callback",
    "tendermint_tpu_torch/utils/fail.py:_target",
    "tendermint_tpu_torch/utils/fail.py:_armed",
))


class AmbientSingletonChecker(Checker):
    id = CHECKER_ID
    events = (ast.Assign, ast.AnnAssign, ast.Global, ast.Call,
              ast.Subscript)

    def begin_file(self, ctx: FileContext) -> None:
        ctx.scratch[self.id] = {
            "module_bindings": {},   # name -> (line, is_mutable_literal)
            "globals": {},           # name -> line of the global stmt
            "mutated": set(),        # names mutated from function scope
        }

    def visit(self, node: ast.AST, ctx: FileContext) -> None:
        s = ctx.scratch[self.id]
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            if ctx.func_stack or ctx.class_stack:
                return
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and \
                        t.id not in s["module_bindings"]:
                    s["module_bindings"][t.id] = (
                        node.lineno, _is_mutable_literal(node.value))
        elif isinstance(node, ast.Global):
            if ctx.func_stack:
                for name in node.names:
                    s["globals"].setdefault(name, node.lineno)
        elif isinstance(node, ast.Call):
            # NAME.mutator(...) from function scope
            if ctx.func_stack and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.attr in _MUTATORS:
                s["mutated"].add(node.func.value.id)
        elif isinstance(node, ast.Subscript):
            # NAME[k] = ... / del NAME[k] from function scope
            if ctx.func_stack and isinstance(node.value, ast.Name) \
                    and isinstance(node.ctx, (ast.Store, ast.Del)):
                s["mutated"].add(node.value.id)

    def end_file(self, ctx: FileContext) -> None:
        s = ctx.scratch.pop(self.id)
        rel = ctx.rel.replace("\\", "/")
        for name, (line, mutable_lit) in sorted(
                s["module_bindings"].items()):
            if f"{rel}:{name}" in BLESSED:
                continue
            if name in s["globals"]:
                ctx.report(
                    self.id, line,
                    f"module-level name {name!r} is rebound via "
                    f"`global` (line {s['globals'][name]}) — an "
                    f"ambient process singleton; thread it through "
                    f"values (Node/ShardSet assembly) or bless it in "
                    f"analysis/checkers/ambient.py")
            elif mutable_lit and name in s["mutated"]:
                ctx.report(
                    self.id, line,
                    f"module-level container {name!r} is mutated from "
                    f"function scope — ambient process state; pass it "
                    f"as a value or bless it in "
                    f"analysis/checkers/ambient.py")


def _is_mutable_literal(value) -> bool:
    return isinstance(value, (ast.Dict, ast.List, ast.Set,
                              ast.DictComp, ast.ListComp, ast.SetComp))
