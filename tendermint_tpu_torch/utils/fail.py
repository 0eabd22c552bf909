"""Fail-point injection: the port's copy of `tendermint_tpu/utils/fail.py`
(the reference's fail.Fail() and FAIL_TEST_INDEX,
consensus/state.go:1179-1228, state/execution.go:82-107).

Each `fail_point()` call increments a process-global counter; when the
counter reaches the target index the process dies hard (os._exit), so
crash-recovery tests can kill a node at every commit-critical step and
assert it recovers (test/persist/test_failure_indices.sh's loop). The
target comes from $FAIL_TEST_INDEX (the Go reference's environment
contract, which wins when set) or from set_target() for in-process
sweeps.

Two test hooks replace the hard exit:

- set_callback(cb): `cb(index)` runs instead of os._exit when the
  counter hits the target; clear_callback() removes it.
- arm(name, cb): a one-shot named trigger: the next fail_point(name)
  with that exact name calls `cb(name)` (which may raise to simulate a
  crash) whatever the counter.

Every commit-critical call site uses a stable dotted name from
COMMIT_POINTS (in the order one commit passes them). Call sites in the
port: consensus/state.py (the consensus.* points, ten sites over the
serial and the pipelined finalize), state/execution.py (the four
execution.* points), and the RECOVERY_POINTS: storage/snapshot.py
(snapshot.after_chunk, snapshot.before_publish), statesync/reactor.py
(statesync.before_apply, statesync.after_restore) and
storage/block_store.py (prune.mid_range), and statetree/tree.py
(statetree.before_root_flush, statetree.after_node_write, inside
StateTree.commit: they fire only with the state tree on, so a
bucket-mode sweep never counts them).
"""

from __future__ import annotations

import os
import sys
import threading

_lock = threading.Lock()
_counter = 0
_callback = None  # test hook: replaces os._exit when the target index hits
_target = None    # programmatic FAIL_TEST_INDEX (env wins when both set)
_armed: dict = {}  # name -> one-shot callback

# The commit-critical fail points, in the order one PIPELINED commit
# passes them (config.base.pipeline's default: consensus/state.py
# _finalize_commit_pipelined -> state/execution.py apply_block with the
# store writes staged, then the group flush + the height's single WAL
# fsync). before/after_group_flush bracket the batch write; they never
# fire on the serial path.
COMMIT_POINTS = (
    "consensus.before_save_block",
    "execution.after_exec_block",
    "execution.after_save_abci_responses",
    # the two statetree points live INSIDE the app Commit call (between
    # after_save_abci_responses and after_app_commit) and only fire
    # with the state tree on (TM_CUDA_STATE_TREE): bucket-mode sweeps
    # never count them
    "statetree.before_root_flush",
    "statetree.after_node_write",
    "execution.after_app_commit",
    "execution.after_save_state",
    "consensus.before_group_flush",
    "consensus.after_group_flush",
    "consensus.before_wal_end_height",
    "consensus.after_wal_end_height",
    "consensus.after_apply_block",
)

# The recovery plane's fail points: snapshot publication, the
# state-sync restore apply, and the pruning sweep. They live OUTSIDE
# the per-commit order above — snapshots/pruning fire only on interval
# heights and restores only on a joining node — so they get their own
# catalog rather than perturbing the commit-order sweeps; crash
# specs and the snapshot recovery sweep reference them by these names.
RECOVERY_POINTS = (
    "snapshot.after_chunk",       # each chunk file written (pre-publish)
    "snapshot.before_publish",    # complete temp dir built, not renamed
    "statesync.before_apply",     # all chunks verified, stores untouched
    "statesync.after_restore",    # stores bootstrapped, dir not converted
    "prune.mid_range",            # one delete window committed, base not
    #                               yet advanced past the rest
)

# The same points in SERIAL order (pipeline "off"): save_block
# commits immediately, ENDHEIGHT is fsynced BEFORE ApplyBlock, and the
# group-flush brackets do not exist on this path.
SERIAL_COMMIT_POINTS = (
    "consensus.before_save_block",
    "consensus.before_wal_end_height",
    "consensus.after_wal_end_height",
    "execution.after_exec_block",
    "execution.after_save_abci_responses",
    "statetree.before_root_flush",
    "statetree.after_node_write",
    "execution.after_app_commit",
    "execution.after_save_state",
    "consensus.after_apply_block",
)


def reset() -> None:
    global _counter
    with _lock:
        _counter = 0


def set_callback(cb) -> None:
    """Testing: call `cb(index)` instead of killing the process."""
    global _callback
    with _lock:
        _callback = cb


def clear_callback() -> None:
    global _callback
    with _lock:
        _callback = None


def set_target(index) -> None:
    """Programmatic FAIL_TEST_INDEX (None disables). The env var, when
    set, still wins — the subprocess matrix tests keep their contract."""
    global _target
    with _lock:
        _target = None if index is None else int(index)


def arm(name: str, cb) -> None:
    """One-shot: the next fail_point(name) calls `cb(name)`."""
    with _lock:
        _armed[name] = cb


def disarm(name: str) -> None:
    with _lock:
        _armed.pop(name, None)


def disarm_all() -> None:
    with _lock:
        _armed.clear()


def fail_point(name: str = "") -> None:
    global _counter
    # fast path: nothing armed, no target anywhere — one dict truthiness
    # check + one env lookup, no lock (commit paths call this 8x/commit)
    env_target = os.environ.get("FAIL_TEST_INDEX")
    if not _armed and _target is None and env_target is None:
        return
    armed_cb = None
    if _armed and name:
        with _lock:
            armed_cb = _armed.pop(name, None)
    if armed_cb is not None:
        armed_cb(name)  # may raise: a simulated crash
        return
    with _lock:
        target = int(env_target) if env_target is not None else _target
        if target is None:
            return
        _counter += 1
        current = _counter
        cb = _callback
    if current == target:
        if cb is not None:
            cb(current)
            return
        sys.stderr.write(f"FAIL_TEST_INDEX {current} hit at "
                         f"{name or 'unnamed'} — exiting\n")
        sys.stderr.flush()
        os._exit(99)
