"""Validator nets of OS processes (procnet.ProcNet) on the CPU: every node
its own interpreter, started as users start it,
`python -m <cli> --home nodeI node --p2p --rpc-laddr ...`, from a
`cli testnet` tree, fed and read over JSON-RPC and WebSocket.

- Four port node processes (`--device cpu`) from a port-written tree,
  on config 1's socket timeouts and the JAX node's default plane (the
  event loop, a coalescing verifier, the async RPC front door), take
  txs through WebSocket
  broadcast_tx_batch, reach height >= 3 and agree on every block hash
  and app hash; every fed tx is committed once, and each node answers
  abci_query for a seeded sample of keys. Node 3 is then SIGKILLed and
  restarted with fast sync; it catches up, and its killed process's
  counts are read from the line of the last height it committed. Every
  process reports one tm-reactor-loop thread, no per-peer thread and
  coalesced verify calls, and the JAX node's default commit path: the
  pipeline on, one group flush a height it committed in consensus, no
  failed precompute, part sets built natively, every block with txs
  delivered by the kv core and the canonical JSON on the native codec.
- A mixed net of two JAX processes (JAX_PLATFORMS=cpu, verifier_backend
  "python", the JAX node's defaults otherwise) and two port processes,
  both packages on the loop plane, from one JAX-written tree agrees on
  every block hash and app hash, and
  commits every fed tx and nothing else; the port processes run the
  default commit path as above. Not each tx once: a JAX node
  admits a committed tx it never held when late gossip brings it, and
  proposes it again (ROADMAP Queue 3); the port's nodes commit that
  block, as the agreement requires.
Each node's stop line reports its launches (none on the CPU).
"""

import random
import shutil

from tendermint_tpu_torch.procnet import ProcNet, bench_settings, free_block

BOOT_S = 90.0


def _feed_and_check(net, n_txs: int, top_at_least: int, once: bool):
    txs = [b"pn/k%d=v%d" % (i, i * 7) for i in range(n_txs)]
    ws = net.ws(0)
    try:
        for lo in range(0, n_txs, 64):
            res = ws.call("broadcast_tx_batch",
                          txs=[t.hex() for t in txs[lo:lo + 64]])
            assert all(r["code"] == 0 for r in res["results"]), res
    finally:
        ws.close()
    net.wait_for(lambda: all(net.rpc(i).call("num_unconfirmed_txs")
                             ["n_txs"] == 0 for i in range(net.n)),
                 BOOT_S, "the mempools' drain")
    net.wait_height(top_at_least, BOOT_S)
    top = min(net.heights())
    assert net.disagreements(top) == []
    committed = [tx for b in net.block_txs(0, top) for tx in b]
    if once:
        assert sorted(committed) == sorted(txs)
    else:
        assert set(committed) == set(txs)
    for tx in random.Random(3).sample(txs, 5):
        k, v = tx.split(b"=")
        for i in range(net.n):
            res = net.rpc(i).call("abci_query", data=k.hex())["response"]
            assert bytes.fromhex(res["value"]) == v, (i, tx)
    return top


def test_four_port_processes_commit_fed_txs_and_agree(tmp_path):
    net = ProcNet(str(tmp_path), base_port=free_block(8))
    net.write_tree("procnet-port")
    net.configure(bench_settings("auto"))
    net.start_all(extra=["--no-fast-sync", "--device", "cpu"])
    try:
        net.wait_height(3, BOOT_S)
        top = _feed_and_check(net, 300, 4, once=True)
        net.kill(3)
        net.start(3, extra=["--device", "cpu"])
        net.wait_for(lambda: net.height(3) > top and not net.rpc(3).call(
            "status")["syncing"], BOOT_S, "node 3's catch-up")
        # fast sync can carry node 3 past `top` on its own: wait for one
        # height it commits in consensus after the switch, whose group
        # flush _assert_commit_path reads
        switched = max(top + 1, net.height(3))
        net.wait_for(lambda: net.height(3) > switched, BOOT_S,
                     "node 3's first height in consensus")
        assert net.early_exits() == {}
    finally:
        codes = net.stop_all()
    assert codes == {i: 0 for i in range(4)}
    lines = {i: net.kernel_lines(i) for i in range(4)}
    assert [len(lines[i]) for i in range(4)] == [1, 1, 1, 2]
    assert lines[3][0]["height"] >= top - 1
    assert lines[3][1]["height"] >= top + 1
    for line in sum(lines.values(), []):
        assert line["device"] == "cpu" and line["verifier"]["calls"] > 0
        assert sum(line["launches"].values()) == 0
        _assert_loop_plane(line)
        _assert_commit_path(line)
    for i in range(3):   # never restarted: every height by consensus
        assert lines[i][0]["pipeline"]["group_flushes"] == \
            lines[i][0]["height"]
    shutil.rmtree(tmp_path, ignore_errors=True)


def _assert_loop_plane(line):
    """A port process's `node kernels` line on the JAX default plane."""
    th = line["threads"]
    assert line["reactor"] == "loop" and th["tm-reactor-loop"] == 1, th
    assert th["mconn-"] == th["gossip-"] == th["mempool-bcast-"] == 0, th
    v, c = line["verifier"], line["coalescer"]
    assert v["coalesced_calls"] > 0 and c["submissions"] > 0
    assert v["calls"] == v["direct_calls"] + v["coalesced_dispatches"]
    # the line reads the verifier's stats before the coalescer's, which
    # counts each dispatch before running it
    assert 0 < v["coalesced_dispatches"] <= c["dispatches"] + \
        c["isolated_calls"]
    assert line["loop"]["ticks"] > 0


def _assert_commit_path(line):
    """A port process's `node kernels` line on the JAX node's default
    commit path."""
    p, nat = line["pipeline"], line["native"]
    assert p["mode"] == "on" and p["group_flushes"] > 0, p
    assert p["precompute"]["failed"] == 0, p
    assert nat["partsets"]["python"] == 0, nat
    kv = nat["kvstore"]
    assert kv["native"] > 0 and kv["per_tx"] == kv["pure"] == 0, nat
    assert nat["codec"]["native"] > 0, nat


def test_mixed_jax_and_port_processes_agree_on_every_block(tmp_path):
    jax_nodes = (0, 2)
    net = ProcNet(
        str(tmp_path), base_port=free_block(8),
        cli_of=lambda i: ("tendermint_tpu.cli" if i in jax_nodes
                          else "tendermint_tpu_torch.cli"),
        env_of=lambda i: ({"JAX_PLATFORMS": "cpu"} if i in jax_nodes
                          else None))
    net.write_tree("procnet-mixed", cli="tendermint_tpu.cli")
    net.configure(bench_settings("python"), nodes=jax_nodes)
    net.configure(bench_settings("auto"), nodes=(1, 3))
    for i in range(4):
        net.start(i, extra=["--no-fast-sync"] + (
            [] if i in jax_nodes else ["--device", "cpu"]))
    try:
        net.wait_height(3, BOOT_S)
        top = _feed_and_check(net, 200, 5, once=False)
        metas = net.metas(1, top)
        assert len({m["header"]["app_hash"] for m in metas}) > 1
        assert net.early_exits() == {}
    finally:
        codes = net.stop_all()
    assert codes == {i: 0 for i in range(4)}
    assert [len(net.kernel_lines(i)) for i in range(4)] == [0, 1, 0, 1]
    for i in (1, 3):
        _assert_loop_plane(net.kernel_lines(i)[0])
        _assert_commit_path(net.kernel_lines(i)[0])
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_a_node_that_aborts_leaves_its_log_tail(tmp_path, capsys):
    """A node process that dies of SIGABRT unasked: the wait that finds
    it dead prints the last 40 lines of its log, once, before raising;
    stop_all does not print it again."""
    import subprocess
    import sys

    import pytest
    net = ProcNet(str(tmp_path), base_port=free_block(8))
    log = open(net.log_path(0), "ab")
    log.write(b"an earlier process's line\n")
    log.flush()
    net._logs[0] = log
    net._starts[0] = [log.tell()]
    net.procs[0] = subprocess.Popen(
        [sys.executable, "-c", "import os\nfor i in range(60):\n"
         "    print('line', i, flush=True)\nos.abort()"],
        stdout=log, stderr=subprocess.STDOUT)
    net.procs[0].wait(60)
    with pytest.raises(RuntimeError, match="exited"):
        net.wait_for(lambda: False, 30, "boot")
    out = capsys.readouterr().out
    pid = net.procs[0].pid
    assert f"procnet node 0 (pid {pid}) exited -6" in out
    lines = out.splitlines()
    assert lines[-40:] == [f"line {i}" for i in range(20, 60)]
    assert "earlier process" not in out
    assert net.stop_all() == {0: -6}
    assert capsys.readouterr().out == ""
