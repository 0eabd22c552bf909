"""Cluster trace merge — clock alignment, Perfetto export, attribution.

Input: one `telemetry.causal.dump()` dict per node (fetched over the
`dump_height_timeline` RPC route or read from files). Output:

- `estimate_offsets(dumps)` — per-node clock offset (ns, relative to a
  reference node) recovered from the paired (send, recv) wall-clock
  readings that traced p2p envelopes carry: for each directed pair the
  MINIMUM observed (recv_local - send_remote) is one-way-delay-plus-
  offset; with both directions that is the classic NTP estimate
  offset = (min_ab - min_ba) / 2, rtt_floor = min_ab + min_ba.
  Estimates propagate over the pair graph (BFS) so a node aligns even
  when it only ever talked to an intermediate.
- `to_perfetto(dumps, offsets)` — one Chrome-trace/Perfetto JSON with
  one pid per node and all timestamps on the reference clock: N
  per-node timelines become one mergeable cluster timeline.
- `attribution(dumps, offsets)` — the per-height latency table: the
  cluster-earliest aligned timestamp of each stage boundary
  (height.begin → part.first → block.full → quorum.prevote →
  quorum.precommit → apply end → persist end), consecutive deltas as
  stages, p50/p95 per stage. Because stages are consecutive boundary
  deltas, their sum equals the height's begin→persist wall-clock
  exactly (clamped negatives from residual clock noise reduce the
  reported coverage, which is why coverage is reported at all).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# stage name -> (boundary event, which end of the span marks it)
_BOUNDARIES = (
    ("first_part", "part.first", "start"),
    ("full_block", "block.full", "start"),
    ("prevote_quorum", "quorum.prevote", "start"),
    ("precommit_quorum", "quorum.precommit", "start"),
    ("apply", "apply", "end"),
    ("persist", "wal.fsync", "end"),
)


def _pctl(xs: List[float], p: float) -> float:
    s = sorted(xs)
    return s[min(len(s) - 1, int(p * len(s)))]


# ------------------------------------------------------- clock alignment

def link_samples(dumps: List[dict]) -> Dict[Tuple[str, str], List[tuple]]:
    """(origin, receiver) -> [(send_ns_on_origin, recv_ns_on_receiver)]
    from the receive-side link spans."""
    out: Dict[Tuple[str, str], List[tuple]] = {}
    for d in dumps:
        me = d.get("node", "")
        for ev in d.get("spans", ()):
            if ev.get("n") not in ("p2p.recv", "mempool.recv"):
                continue
            a = ev.get("a") or {}
            origin, sent = a.get("origin"), a.get("sent")
            if not origin or sent is None or origin == me:
                continue
            out.setdefault((origin, me), []).append((int(sent), ev["t"]))
    return out


def estimate_offsets(dumps: List[dict],
                     reference: Optional[str] = None) -> Dict[str, int]:
    """node -> clock offset in ns SUBTRACTED from that node's stamps to
    land on the reference node's clock. Nodes unreachable over the pair
    graph (never exchanged traced messages) get offset 0."""
    nodes = [d.get("node", "") for d in dumps]
    samples = link_samples(dumps)
    # directed minimum deltas
    dmin: Dict[Tuple[str, str], float] = {
        pair: min(recv - sent for sent, recv in pts)
        for pair, pts in samples.items() if pts}
    # undirected pair offsets: off[b]-off[a] estimate
    est: Dict[Tuple[str, str], float] = {}
    for (a, b), m_ab in dmin.items():
        m_ba = dmin.get((b, a))
        if m_ba is None:
            continue
        if (b, a) in est:
            continue
        est[(a, b)] = (m_ab - m_ba) / 2.0
    ref = reference if reference in nodes else (nodes[0] if nodes else "")
    offsets: Dict[str, int] = {ref: 0}
    frontier = [ref]
    while frontier:
        cur = frontier.pop()
        for (a, b), off in est.items():
            if a == cur and b not in offsets:
                offsets[b] = int(offsets[a] + off)
                frontier.append(b)
            elif b == cur and a not in offsets:
                offsets[a] = int(offsets[b] - off)
                frontier.append(a)
    for n in nodes:
        offsets.setdefault(n, 0)
    return offsets


def pair_rtt_floor_s(dumps: List[dict]) -> Dict[str, float]:
    """'a<->b' -> minimum observed round trip (s) from the link samples
    — the cross-check against the keepalive RTT histograms."""
    dmin: Dict[Tuple[str, str], float] = {}
    for pair, pts in link_samples(dumps).items():
        dmin[pair] = min(recv - sent for sent, recv in pts)
    out = {}
    for (a, b), m_ab in dmin.items():
        m_ba = dmin.get((b, a))
        if m_ba is not None and a < b:
            out[f"{a}<->{b}"] = round((m_ab + m_ba) / 1e9, 6)
    return out


# ---------------------------------------------------------------- merge

def to_perfetto(dumps: List[dict],
                offsets: Optional[Dict[str, int]] = None) -> dict:
    """One Perfetto/Chrome 'traceEvents' doc: pid = node index, spans as
    X events, points as instants, all on the reference clock, ts in us
    relative to the earliest aligned event."""
    offsets = offsets if offsets is not None else estimate_offsets(dumps)
    events = []
    aligned: List[tuple] = []
    for d in dumps:
        nid = d.get("node", "")
        off = offsets.get(nid, 0)
        for ev in d.get("spans", ()):
            aligned.append((ev["t"] - off, ev, nid))
    if not aligned:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(t for t, _, _ in aligned)
    pids = {}
    for i, d in enumerate(dumps):
        nid = d.get("node", "")
        pids[nid] = i
        events.append({"name": "process_name", "ph": "M", "pid": i,
                       "args": {"name": f"node {nid or i}"}})
    for t, ev, nid in sorted(aligned, key=lambda x: x[0]):
        args = {"height": ev["h"], "round": ev["r"], **(ev.get("a") or {})}
        base = {"name": ev["n"], "pid": pids[nid], "tid": ev["h"],
                "ts": (t - t0) / 1e3, "args": args}
        if ev.get("d"):
            events.append({**base, "ph": "X", "dur": ev["d"] / 1e3})
        else:
            events.append({**base, "ph": "i", "s": "t"})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ----------------------------------------------------------- attribution

def _boundaries_per_height(dumps: List[dict],
                           offsets: Dict[str, int]) -> Dict[int, dict]:
    """height -> {event: cluster-earliest aligned ns (span end for
    apply/wal.fsync), 'begin': earliest height.begin}."""
    per: Dict[int, dict] = {}
    for d in dumps:
        off = offsets.get(d.get("node", ""), 0)
        for ev in d.get("spans", ()):
            h = ev["h"]
            if h <= 0:
                continue
            t = ev["t"] - off
            row = per.setdefault(h, {})
            if ev["n"] == "height.begin" and ev["r"] == 0:
                row["begin"] = min(row.get("begin", t), t)
            for _, name, end in _BOUNDARIES:
                if ev["n"] == name:
                    tt = t + ev.get("d", 0) if end == "end" else t
                    row[name] = min(row.get(name, tt), tt)
    return per


def attribution(dumps: List[dict],
                offsets: Optional[Dict[str, int]] = None) -> dict:
    """The per-height stage table + p50/p95 summary. Heights missing a
    boundary (trace window truncation, empty blocks mid-catchup) are
    skipped and counted."""
    offsets = offsets if offsets is not None else estimate_offsets(dumps)
    per = _boundaries_per_height(dumps, offsets)
    rows = []
    skipped = 0
    for h in sorted(per):
        row = per[h]
        need = ["begin"] + [b[1] for b in _BOUNDARIES]
        if any(k not in row for k in need):
            skipped += 1
            continue
        cuts = [row["begin"]] + [row[b[1]] for b in _BOUNDARIES]
        wall = max(1, cuts[-1] - cuts[0])
        stages = {}
        covered = 0
        for (stage, _, _), a, b in zip(_BOUNDARIES, cuts, cuts[1:]):
            d = max(0, b - a)  # clamp residual clock noise
            stages[stage] = d
            covered += d
        rows.append({"height": h, "wall_ms": round(wall / 1e6, 3),
                     "coverage": round(covered / wall, 4),
                     **{k: round(v / 1e6, 3)
                        for k, v in stages.items()}})
    summary = {}
    if rows:
        for stage, _, _ in _BOUNDARIES:
            xs = [r[stage] for r in rows]
            summary[stage] = {"p50_ms": round(_pctl(xs, 0.50), 3),
                              "p95_ms": round(_pctl(xs, 0.95), 3)}
        walls = [r["wall_ms"] for r in rows]
        summary["height_wall"] = {"p50_ms": round(_pctl(walls, 0.50), 3),
                                  "p95_ms": round(_pctl(walls, 0.95), 3)}
    return {
        "heights": len(rows), "heights_skipped": skipped,
        "coverage_mean": round(sum(r["coverage"] for r in rows)
                               / len(rows), 4) if rows else 0.0,
        "stages_ms_p50_p95": summary,
        "per_height": rows,
    }


def merge_report(dumps: List[dict]) -> dict:
    """The whole pipeline in one call: offsets + rtt floors + perfetto
    + attribution."""
    offsets = estimate_offsets(dumps)
    return {
        "nodes": [d.get("node", "") for d in dumps],
        "clock_offsets_ms": {n: round(o / 1e6, 3)
                             for n, o in offsets.items()},
        "rtt_floor_s": pair_rtt_floor_s(dumps),
        "keepalive_rtt_s": {d.get("node", ""): d.get("rtt_s", {})
                            for d in dumps},
        "perfetto": to_perfetto(dumps, offsets),
        "attribution": attribution(dumps, offsets),
    }
