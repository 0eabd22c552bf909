"""Byzantine validator behaviors, injected at the reactor boundary: the
port's copy of `tendermint_tpu/chaos/byzantine.py`.

The runner intercepts every broadcast leaving a byzantine node (the
same boundary the consensus reactor taps) and rewrites it through a
ByzantineAgent. The honest engine underneath is UNMODIFIED — the agent
only forges/mutates/witholds wire messages, signing forged votes with a
twin of the validator's key that bypasses PrivValidator's double-sign
protection (the file-backed last-sign state belongs to the honest
signer; a real attacker's twin would keep none).

Behaviors (schedule spec `byzantine[].behavior`):

  equivocate          every non-nil vote is shadowed by a conflicting
                      vote for a fabricated block at the same (H, R,
                      type). Honest nodes must raise
                      ConflictingVoteError, file DuplicateVoteEvidence,
                      and commit it in a later block — the monitor
                      tracks each injected double-sign until it shows
                      up as committed evidence.
  amnesia             the node "forgets" its locks between rounds
                      (applied by the runner via forget_locks) — the
                      classic lock-violation probe; with <1/3 power it
                      must not break agreement.
  withhold_proposal   proposals and their block parts are swallowed
                      when this node is the proposer; honest nodes must
                      prevote nil on timeout and move to the next round.
  invalid_proposal    the outgoing proposal's signature is corrupted;
                      honest nodes must reject it and recover by round
                      advance.
"""

from __future__ import annotations

from typing import List

from tendermint_tpu_torch.types.vote import Vote

BEHAVIORS = ("equivocate", "amnesia", "withhold_proposal",
             "invalid_proposal")


def double_sign_key(vote) -> tuple:
    """Identity of one equivocation: the (validator, H, R, type) cell a
    DuplicateVoteEvidence commits to."""
    return (vote.validator_address.hex(), vote.height, vote.round,
            int(vote.type))


class ByzantineAgent:
    def __init__(self, node_id: int, privkey, chain_id: str, schedule,
                 monitor=None):
        self.node_id = node_id
        self.privkey = privkey       # the twin: raw key, no sign state
        self.chain_id = chain_id
        self.schedule = schedule
        self.monitor = monitor

    # ------------------------------------------------------------ transform

    def transform(self, step: int, behavior: str,
                  msg: dict) -> List[dict]:
        """Rewrite one outgoing broadcast into the messages that
        actually hit the network (possibly none, possibly extra)."""
        if behavior == "equivocate":
            return self._equivocate(step, msg)
        if behavior == "withhold_proposal":
            return self._withhold(step, msg)
        if behavior == "invalid_proposal":
            return self._invalidate(step, msg)
        # amnesia mutates node state (forget_locks), not messages
        return [msg]

    def _equivocate(self, step: int, msg: dict) -> List[dict]:
        if msg.get("type") != "vote":
            return [msg]
        v = Vote.from_obj(msg["vote"])
        if v.block_id.is_zero():
            return [msg]  # nil votes: nothing to conflict with
        evil = Vote(v.validator_address, v.validator_index, v.height,
                    v.round, v.timestamp_ns + 1, v.type,
                    type(v.block_id)(b"\xee" * 32, v.block_id.parts))
        evil.signature = self.privkey.sign(evil.sign_bytes(self.chain_id))
        self.schedule.record("equivocation", step, node=self.node_id,
                             height=v.height, round=v.round,
                             vote_type=int(v.type))
        if self.monitor is not None:
            self.monitor.expect_double_sign(double_sign_key(v))
        # real vote first: honest vote sets then hold the true vote and
        # reject the forged twin as the conflict (the reference's
        # byzantine tests drive the same ordering)
        return [msg, {"type": "vote", "vote": evil.to_obj()}]

    def _withhold(self, step: int, msg: dict) -> List[dict]:
        if msg.get("type") == "proposal":
            self.schedule.record(
                "withheld_proposal", step, node=self.node_id,
                height=msg["proposal"].get("height"))
            return []
        if msg.get("type") == "block_part":
            return []  # parts of the withheld proposal (not re-logged)
        return [msg]

    def _invalidate(self, step: int, msg: dict) -> List[dict]:
        if msg.get("type") != "proposal":
            return [msg]
        bad = dict(msg)
        prop = dict(msg["proposal"])
        sig = bytearray(bytes.fromhex(prop["signature"]))
        sig[0] ^= 0x01
        prop["signature"] = bytes(sig).hex()
        bad["proposal"] = prop
        self.schedule.record("invalid_proposal", step, node=self.node_id,
                             height=prop.get("height"))
        return [bad]


def forget_locks(cs, schedule, step: int, node_id: int) -> None:
    """Amnesia: wipe the consensus state's lock so the next round votes
    afresh (the runner calls this each step inside the behavior
    window). Recorded only when there was a lock to forget."""
    rs = cs.rs
    if rs.locked_block is None:
        return
    rs.locked_round = 0
    rs.locked_block = None
    rs.locked_block_parts = None
    schedule.record("amnesia", step, node=node_id, height=rs.height,
                    round=rs.round)
