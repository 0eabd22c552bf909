"""Certifiers: the light client's ladder of trust.

Counterpart of `tendermint_tpu/lite/certifier.py`; outcomes and messages
are the JAX package's.

  StaticCertifier      one trusted validator set, one height at a time
  DynamicCertifier     follows set changes through verify_commit_any
                       (the v0.16 rule: +2/3 of the trusted set and +2/3
                       of the new set signed)
  InquiringCertifier   a DynamicCertifier with a provider, bisecting the
                       heights when a direct update is refused;
                       `certify_range` certifies a run of its provider's
                       heights across set changes, the signatures of a
                       window of headers in one verifier dispatch
  ContinuousCertifier  every height of a chain whose set churns, in
                       order: +2/3 of the signing set, and more than 1/3
                       of the trusted set's power endorsing a change
  certify_chain        a run of consecutive FullCommits under one set,
                       their signatures sent to the batch verifier a
                       window of headers at a time
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from tendermint_tpu_torch.lite.types import (
    CertificationError,
    FullCommit,
    ValidatorsChangedError,
)
from tendermint_tpu_torch.models.verifier import default_verifier
from tendermint_tpu_torch.telemetry import causal
from tendermint_tpu_torch.types.validator_set import ValidatorSet

# certify_range's counts since the process started:
#   headers         headers certified
#   transitions     set changes crossed (an update that trusted a new set)
#   windows         verifier dispatches, one a window of headers
#   sigs_dispatched signatures in those dispatches
#   sigs_sequential signatures that certify(), header by header, would
#                   have sent for the same headers (the update's and the
#                   static rule's, each in its own call)
_sync_stats = {"headers": 0, "transitions": 0, "windows": 0,
               "sigs_dispatched": 0, "sigs_sequential": 0}
_sync_stats_lock = threading.Lock()


def sync_stats() -> dict:
    """Snapshot of certify_range's counters (see _sync_stats)."""
    with _sync_stats_lock:
        return dict(_sync_stats)


def _count(**deltas) -> None:
    with _sync_stats_lock:
        for k, v in deltas.items():
            _sync_stats[k] += v


class StaticCertifier:
    """Trusts exactly one validator set forever."""

    def __init__(self, chain_id: str, validators: ValidatorSet,
                 verifier=None):
        self.chain_id = chain_id
        self.validators = validators
        self.verifier = verifier

    def certify(self, fc: FullCommit) -> None:
        fc.validate_basic(self.chain_id)
        if fc.validators.hash() != self.validators.hash():
            raise ValidatorsChangedError(
                "signed by a different validator set")
        sh = fc.signed_header
        try:
            self.validators.verify_commit(
                self.chain_id, sh.block_id, sh.height, sh.commit,
                verifier=self.verifier)
        except ValueError as e:
            raise CertificationError(str(e)) from e


class DynamicCertifier:
    """A StaticCertifier whose `update` accepts a new set when +2/3 of it
    and +2/3 of the trusted set signed."""

    def __init__(self, chain_id: str, validators: ValidatorSet,
                 height: int = 0, verifier=None):
        self.chain_id = chain_id
        self.validators = validators
        self.last_height = height
        self.verifier = verifier

    def certify(self, fc: FullCommit) -> None:
        fc.validate_basic(self.chain_id)
        if fc.validators.hash() != self.validators.hash():
            raise ValidatorsChangedError(
                "validator set changed; call update() through "
                "intermediate commits")
        StaticCertifier(self.chain_id, self.validators,
                        self.verifier).certify(fc)

    def update(self, fc: FullCommit) -> None:
        fc.validate_basic(self.chain_id)
        if fc.height <= self.last_height:
            raise CertificationError(
                f"update height {fc.height} <= trusted {self.last_height}")
        sh = fc.signed_header
        try:
            self.validators.verify_commit_any(
                fc.validators, self.chain_id, sh.block_id, sh.height,
                sh.commit, verifier=self.verifier)
        except ValueError as e:
            raise CertificationError(str(e)) from e
        self.validators = fc.validators
        self.last_height = fc.height


class InquiringCertifier:
    """A DynamicCertifier plus a provider of FullCommits; bisects the
    height range when a direct update is refused."""

    def __init__(self, chain_id: str, trusted: FullCommit, provider,
                 verifier=None):
        self.chain_id = chain_id
        self.provider = provider
        self.cert = DynamicCertifier(chain_id, trusted.validators,
                                     trusted.height, verifier=verifier)
        provider.store_commit(trusted)

    @property
    def last_height(self) -> int:
        return self.cert.last_height

    def certify(self, fc: FullCommit) -> None:
        if fc.validators.hash() != self.cert.validators.hash():
            self._update_to(fc, depth=0)
        self.cert.certify(fc)
        self.provider.store_commit(fc)

    def _update_to(self, fc: FullCommit, depth: int) -> None:
        """Trust fc through update(); when that is refused, trust the
        provider's commit at the midpoint of the gap first."""
        if depth > 64:
            raise CertificationError("bisection too deep")
        try:
            self.cert.update(fc)
            self.provider.store_commit(fc)
            return
        except CertificationError:
            pass
        lo, hi = self.cert.last_height, fc.height
        if hi - lo <= 1:
            raise CertificationError(
                f"cannot bridge trust from {lo} to {hi}")
        mid_h = (lo + hi) // 2
        mid = self.provider.get_by_height(mid_h)
        if mid is None:
            raise CertificationError(f"provider has no commit <= {mid_h}")
        if mid.height <= lo:
            raise CertificationError(
                f"cannot bridge trust: no commits in ({lo}, {mid_h}]")
        self._update_to(mid, depth + 1)
        self._update_to(fc, depth + 1)

    def certify_range(self, lo: int, hi: int) -> None:
        """Certify the provider's headers at heights lo..hi in order, as
        `certify(provider's header at h)` for each h in turn would, and
        leave the same trust and stored commits behind.

        The provider is a CacheProvider (as `cli lite` builds). The
        headers come from it a window at a time (`default_window(len(
        trusted set))`), read by `peek_by_height`, which stores nothing;
        each is judged against the set trusted after the header before
        it. Same set hash: the static rule. Changed hash: the
        v0.16 update (verify_commit_any against the trusted set), then
        the static rule under the new set. All of a window's signatures
        go to the verifier in one `verify_async`, a signature both rules
        need once; while a helper thread waits for window k's verdicts,
        the calling thread fetches and collects window k+1. A refused
        update across a gap of heights bisects through `certify`'s own
        route.

        On the first header that fails, raises what `certify` raises for
        it, after every earlier header's verdicts were checked, and
        certifies nothing after it; a header the provider lacks raises
        CertificationError. A verifier that fails raises its own error
        when its window is dispatched or waited on."""
        cert = self.cert
        verifier = cert.verifier or default_verifier()
        window = default_window(len(cert.validators))
        read = self.provider.peek_by_height
        # the trust every header up to the last collected one leaves,
        # if each passes: it follows from the set hashes alone
        trust = [cert.validators, cert.last_height]
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="tm-lite-resolve")
        try:
            pending = None
            h = lo
            while h <= hi:
                n = min(window, hi - h + 1)
                with causal.span("lite.fetch", h) as sp:
                    fetched = _fetch(read, h, n)
                    sp.note(n=len(fetched))
                with causal.span("lite.collect", h, n=len(fetched)):
                    plans, items = self._collect(fetched, trust)
                fut = pool.submit(verifier.verify_async(items)) \
                    if items else None
                _count(windows=1 if items else 0,
                       sigs_dispatched=len(items),
                       sigs_sequential=sum(p.sequential for p in plans))
                if pending is not None:
                    self._check(*pending)
                pending = (h, plans, fut)
                if plans[-1].final:
                    break
                h += n
            if pending is not None:
                self._check(*pending)
        finally:
            pool.shutdown(wait=False)

    def _collect(self, fetched, trust) -> tuple:
        """Each fetched header's plan, and the window's verify items;
        `trust` moves to what the last planned header leaves if it
        passes. Faults are held in the plans, to be raised in turn."""
        chain_id = self.chain_id
        plans = []
        items: list = []
        for h, fc in fetched:
            p = _Plan(h, fc)
            plans.append(p)
            if isinstance(fc, Exception):
                p.fail(fc)
                break
            if fc is None or fc.height != h:
                p.fail(CertificationError(
                    f"provider has no commit at height {h}"))
                break
            trusted, last = trust
            sh = fc.signed_header
            try:
                p.changed = fc.validators.hash() != trusted.hash()
                if p.changed:
                    try:
                        fc.validate_basic(chain_id)
                        if h <= last:
                            raise CertificationError("past height")
                        p.any_items, p.any_powers = \
                            trusted.commit_any_items(
                                fc.validators, chain_id, sh.block_id,
                                sh.height, sh.commit)
                    except (CertificationError, ValueError):
                        # refused whatever the verdicts: certify's route
                        # raises, after a bisection across a gap
                        p.refused = p.final = True
                        break
                    trusted, last = fc.validators, h
                    try:
                        static_items, p.item_power = \
                            trusted.commit_verification_items(
                                chain_id, sh.block_id, sh.height, sh.commit)
                    except ValueError as e:
                        # raised after the update, which moves trust
                        p.static_error = CertificationError(str(e))
                        p.final = True
                        static_items = []
                else:
                    fc.validate_basic(chain_id)
                    static_items, p.item_power = \
                        trusted.commit_verification_items(
                            chain_id, sh.block_id, sh.height, sh.commit)
            except CertificationError as e:
                p.fail(e)
                break
            except ValueError as e:
                p.fail(CertificationError(str(e)))
                break
            except Exception as e:
                p.fail(e)
                break
            trust[0], trust[1] = trusted, last
            lane = {}
            p.lanes = []
            for it in static_items:
                lane[it] = len(items)
                p.lanes.append(len(items))
                items.append(it)
            p.sequential = len(static_items) + len(p.any_items)
            for it in p.any_items:
                k = lane.get(it)
                if k is None:
                    k = len(items)
                    items.append(it)
                p.any_lanes.append(k)
            if p.final:
                break
        return plans, items

    def _check(self, h0: int, plans: list, fut) -> None:
        """The window's plans in height order against its verdicts,
        moving trust and storing commits as certify would."""
        ok = None
        if fut is not None:
            with causal.span("lite.wait", h0, n=len(plans)):
                ok = fut.result()
        cert = self.cert
        certified = crossed = 0
        try:
            with causal.span("lite.check", h0, n=len(plans)):
                for p in plans:
                    if p.error is not None:
                        raise p.error
                    fc = p.fc
                    if p.changed:
                        refused = p.refused
                        if not refused:
                            try:
                                cert.validators.check_commit_any_results(
                                    fc.validators,
                                    [ok[k] for k in p.any_lanes],
                                    p.any_powers)
                            except ValueError:
                                refused = True
                        if refused:
                            # certify's own route: "cannot bridge trust"
                            # across one height, a bisection across more
                            self._update_to(fc, depth=0)
                        else:
                            cert.validators = fc.validators
                            cert.last_height = fc.height
                            self.provider.store_commit(fc)
                        crossed += 1
                        if p.static_error is not None:
                            raise p.static_error
                    try:
                        cert.validators.check_commit_results(
                            [ok[k] for k in p.lanes], p.item_power)
                    except ValueError as e:
                        raise CertificationError(str(e)) from e
                    self.provider.store_commit(fc)
                    certified += 1
        finally:
            _count(headers=certified, transitions=crossed)


class _Plan:
    """What certify_range's collect found for one header: its verify
    lanes and powers for each rule, or the fault to raise at its turn."""

    __slots__ = ("height", "fc", "error", "static_error", "final",
                 "changed", "refused", "any_items", "any_powers",
                 "any_lanes", "lanes", "item_power", "sequential")

    def __init__(self, height: int, fc):
        self.height, self.fc = height, fc
        self.error = self.static_error = None
        self.final = False       # nothing after this header is collected
        self.changed = self.refused = False
        self.any_items, self.any_powers, self.any_lanes = [], [], []
        self.lanes, self.item_power = [], []
        self.sequential = 0

    def fail(self, error: Exception) -> None:
        self.error, self.final = error, True


def _fetch(read, lo: int, n: int) -> list:
    """(height, FullCommit or None or the exception its read raised) for
    lo .. lo + n - 1, up to the first header missing or unreadable."""
    out = []
    for h in range(lo, lo + n):
        try:
            fc = read(h)
        except Exception as e:           # raised at its turn
            out.append((h, e))
            break
        out.append((h, fc))
        if fc is None or fc.height != h:
            break
    return out


def _trusted_set_endorsement(trusted: ValidatorSet, chain_id: str,
                             block_id, height: int, commit,
                             verifier=None) -> None:
    """Among the commit's votes for block_id, those of validators the
    trusted set knows must verify and carry strictly more than 1/3 of
    the trusted set's power: with fewer than 1/3 byzantine, at least one
    honest trusted validator vouches for the new set. Raises
    ValueError."""
    verifier = verifier or default_verifier()
    items = []
    powers = []
    seen = set()
    for pc in commit.precommits:
        if pc is None or pc.block_id != block_id:
            continue
        oi, ov = trusted.get_by_address(pc.validator_address)
        if ov is None or oi in seen:
            continue
        seen.add(oi)
        items.append((ov.pubkey, pc.sign_bytes(chain_id), pc.signature))
        powers.append(ov.voting_power)
    old_power = 0
    for valid, power in zip(verifier.verify(items), powers):
        if not valid:
            raise ValueError("invalid signature in commit")
        old_power += power
    total = trusted.total_voting_power()
    if not old_power * 3 > total:
        raise ValueError(
            f"insufficient trusted-set endorsement: got {old_power}, "
            f"need > {total / 3:g} (1/3 of trusted power)")


class ContinuousCertifier:
    """Certifies every height of a chain whose set churns, in order.

    Same set hash as trusted: a static certify. Changed hash: +2/3 of
    the new (signing) set, and the trusted set's endorsement. A height
    other than the next one raises; `trusted` is the set expected to
    sign `next_height`."""

    def __init__(self, chain_id: str, trusted: ValidatorSet,
                 next_height: int = 1, verifier=None):
        self.chain_id = chain_id
        self.verifier = verifier
        self.validators = trusted
        self.next_height = next_height
        self.static_certified = 0
        self.updates = 0          # heights crossed through a set change
        # app hashes of recently certified headers by height, the anchor
        # of state proofs; only the frontier's neighbourhood is kept
        self.app_hashes: dict = {}

    @property
    def certified_height(self) -> int:
        return self.next_height - 1

    def advance(self, fc: FullCommit) -> None:
        """Certify fc, which must be the next height, and advance trust;
        trust does not advance past a height that fails."""
        if fc.height != self.next_height:
            raise CertificationError(
                f"continuous certify expects height {self.next_height}, "
                f"got {fc.height}")
        if fc.validators.hash() == self.validators.hash():
            StaticCertifier(self.chain_id, self.validators,
                            self.verifier).certify(fc)
            self.static_certified += 1
        else:
            StaticCertifier(self.chain_id, fc.validators,
                            self.verifier).certify(fc)
            sh = fc.signed_header
            try:
                _trusted_set_endorsement(self.validators, self.chain_id,
                                         sh.block_id, sh.height, sh.commit,
                                         verifier=self.verifier)
            except ValueError as e:
                raise CertificationError(
                    f"valset transition at height {fc.height}: "
                    f"{e}") from e
            self.validators = fc.validators
            self.updates += 1
        self.app_hashes[fc.height] = fc.signed_header.header.app_hash
        while len(self.app_hashes) > 16:
            self.app_hashes.pop(next(iter(self.app_hashes)))
        self.next_height += 1


def default_window(n_vals: int) -> int:
    """Headers per verifier dispatch: about 32k signatures in flight."""
    return max(64, 32768 // max(1, n_vals))


def certify_chain(chain_id: str, fcs: List[FullCommit],
                  trusted: Optional[ValidatorSet] = None,
                  verifier=None, window: Optional[int] = None) -> None:
    """Certify consecutive FullCommits signed by one set.

    Structural checks and set continuity run on the host per header; the
    signatures of `window` headers go to the verifier in one dispatch.
    While one helper thread waits for window k's verdicts (on the card,
    a CUDA event, which releases the GIL), the calling thread collects
    window k+1. `trusted` is the set that must have signed fcs[0]
    (default: fcs[0].validators). Raises CertificationError, or
    ValidatorsChangedError at a change of set, on the first bad header."""
    verifier = verifier or default_verifier()
    if not fcs:
        return
    expect_vals = trusted or fcs[0].validators
    if window is None:
        window = default_window(len(expect_vals))

    def collect(window_fcs):
        items_w = []
        spans = []  # (item_power, lo, n, height)
        for fc in window_fcs:
            fc.validate_basic(chain_id)
            if fc.validators.hash() != expect_vals.hash():
                raise ValidatorsChangedError(
                    f"valset discontinuity at height {fc.height}")
            sh = fc.signed_header
            try:
                items, item_power = expect_vals.commit_verification_items(
                    chain_id, sh.block_id, sh.height, sh.commit)
            except ValueError as e:
                raise CertificationError(
                    f"height {fc.height}: {e}") from e
            spans.append((item_power, len(items_w), len(items), fc.height))
            items_w.extend(items)
        return items_w, spans

    def check(spans, ok):
        for item_power, lo, n, height in spans:
            try:
                expect_vals.check_commit_results(ok[lo:lo + n], item_power)
            except ValueError as e:
                raise CertificationError(f"height {height}: {e}") from e

    pool = ThreadPoolExecutor(max_workers=1,
                              thread_name_prefix="tm-lite-resolve")
    try:
        pending = None  # (spans, future)
        for lo in range(0, len(fcs), window):
            items_w, spans = collect(fcs[lo:lo + window])
            fut = pool.submit(verifier.verify_async(items_w))
            if pending is not None:
                check(pending[0], pending[1].result())
            pending = (spans, fut)
        if pending is not None:
            check(pending[0], pending[1].result())
    finally:
        pool.shutdown(wait=False)
