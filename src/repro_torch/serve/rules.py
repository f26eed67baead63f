"""Online minority-rule serving — the MRA rule surface over the count path.

The paper's headline application (Algorithm 4.1, the Minority-Report
Algorithm) turns exact per-class counts into minority-class rules

    antecedent -> target_class,   confidence = C1 / (C1 + C0)

where ``C1`` is the antecedent's count within the target (rare) class and
``C0`` its count everywhere else.  The serving store already holds exactly
that: every count row is a (C,) per-class block, so a rule is one cached
count lookup plus two integer reads — no tree mining on the serving path.

:class:`RuleServer` layers the rule surface on a :class:`CountServer`:

  * ``rules_for(antecedents, ...)`` — batch rule lookups.  Antecedents ride
    the existing ``MicroBatcher``/``CountCache`` machinery (canonicalized,
    cross-deduped, one block_k-padded composed counting pass for the
    uncached rest), then confidence/support are derived from the (K, C)
    rows.  Bit-exact against the host ``minority_report`` on the same
    history: same integers, same float divisions.
  * ``top_rules(theta, min_conf, optimal=...)`` — the full §5.1 workload:
    a CLASS-GUIDED resumable mine (``CountServer.mine(theta,
    class_column=target)``, the same checkpointed driver bootstrap) finds
    every antecedent with C1 >= ceil_count(theta * n_rows), the batch path
    above prices them, and ``optimal_rule_set`` (Li, Shen & Topor 2002)
    drops confidence-dominated supersets on demand.
  * :class:`RuleCache` — LRU keyed on ``(antecedent, target_class,
    min_conf)`` x STORE VERSION: an append invalidates every cached rule by
    construction, exactly like ``CountCache`` (a stale rule hit is
    impossible, no coordination needed).
  * version prefetch — ``append()`` commits the batch through the count
    server, purges stale rule entries, and RE-WARMS the hottest rule keys
    at the new version before traffic hits it (the ROADMAP's
    version-prefetch cache item, scoped to rules).

Everything here works unchanged over a ``VersionedDB`` or a ``ShardedDB``
(host all-reduce loop or the ``torch.distributed`` mesh path): the only
store contract used is ``version`` / ``n_rows`` / ``n_classes`` plus the
count path itself.  The counts are counted on the server's device (the
card unless the server was built with ``device="cpu"``), but the rule math
is host work on Python ints from the (K, C) int32 rows that
``CountServer.query`` copies back, so a served :class:`Rule` equals the
JAX package's field for field.
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from ..core.mra import Rule
from ..core.optimal_rules import optimal_rule_set
from .batcher import canonical_itemset
from .cache import BudgetedLRU
from .service import CountServer, MiningRefreshError

Item = Hashable
Key = Tuple[Item, ...]
# (antecedent, target_class, min_conf): the version-independent identity of
# a rule query — the cache key half, and the heat-tracking key
RuleKey = Tuple[Key, int, float]


class RuleCache(BudgetedLRU):
    """Bounded LRU: (rule key, version) -> Optional[Rule].

    ``None`` is a first-class cached verdict ("below min_conf at this
    version"): recomputing it would cost the same counting pass as a kept
    rule.  The version in the key makes every ``append`` invalidate by
    construction; ``purge_stale`` reclaims the bytes eagerly.

    The shared :class:`~repro_torch.serve.cache.BudgetedLRU` ledger prices
    entries with :meth:`entry_nbytes` — a fixed deterministic host-side
    estimate (rules are tiny python objects, not device rows) — so
    ``stats()['bytes']`` always equals the sum over resident entries.
    """

    @staticmethod
    def entry_nbytes(rule: Optional[Rule]) -> int:
        """Deterministic priced size of one cached verdict."""
        if rule is None:
            return 16
        return 96 + 16 * len(rule.antecedent)

    def _price(self, value: Optional[Rule]) -> int:
        return self.entry_nbytes(value)

    def get(self, key: RuleKey, version: int) -> Tuple[bool, Optional[Rule]]:
        """Returns ``(hit, rule_or_None)`` — the verdict itself may be None,
        so presence and payload are reported separately."""
        return self._lookup((key, version))

    def put(self, key: RuleKey, version: int, rule: Optional[Rule]) -> None:
        self._store((key, version), rule)


class RuleServer:
    """Minority-rule serving over a :class:`CountServer`.

    ``target_class`` is the default rare class (the paper's class '1');
    per-call overrides are allowed.  ``prefetch_top`` bounds how many of the
    hottest rule keys ``append()`` re-warms at the new version.
    """

    def __init__(
        self,
        server: CountServer,
        *,
        target_class: int = 1,
        cache: bool = True,
        cache_size: int = 65536,
        cache_bytes: Optional[int] = None,
        prefetch_top: int = 8,
        heat_capacity: int = 4096,
    ):
        if not (0 <= target_class < server.store.n_classes):
            raise ValueError(
                f"target_class {target_class} out of range for "
                f"n_classes={server.store.n_classes}")
        if prefetch_top < 0:
            raise ValueError("prefetch_top must be >= 0")
        if heat_capacity <= 0:
            raise ValueError("heat_capacity must be positive")
        self.server = server
        self.target_class = target_class
        self.cache: Optional[RuleCache] = \
            RuleCache(cache_size, max_bytes=cache_bytes) if cache else None
        self.prefetch_top = prefetch_top
        self.heat_capacity = heat_capacity
        self._heat: Dict[RuleKey, int] = {}
        self.n_rule_queries = 0
        self.n_prefetches = 0
        self.n_prefetched_keys = 0

    # -- rule math ------------------------------------------------------------
    def _make_rule(self, key: Key, row, target_class: int,
                   min_conf: float, n_db: int) -> Optional[Rule]:
        # same integers, same float divisions as core.mra.minority_report:
        # served Rule objects compare EQUAL to the host oracle's
        cnt = int(row[target_class])
        gcnt = int(row.sum()) - cnt
        conf = cnt / (cnt + gcnt) if (cnt + gcnt) else 0.0
        if conf < min_conf:
            return None
        return Rule(antecedent=key, consequent=target_class,
                    support=cnt / n_db, confidence=conf,
                    count=cnt, g_count=gcnt)

    def _check_args(self, target_class: Optional[int],
                    min_conf: float) -> int:
        tc = self.target_class if target_class is None else target_class
        if not (0 <= tc < self.server.store.n_classes):
            raise ValueError(
                f"target_class {tc} out of range for "
                f"n_classes={self.server.store.n_classes}")
        if not (0.0 <= min_conf <= 1.0):
            raise ValueError("min_conf must be in [0, 1]")
        return tc

    def _resolve(self, keys: List[Key], target_class: int, min_conf: float,
                 *, touch_heat: bool = True) -> Dict[Key, Optional[Rule]]:
        """{canonical antecedent -> Optional[Rule]} at the current version:
        rule-cache hits first, ONE batched count resolve for the rest."""
        store = self.server.store
        version, n_db = store.version, store.n_rows
        resolved: Dict[Key, Optional[Rule]] = {}
        missing: List[Key] = []
        for key in dict.fromkeys(keys):
            rk: RuleKey = (key, target_class, min_conf)
            if self.cache is not None:
                hit, rule = self.cache.get(rk, version)
                if hit:
                    resolved[key] = rule
                    continue
            missing.append(key)
        if missing:
            # the count path does the heavy lifting: canonical keys, count
            # cache, one composed block_k-padded pass for the uncached rest
            rows = self.server.query(missing, client_id="_rules")
            for key, row in zip(missing, rows):
                rule = self._make_rule(key, row, target_class, min_conf, n_db)
                resolved[key] = rule
                if self.cache is not None:
                    self.cache.put((key, target_class, min_conf), version,
                                   rule)
        if touch_heat:
            for key in keys:
                rk = (key, target_class, min_conf)
                self._heat[rk] = self._heat.get(rk, 0) + 1
            if len(self._heat) > self.heat_capacity:
                self._trim_heat()
        return resolved

    def _trim_heat(self) -> None:
        # keep the hottest half (deterministic tie-break) so the tracker
        # cannot grow without bound under adversarial key churn
        keep = sorted(self._heat.items(),
                      key=lambda kv: (-kv[1], repr(kv[0])))
        self._heat = dict(keep[:self.heat_capacity // 2])

    # -- serving surface ------------------------------------------------------
    def rules_for(
        self,
        antecedents: Sequence[Sequence[Item]],
        *,
        target_class: Optional[int] = None,
        min_conf: float = 0.0,
    ) -> List[Optional[Rule]]:
        """One rule verdict per antecedent, aligned with the input order:
        the :class:`~repro_torch.core.mra.Rule` when confidence >=
        ``min_conf`` at the current version, else ``None``.  Antecedents are
        canonicalized (sorted, deduped) exactly like count queries; an empty
        antecedent is the class prior.  Counts come through the count-serving path, so
        every verdict is exact at the store's current version."""
        tc = self._check_args(target_class, min_conf)
        with self.server._lock:
            keys = [canonical_itemset(a) for a in antecedents]
            resolved = self._resolve(keys, tc, min_conf)
            self.n_rule_queries += len(keys)
            return [resolved[k] for k in keys]

    def top_rules(
        self,
        theta: float,
        min_conf: float = 0.0,
        *,
        target_class: Optional[int] = None,
        optimal: bool = False,
        checkpoint=None,
    ) -> List[Rule]:
        """The complete minority rule set at relative support ``theta``:
        every antecedent with C1 >= ceil_count(theta * n_rows) whose
        confidence clears ``min_conf`` — exactly the host
        ``minority_report(..., min_support=theta, min_confidence=min_conf)``
        rule list (same sort: confidence desc, support desc, antecedent).

        The antecedent discovery is ``CountServer.mine``'s resumable
        class-guided bootstrap: with a ``checkpoint`` a killed ``top_rules``
        resumes the mine mid-level, version-pinned like any other serving
        mine.  ``optimal=True`` filters the result through
        ``optimal_rule_set`` (drop a rule when a proper-subset antecedent
        already achieves its confidence)."""
        tc = self._check_args(target_class, min_conf)
        with self.server._lock:
            frequent = self.server.mine(theta, class_column=tc,
                                        checkpoint=checkpoint)
            antecedents = list(frequent)
            resolved = self._resolve(antecedents, tc, min_conf,
                                     touch_heat=False)
            self.n_rule_queries += len(antecedents)
            rules = [resolved[k] for k in antecedents
                     if resolved[k] is not None]
            rules.sort(key=lambda r: (-r.confidence, -r.support,
                                      r.antecedent))
            return optimal_rule_set(rules) if optimal else rules

    # -- growth path ----------------------------------------------------------
    def append(self, transactions: Sequence[Sequence[Item]],
               classes: Optional[Sequence[int]] = None) -> int:
        """Fold a batch through the count server, purge superseded rule
        verdicts, and re-warm the ``prefetch_top`` hottest rule keys at the
        NEW version — so post-append traffic on the hot keys never pays the
        cold counting pass.  A ``MiningRefreshError`` (batch committed,
        frequent-set refresh failed) still purges and prefetches before
        propagating: the rule path must not serve stale verdicts either way.
        """
        with self.server._lock:
            try:
                version = self.server.append(transactions, classes=classes)
            except MiningRefreshError as e:
                self._after_append(e.version)
                raise
            self._after_append(version)
            return version

    def _after_append(self, version: int) -> None:
        if self.cache is not None:
            self.cache.purge_stale(version)
        if self.prefetch_top <= 0 or not self._heat:
            return
        hottest = sorted(self._heat.items(),
                         key=lambda kv: (-kv[1], repr(kv[0])))
        grouped: Dict[Tuple[int, float], List[Key]] = {}
        for (key, tc, mc), _ in hottest[:self.prefetch_top]:
            grouped.setdefault((tc, mc), []).append(key)
        for (tc, mc), group in grouped.items():
            # current-version verdicts only — _resolve reads store.version
            # inside the lock, so nothing older can be warmed
            self._resolve(group, tc, mc, touch_heat=False)
        self.n_prefetches += 1
        self.n_prefetched_keys += min(self.prefetch_top, len(hottest))

    # -- introspection --------------------------------------------------------
    def stats(self) -> dict:
        with self.server._lock:
            return {
                "rule_cache": (self.cache.stats() if self.cache is not None
                               else None),
                "rule_queries": self.n_rule_queries,
                "target_class": self.target_class,
                "heat_tracked": len(self._heat),
                "prefetch_top": self.prefetch_top,
                "prefetches": self.n_prefetches,
                "prefetched_keys": self.n_prefetched_keys,
            }
