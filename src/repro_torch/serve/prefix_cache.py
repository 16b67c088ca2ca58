"""Global radix prefix cache — implicit COW page reuse for the host plane.

AraOS's result is that virtual-memory overhead stays negligible only when
translation state is *reused* rather than re-derived per access; the
serving analogue at page granularity is KV-prefix reuse.  COW fork sharing
(``VirtualMemory.fork_seq`` + the router's fork affinity) only shares
prefixes along **explicit** fork edges — a request must say
``share_prefix=True`` and name no prefix but the engine-resident one.  At
millions of users most shared prefixes are *implicit*: system prompts,
few-shot templates, multi-turn chat histories resubmitted verbatim.

This module is the index that makes the implicit case automatic: a
page-granularity radix trie over the **token content of resident mapped
page runs**.  Each edge is one whole page of tokens (``page_size`` of
them); each node records the set of resident sequences whose mapped pages
spell that token path.  An admission probes the trie with its prompt
(:meth:`PrefixCache.match`); on a hit the scheduler COW-maps the matched
whole pages from the owner via the *existing* ``fork_seq`` refcount
machinery — no new sharing mechanism, no fork API on the request — and
prefill starts at the first divergent page through the continuation
(``prefill_continue``) path.

Correctness rests on two invariants the scheduler maintains:

* **Registration happens only after KV commit.**  A sequence enters the
  trie (:meth:`register`) only once its prompt KV is actually written on
  the data plane (``finish_prefill`` / ``_flush_forked`` /
  ``preload_prefix``) — never at map time.  Causal attention makes page
  KV content a pure function of the token prefix, so a token-path match
  implies bit-identical committed pages.
* **Eviction is tied to residency.**  ``VirtualMemory`` fires an unmap
  hook on ``unmap_seq``/``spill_seq`` (retirement, preemption, rollback)
  and the scheduler wires it to :meth:`release`, so the trie never
  advertises pages whose frames have been freed.  Spilled sequences are
  simply dropped from the index (their restored frames would be valid
  again, but re-registration after restore is intentionally not done —
  the swap round-trip already paid the copy, and keeping the rule
  "resident == registered" keeps the trie trivially sound).

Only *committed prompt* tokens are indexed — whole pages of them; decode
appends are never registered (their tail pages mutate).  All state here is
pure Python/NumPy: this is scheduler (CVA6/OS-plane) state and holds no
device tensors.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PrefixCache"]


def _page_key(chunk: np.ndarray) -> tuple:
    """Hashable trie-edge key for one whole page of tokens."""
    return tuple(np.asarray(chunk).ravel().tolist())


class _Node:
    __slots__ = ("children", "owners")

    def __init__(self) -> None:
        self.children: dict[tuple, "_Node"] = {}
        self.owners: set[int] = set()


class PrefixCache:
    """Page-granularity radix trie over resident token runs.

    ``register(seq_id, tokens)`` indexes the whole pages of ``tokens``;
    ``match(tokens)`` returns the longest resident whole-page prefix and a
    sequence that owns it; ``release(seq_id)`` evicts a sequence's run
    (wired to the ``VirtualMemory`` unmap hook, so eviction tracks
    refcount drops automatically).
    """

    def __init__(self, page_size: int):
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        self.page_size = int(page_size)
        self._root = _Node()
        #: seq_id -> list of page keys (the trie path), for O(path) release
        self._paths: dict[int, list[tuple]] = {}
        #: seq_id -> the full registered token array (lets fork children be
        #: registered with prefix+prompt content without re-reading pages)
        self._tokens: dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------

    def register(self, seq_id: int, tokens: np.ndarray) -> int:
        """Index ``seq_id``'s committed tokens; returns whole pages indexed.

        Re-registering a live seq_id replaces its previous run (sequences
        only ever re-register with a superset after growth, but replace
        semantics keep the call idempotent).  Runs shorter than one page
        are not indexed (nothing whole-page to share).
        """
        tokens = np.asarray(tokens)
        if seq_id in self._paths:
            self.release(seq_id)
        ps = self.page_size
        whole = len(tokens) // ps
        node = self._root
        keys: list[tuple] = []
        for p in range(whole):
            key = _page_key(tokens[p * ps:(p + 1) * ps])
            node = node.children.setdefault(key, _Node())
            node.owners.add(seq_id)
            keys.append(key)
        if keys:
            self._paths[seq_id] = keys
            self._tokens[seq_id] = tokens
        return whole

    def release(self, seq_id: int) -> None:
        """Evict ``seq_id``'s run; prunes ownerless leaf-ward nodes.
        No-op for unregistered ids (the unmap hook fires for every
        sequence, registered or not)."""
        keys = self._paths.pop(seq_id, None)
        self._tokens.pop(seq_id, None)
        if keys is None:
            return
        node = self._root
        chain: list[tuple[_Node, tuple, _Node]] = []
        for key in keys:
            child = node.children.get(key)
            if child is None:       # defensive: never happens if register/
                break               # release stay symmetric
            chain.append((node, key, child))
            node = child
        for parent, key, child in reversed(chain):
            child.owners.discard(seq_id)
            if not child.owners and not child.children:
                del parent.children[key]

    # ------------------------------------------------------------------
    # probe
    # ------------------------------------------------------------------

    def match(self, tokens: np.ndarray) -> tuple[int, int | None]:
        """Longest resident whole-page prefix of ``tokens``.

        Returns ``(matched_tokens, owner_seq_id)`` with ``matched_tokens``
        a multiple of ``page_size`` (0 with owner ``None`` on a miss).
        The owner is any sequence registered through the deepest matched
        node — its first ``matched_tokens // page_size`` mapped pages
        spell exactly this token path (ties break to the smallest id, so
        a pinned engine prefix, conventionally id -1, wins).
        """
        tokens = np.asarray(tokens)
        ps = self.page_size
        node = self._root
        depth = 0
        owner: int | None = None
        for p in range(len(tokens) // ps):
            child = node.children.get(_page_key(tokens[p * ps:(p + 1) * ps]))
            if child is None or not child.owners:
                break
            node = child
            depth = p + 1
            owner = min(child.owners)
        return depth * ps, owner

    # ------------------------------------------------------------------
    # queries / invariants
    # ------------------------------------------------------------------

    def tokens_of(self, seq_id: int) -> np.ndarray | None:
        """The token array ``seq_id`` was registered with (None if not
        registered)."""
        return self._tokens.get(seq_id)

    def __contains__(self, seq_id: int) -> bool:
        return seq_id in self._paths

    @property
    def num_runs(self) -> int:
        return len(self._paths)

    def check_invariants(self) -> None:
        """Trie/bookkeeping consistency (property-tested):

        * every registered run's path is walkable and owned at each node;
        * every owner recorded anywhere in the trie is a registered run;
        * no ownerless leaf survives a release (no leaks).
        """
        for seq_id, keys in self._paths.items():
            node = self._root
            for key in keys:
                assert key in node.children, f"broken path for {seq_id}"
                node = node.children[key]
                assert seq_id in node.owners, f"unowned node for {seq_id}"

        def walk(node: _Node) -> None:
            for key, child in node.children.items():
                assert child.owners or child.children, "leaked empty node"
                for owner in child.owners:
                    assert owner in self._paths, f"stale owner {owner}"
                walk(child)

        walk(self._root)
