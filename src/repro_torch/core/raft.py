"""Raft consensus for EdgeKV edge groups (replication manager, §3.2.4).

A message-passing implementation of Raft (Ongaro & Ousterhout 2014, the
paper's [15]): randomized leader election, append-entries log replication,
majority-quorum commit, and **non-voting learners** — the mechanism EdgeKV
§7.3 uses for backup groups (they receive all entries and commit
notifications but are never counted in the quorum and never stand for
election).

Transport is abstracted: handlers return ``(dest, message)`` pairs and a
driver delivers them. Two drivers exist:

* :class:`LocalCluster` below — immediate in-memory delivery with a virtual
  clock, used by unit tests (election safety, log matching) and by the
  synchronous :mod:`repro_torch.core.kvstore` API.
* :class:`repro_torch.sim.events.EventLoop` — latency-delayed delivery over the
  paper's Table-3 link model, used by the testbed emulation.

Time is always *virtual* (floats, seconds); nothing here reads wall clock.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

FOLLOWER, CANDIDATE, LEADER, LEARNER = "follower", "candidate", "leader", "learner"


# ----------------------------------------------------------------- messages
@dataclass
class RequestVote:
    term: int
    candidate: str
    last_log_index: int
    last_log_term: int


@dataclass
class VoteResponse:
    term: int
    voter: str
    granted: bool


@dataclass
class AppendEntries:
    term: int
    leader: str
    prev_index: int
    prev_term: int
    entries: List[Tuple[int, Any]]  # [(term, command)]
    leader_commit: int


@dataclass
class AppendResponse:
    term: int
    follower: str
    success: bool
    match_index: int


Outbox = List[Tuple[str, Any]]


def message_sender(msg: Any) -> str:
    """The node id a Raft message originated from (link-level metadata:
    every message type carries its sender in a role-named field)."""
    if isinstance(msg, RequestVote):
        return msg.candidate
    if isinstance(msg, VoteResponse):
        return msg.voter
    if isinstance(msg, AppendEntries):
        return msg.leader
    if isinstance(msg, AppendResponse):
        return msg.follower
    raise TypeError(f"not a Raft message: {type(msg).__name__}")


class RaftNode:
    """One Raft participant. ``voter=False`` makes it a learner (§7.3)."""

    ELECTION_TIMEOUT = (0.15, 0.30)  # seconds, randomized per Raft paper
    HEARTBEAT = 0.05

    def __init__(
        self,
        node_id: str,
        peers: List[str],
        *,
        voter: bool = True,
        apply_fn: Optional[Callable[[Any], Any]] = None,
        rng: Optional[random.Random] = None,
    ):
        self.id = node_id
        self.peers = [p for p in peers if p != node_id]
        self.is_voter = voter
        self.apply_fn = apply_fn or (lambda cmd: None)
        self.rng = rng or random.Random(stable_seed(node_id))

        self.term = 0
        self.voted_for: Optional[str] = None
        self.log: List[Tuple[int, Any]] = []  # 1-indexed via helpers
        self.commit_index = 0
        self.last_applied = 0
        self.role = LEARNER if not voter else FOLLOWER
        self.leader_id: Optional[str] = None

        # leader state
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}
        self.votes: Set[str] = set()

        self.election_deadline = 0.0
        self.heartbeat_due = 0.0
        self.voter_ids: Set[str] = set()  # filled by cluster wiring
        self.applied: List[Any] = []  # applied commands, in order

    # ------------------------------------------------------------- helpers
    def _last_index(self) -> int:
        return len(self.log)

    def _term_at(self, index: int) -> int:
        if index == 0:
            return 0
        return self.log[index - 1][0]

    def _reset_election_timer(self, now: float) -> None:
        lo, hi = self.ELECTION_TIMEOUT
        self.election_deadline = now + self.rng.uniform(lo, hi)

    def start(self, now: float) -> None:
        self._reset_election_timer(now)

    # ---------------------------------------------------------------- tick
    def tick(self, now: float) -> Outbox:
        out: Outbox = []
        if self.role == LEARNER:
            return out
        if self.role == LEADER:
            if now >= self.heartbeat_due:
                out.extend(self._broadcast_append(now))
            return out
        if now >= self.election_deadline:
            out.extend(self._start_election(now))
        return out

    def _start_election(self, now: float) -> Outbox:
        self.term += 1
        self.role = CANDIDATE
        self.voted_for = self.id
        self.votes = {self.id}
        self._reset_election_timer(now)
        msg = RequestVote(self.term, self.id, self._last_index(),
                          self._term_at(self._last_index()))
        out = [(p, msg) for p in self.peers if p in self.voter_ids]
        if self._has_quorum(self.votes):
            out.extend(self._become_leader(now))
        return out

    def _has_quorum(self, acks: set) -> bool:
        voters = self.voter_ids
        return len(acks & voters) * 2 > len(voters)

    def _become_leader(self, now: float) -> Outbox:
        self.role = LEADER
        self.leader_id = self.id
        last = self._last_index()
        self.next_index = {p: last + 1 for p in self.peers}
        self.match_index = {p: 0 for p in self.peers}
        self.heartbeat_due = now  # send immediately
        return self._broadcast_append(now)

    def _broadcast_append(self, now: float) -> Outbox:
        self.heartbeat_due = now + self.HEARTBEAT
        out: Outbox = []
        for p in self.peers:  # learners receive entries too (non-voting)
            out.append((p, self._append_for(p)))
        return out

    def _append_for(self, peer: str) -> AppendEntries:
        ni = self.next_index.get(peer, self._last_index() + 1)
        prev = ni - 1
        entries = self.log[prev:]
        return AppendEntries(self.term, self.id, prev, self._term_at(prev),
                             list(entries), self.commit_index)

    # ------------------------------------------------------------ proposals
    def client_propose(self, command: Any, now: float) -> Optional[int]:
        """Leader-only; returns the log index the command will commit at."""
        if self.role != LEADER:
            return None
        self.log.append((self.term, command))
        # single-voter degenerate group commits immediately
        self._advance_commit()
        return self._last_index()

    # ------------------------------------------------------------ messages
    def on_message(self, msg: Any, now: float) -> Outbox:
        out: Outbox = []
        term = getattr(msg, "term", 0)
        if term > self.term:
            self.term = term
            self.voted_for = None
            if self.role in (CANDIDATE, LEADER):
                self.role = FOLLOWER

        if isinstance(msg, RequestVote):
            out.extend(self._on_request_vote(msg, now))
        elif isinstance(msg, VoteResponse):
            out.extend(self._on_vote_response(msg, now))
        elif isinstance(msg, AppendEntries):
            out.extend(self._on_append_entries(msg, now))
        elif isinstance(msg, AppendResponse):
            out.extend(self._on_append_response(msg, now))
        self._apply_committed()
        return out

    def _on_request_vote(self, msg: RequestVote, now: float) -> Outbox:
        granted = False
        if self.is_voter and msg.term >= self.term:
            up_to_date = (msg.last_log_term, msg.last_log_index) >= (
                self._term_at(self._last_index()), self._last_index())
            if up_to_date and self.voted_for in (None, msg.candidate):
                granted = True
                self.voted_for = msg.candidate
                self._reset_election_timer(now)
        return [(msg.candidate, VoteResponse(self.term, self.id, granted))]

    def _on_vote_response(self, msg: VoteResponse, now: float) -> Outbox:
        if self.role != CANDIDATE or msg.term != self.term:
            return []
        if msg.granted:
            self.votes.add(msg.voter)
            if self._has_quorum(self.votes):
                return self._become_leader(now)
        return []

    def _on_append_entries(self, msg: AppendEntries, now: float) -> Outbox:
        if msg.term < self.term:
            return [(msg.leader, AppendResponse(self.term, self.id, False, 0))]
        # valid leader for this term
        if self.role != LEARNER:
            self.role = FOLLOWER
        self.leader_id = msg.leader
        self._reset_election_timer(now)
        # log consistency check
        if msg.prev_index > self._last_index() or (
                msg.prev_index > 0 and self._term_at(msg.prev_index) != msg.prev_term):
            return [(msg.leader, AppendResponse(self.term, self.id, False,
                                                self.commit_index))]
        # append / overwrite conflicting suffix (Log Matching property)
        idx = msg.prev_index
        for entry in msg.entries:
            idx += 1
            if idx <= self._last_index():
                if self.log[idx - 1][0] != entry[0]:
                    del self.log[idx - 1:]
                    self.log.append(entry)
            else:
                self.log.append(entry)
        if msg.leader_commit > self.commit_index:
            self.commit_index = min(msg.leader_commit, self._last_index())
        return [(msg.leader, AppendResponse(self.term, self.id, True,
                                            msg.prev_index + len(msg.entries)))]

    def _on_append_response(self, msg: AppendResponse, now: float) -> Outbox:
        if self.role != LEADER or msg.term != self.term:
            return []
        if msg.success:
            self.match_index[msg.follower] = max(
                self.match_index.get(msg.follower, 0), msg.match_index)
            self.next_index[msg.follower] = self.match_index[msg.follower] + 1
            self._advance_commit()
            return []
        # back off and retry
        self.next_index[msg.follower] = max(1, self.next_index.get(
            msg.follower, 1) - 1)
        return [(msg.follower, self._append_for(msg.follower))]

    def _advance_commit(self) -> None:
        """Commit the highest index replicated on a majority of *voters*.

        Learners' match indices are intentionally excluded — EdgeKV §7.3:
        the backup group 'is not counted in the consensus majority'.
        """
        if self.role != LEADER:
            return
        for n in range(self._last_index(), self.commit_index, -1):
            if self._term_at(n) != self.term:
                break  # Raft only commits entries from its own term directly
            acks = {self.id}
            acks.update(p for p, m in self.match_index.items()
                        if m >= n and p in self.voter_ids)
            if self._has_quorum(acks):
                self.commit_index = n
                break
        self._apply_committed()

    def _apply_committed(self) -> None:
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            cmd = self.log[self.last_applied - 1][1]
            self.applied.append(cmd)
            self.apply_fn(cmd)


def stable_seed(s: str) -> int:
    import hashlib
    return int.from_bytes(hashlib.sha1(s.encode()).digest()[:4], "big")


# ------------------------------------------------------------------ driver
class LocalCluster:
    """Synchronous in-memory Raft cluster with a virtual clock.

    Used by unit tests and the synchronous KV API. ``step`` advances virtual
    time and drains the message queue to quiescence (instant links).
    """

    def __init__(self, ids: List[str], *, learners: Tuple[str, ...] = (),
                 apply_fns: Optional[Dict[str, Callable]] = None, seed: int = 0):
        all_ids = list(ids) + list(learners)
        self.nodes: Dict[str, RaftNode] = {}
        voters = set(ids)
        for nid in all_ids:
            self.nodes[nid] = RaftNode(
                nid, all_ids, voter=nid in voters,
                apply_fn=(apply_fns or {}).get(nid),
                rng=random.Random(seed * 7919 + stable_seed(nid)),
            )
        for n in self.nodes.values():
            n.voter_ids = voters
        self.now = 0.0
        self.down: Set[str] = set()
        # node id -> side (0/1) while a network cut is active; None = whole.
        # Messages crossing the cut are dropped in flight (both directions),
        # so each side runs Raft against only its own members.
        self.partition: Optional[Dict[str, int]] = None
        for n in self.nodes.values():
            n.start(self.now)

    # -- control
    def crash(self, node_id: str) -> None:
        self.down.add(node_id)

    def recover(self, node_id: str) -> None:
        self.down.discard(node_id)
        self.nodes[node_id]._reset_election_timer(self.now)

    def set_partition(self, sides: Dict[str, int]) -> None:
        """Install a network cut: ``sides`` maps node ids to side 0 or 1
        (unlisted ids default to side 0). The cut gates *links*, not
        nodes — every node keeps running, but cross-side messages vanish,
        so only a side holding a voter majority can commit."""
        self.partition = dict(sides)

    def heal_partition(self) -> None:
        """Remove the cut and re-converge before returning.

        A minority-side candidate may hold an inflated term after
        campaigning into the void; the explicit step lets the surviving
        leader's next heartbeat collide with that term *now* (one
        disruptive re-election at most), so the caller's next ``propose``
        starts from a stable leader instead of tripping over a stale
        higher term mid-commit."""
        self.partition = None
        for nid, n in self.nodes.items():
            if nid not in self.down:
                n._reset_election_timer(self.now)
        self.step()
        self.run_until_leader()

    def quorum_side(self) -> Optional[int]:
        """The side of the cut that still holds a live-voter majority of
        the *full* voter set (the only side that can commit), ``0`` when
        no cut is active, or ``None`` when the cut splits the quorum."""
        if self.partition is None:
            return 0
        total = counted = 0
        per_side: Dict[int, int] = {}
        for nid, n in self.nodes.items():
            if not n.is_voter:
                continue
            total += 1
            if nid in self.down:
                continue
            s = self.partition.get(nid, 0)
            per_side[s] = per_side.get(s, 0) + 1
            counted += 1
        for s in sorted(per_side):
            if per_side[s] * 2 > total:
                return s
        return None

    def leader(self) -> Optional[RaftNode]:
        leaders = [n for n in self.nodes.values()
                   if n.role == LEADER and n.id not in self.down]
        if self.partition is not None:
            # a leader stranded on the wrong side of the cut cannot commit
            # (and must never serve linearizable reads) — only the quorum
            # side's leader counts while the cut is active
            qs = self.quorum_side()
            leaders = [n for n in leaders
                       if self.partition.get(n.id, 0) == qs]
        if not leaders:
            return None
        return max(leaders, key=lambda n: n.term)

    # -- execution
    def _deliver(self, queue: List[Tuple[str, Any]]) -> None:
        guard = 0
        while queue:
            guard += 1
            if guard > 100_000:
                raise RuntimeError("raft message storm")
            dest, msg = queue.pop(0)
            if dest in self.down:
                continue
            if self.partition is not None and \
                    self.partition.get(message_sender(msg), 0) != \
                    self.partition.get(dest, 0):
                continue  # the cut drops cross-side traffic in flight
            queue.extend(self.nodes[dest].on_message(msg, self.now))

    def step(self, dt: float = 0.05) -> None:
        self.now += dt
        queue: List[Tuple[str, Any]] = []
        for nid, n in self.nodes.items():
            if nid in self.down:
                continue
            queue.extend(n.tick(self.now))
        self._deliver(queue)

    def run_until_leader(self, max_steps: int = 400) -> RaftNode:
        for _ in range(max_steps):
            lead = self.leader()
            if lead is not None:
                return lead
            self.step()
        raise RuntimeError("no leader elected")

    def propose(self, command: Any) -> int:
        """Propose via the current leader and drive to commit."""
        lead = self.run_until_leader()
        idx = lead.client_propose(command, self.now)
        assert idx is not None
        # drive replication: leader heartbeat -> followers -> acks
        for _ in range(50):
            self.step(RaftNode.HEARTBEAT)
            if lead.commit_index >= idx:
                return idx
        raise RuntimeError("command failed to commit")
