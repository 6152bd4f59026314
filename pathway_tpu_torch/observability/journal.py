"""Own copy of ``pathway_tpu/observability/journal.py`` (standard library
only), with its own ``thread_stack_dump`` for the postmortem bundle (the
reference takes it from ``observability/debug.py``, which is not ported).

Fleet Lens incident journal — a structured, bounded, atomically
persisted record of the events that define the fleet's failure story.

Chaos benches used to measure takeover and reshard windows with
bench-side stopwatches; the system itself kept no record.  This module
is the system's own record: every plane appends structured events —
standby takeover, zombie fencing, router ejection/readmission, reshard
phase transitions, incarnation bumps, mid-decode deadline drops,
compiled-segment fallbacks, recovery windows — each stamped with
(incarnation, tick, wall clock, monotonic clock), held in a bounded
ring, surfaced at ``/debug/events`` (monitoring server, replica HTTP,
router) and merged fleet-wide at ``/fleet/events``.

Two durability properties:

* **Crash-surviving**: with ``PATHWAY_JOURNAL_PATH`` set the ring is
  persisted via tmp+rename (throttled — the hot path never waits on
  fsync), so a restarted member picks its own past back up; a SIGKILLed
  member that never flushed is reconstructed from its PEERS' events
  (the fencing/takeover records every survivor journals about it).
* **Postmortem bundle**: FAULT_EXIT paths (testing/faults.py) and
  unhandled exceptions (``install_crash_hooks``) write a single-file
  bundle — journal tail + last spans + metrics snapshot + thread dump —
  via tmp+rename, so the last words of a dying process are readable
  even when nothing scraped it in time.

Wall-clock stamps are what cross processes (the fleet merge orders by
(incarnation, wall)); the monotonic stamp is only meaningful within one
process and rides along for intra-member deltas.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterable

_DEPTH_ENV = "PATHWAY_JOURNAL_DEPTH"
_PATH_ENV = "PATHWAY_JOURNAL_PATH"
_MEMBER_ENV = "PATHWAY_JOURNAL_MEMBER"
_FLUSH_MS_ENV = "PATHWAY_JOURNAL_FLUSH_MS"
_POSTMORTEM_DIR_ENV = "PATHWAY_POSTMORTEM_DIR"


def default_member() -> str:
    """This process's member identity in fleet-merged timelines.
    Explicit ``PATHWAY_JOURNAL_MEMBER`` wins; otherwise the serving-plane
    role env vars name the member the way the router and supervisor
    already do."""
    explicit = os.environ.get(_MEMBER_ENV, "")
    if explicit:
        return explicit
    rid = os.environ.get("PATHWAY_REPLICA_ID", "")
    if rid:
        return f"replica-{rid}"
    if os.environ.get("PATHWAY_REPL_PORT", ""):
        return "writer"
    pid = os.environ.get("PATHWAY_PROCESS_ID", "")
    if pid:
        return f"rank-{pid}"
    return f"proc-{os.getpid()}"


def _env_incarnation() -> int:
    try:
        return int(os.environ.get("PATHWAY_MESH_INCARNATION", "0") or 0)
    except ValueError:
        return 0


@dataclass
class JournalEvent:
    """One incident-journal entry.  ``wall`` (unix seconds) is the
    cross-member ordering clock; ``mono`` (``time.monotonic()``) is only
    comparable within the emitting process."""

    seq: int
    kind: str
    detail: str
    member: str
    incarnation: int
    tick: int | None
    wall: float
    mono: float
    data: dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> dict[str, Any]:
        return {
            "seq": self.seq,
            "kind": self.kind,
            "detail": self.detail,
            "member": self.member,
            "incarnation": self.incarnation,
            "tick": self.tick,
            "wall": self.wall,
            "mono": self.mono,
            "data": dict(self.data),
        }


class IncidentJournal:
    """Bounded ring of :class:`JournalEvent` with optional tmp+rename
    persistence and the fatal-exit postmortem bundle."""

    def __init__(
        self,
        capacity: int | None = None,
        path: str | None = None,
        member: str | None = None,
    ):
        if capacity is None:
            try:
                capacity = int(os.environ.get(_DEPTH_ENV, "1024") or 1024)
            except ValueError:
                capacity = 1024
        self.capacity = max(int(capacity), 8)
        self.path = path if path is not None else os.environ.get(
            _PATH_ENV, ""
        ) or None
        self.member = member or default_member()
        try:
            flush_ms = float(os.environ.get(_FLUSH_MS_ENV, "500") or 500)
        except ValueError:
            flush_ms = 500.0
        self._flush_s = max(flush_ms, 0.0) / 1000.0
        self._lock = threading.Lock()
        self._ring: deque[JournalEvent] = deque(maxlen=self.capacity)
        self._seq = 0
        self._last_persist = 0.0
        self._dirty = False
        if self.path:
            self._load()

    # --- recording --------------------------------------------------------

    def record(
        self,
        kind: str,
        detail: str = "",
        *,
        tick: int | None = None,
        incarnation: int | None = None,
        member: str | None = None,
        persist: bool = False,
        **data: Any,
    ) -> JournalEvent:
        """Append one event (thread-safe; never raises).  ``persist=True``
        forces an immediate atomic flush — takeover/fencing records must
        survive the very next SIGKILL."""
        if incarnation is None:
            incarnation = _env_incarnation()
        ev = JournalEvent(
            seq=0,
            kind=str(kind),
            detail=str(detail),
            member=member or self.member,
            incarnation=int(incarnation),
            tick=None if tick is None else int(tick),
            wall=time.time(),
            mono=time.monotonic(),
            data={k: _jsonable(v) for k, v in data.items()},
        )
        with self._lock:
            self._seq += 1
            ev.seq = self._seq
            self._ring.append(ev)
            self._dirty = True
        if self.path:
            try:
                if persist or (
                    time.monotonic() - self._last_persist >= self._flush_s
                ):
                    self.flush()
            except Exception:
                pass
        return ev

    # --- inspection -------------------------------------------------------

    def events(
        self,
        kinds: Iterable[str] | None = None,
        since_seq: int = 0,
    ) -> list[dict[str, Any]]:
        with self._lock:
            recs = list(self._ring)
        want = set(kinds) if kinds is not None else None
        return [
            e.as_dict()
            for e in recs
            if e.seq > since_seq and (want is None or e.kind in want)
        ]

    def tail(self, n: int = 50) -> list[dict[str, Any]]:
        with self._lock:
            recs = list(self._ring)[-max(int(n), 0):]
        return [e.as_dict() for e in recs]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # --- persistence (tmp+rename, same idiom as standby's position file) --

    def flush(self) -> None:
        """Atomically persist the ring to ``self.path`` (no-op without a
        path).  Safe to call from signal/exit paths."""
        if not self.path:
            return
        with self._lock:
            if not self._dirty:
                return
            recs = [e.as_dict() for e in self._ring]
            self._dirty = False
        body = "\n".join(json.dumps(r) for r in recs) + "\n"
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w") as f:
                f.write(body)
            os.replace(tmp, self.path)
            self._last_persist = time.monotonic()
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _load(self) -> None:
        """Restore the persisted tail (crash-surviving): restored events
        keep their original stamps, marked ``restored`` so consumers can
        tell a pre-crash record from this incarnation's."""
        try:
            with open(self.path) as f:
                lines = f.read().splitlines()
        except OSError:
            return
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                r = json.loads(line)
                data = dict(r.get("data") or {})
                data["restored"] = True
                ev = JournalEvent(
                    seq=0,
                    kind=str(r["kind"]),
                    detail=str(r.get("detail", "")),
                    member=str(r.get("member", self.member)),
                    incarnation=int(r.get("incarnation", 0)),
                    tick=r.get("tick"),
                    wall=float(r.get("wall", 0.0)),
                    mono=float(r.get("mono", 0.0)),
                    data=data,
                )
            except (KeyError, TypeError, ValueError):
                continue
            self._seq += 1
            ev.seq = self._seq
            self._ring.append(ev)

    # --- postmortem bundle ------------------------------------------------

    def postmortem(
        self,
        reason: str,
        exc: BaseException | None = None,
        directory: str | None = None,
    ) -> str | None:
        """Write the fatal-exit bundle — journal tail + last spans +
        metrics snapshot + thread dump — via tmp+rename.  Every
        ingredient is best-effort: a broken scrape must not mask the
        exit code.  Returns the bundle path (None when nowhere to
        write)."""
        directory = directory or os.environ.get(_POSTMORTEM_DIR_ENV, "")
        if not directory and self.path:
            directory = os.path.join(
                os.path.dirname(os.path.abspath(self.path)), "postmortem"
            )
        if not directory:
            return None
        bundle: dict[str, Any] = {
            "reason": str(reason),
            "member": self.member,
            "pid": os.getpid(),
            "incarnation": _env_incarnation(),
            "wall": time.time(),
            "mono": time.monotonic(),
        }
        if exc is not None:
            import traceback

            bundle["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": "".join(
                    traceback.format_exception(type(exc), exc, exc.__traceback__)
                ),
            }
        bundle["journal"] = self.tail(self.capacity)
        try:
            from pathway_tpu_torch.observability.tracing import get_tracer

            bundle["spans"] = [
                r.to_dict() for r in get_tracer().spans()[-256:]
            ]
        except Exception:
            bundle["spans"] = []
        try:
            from pathway_tpu_torch.observability.registry import REGISTRY

            bundle["metrics"] = REGISTRY.render()
        except Exception:
            bundle["metrics"] = ""
        try:
            bundle["threads"] = thread_stack_dump()
        except Exception:
            bundle["threads"] = ""
        name = (
            f"postmortem-{_fs_safe(self.member)}-{os.getpid()}-"
            f"{int(time.time() * 1000)}.json"
        )
        path = os.path.join(directory, name)
        tmp = f"{path}.tmp"
        try:
            os.makedirs(directory, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(bundle, f)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        try:
            self.flush()
        except Exception:
            pass
        return path


def thread_stack_dump() -> str:
    """Human-readable stack of every live Python thread."""
    import sys
    import traceback

    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    out: list[str] = [
        f"=== thread dump: {len(frames)} thread(s), pid={os.getpid()} ===",
    ]
    for ident, frame in sorted(frames.items(), key=lambda kv: kv[0] or 0):
        t = by_ident.get(ident)
        name = t.name if t is not None else "<unknown>"
        daemon = " daemon" if t is not None and t.daemon else ""
        out.append(f"\n--- Thread {name!r} (ident={ident}{daemon}) ---")
        out.extend(
            line.rstrip("\n") for line in traceback.format_stack(frame)
        )
    return "\n".join(out) + "\n"


def _fs_safe(s: str) -> str:
    return "".join(c if c.isalnum() or c in "-_." else "_" for c in s)


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


# --- process-global journal -------------------------------------------------

_journal: IncidentJournal | None = None
_journal_lock = threading.Lock()


def journal() -> IncidentJournal:
    """The process-wide incident journal (lazily constructed from the
    PATHWAY_JOURNAL_* env)."""
    global _journal
    if _journal is None:
        with _journal_lock:
            if _journal is None:
                _journal = IncidentJournal()
    return _journal


def reset_journal() -> None:
    """Test hook: flush and forget the process-global journal (the next
    :func:`journal` call re-reads the env)."""
    global _journal
    with _journal_lock:
        if _journal is not None:
            try:
                _journal.flush()
            except Exception:
                pass
        _journal = None


def record(kind: str, detail: str = "", **kwargs: Any) -> JournalEvent:
    """Convenience: ``journal().record(...)`` — the one-liner every
    plane's event sites call."""
    return journal().record(kind, detail, **kwargs)


# --- crash hooks ------------------------------------------------------------

_hooks_installed = False
_hooks_lock = threading.Lock()


def install_crash_hooks() -> None:
    """Chain a postmortem-bundle writer into ``sys.excepthook`` and
    ``threading.excepthook`` (idempotent).  The original hooks still run
    — this only ADDS the bundle, it never swallows the traceback."""
    global _hooks_installed
    with _hooks_lock:
        if _hooks_installed:
            return
        _hooks_installed = True
    import sys

    prev_sys = sys.excepthook
    prev_thread = threading.excepthook

    def _sys_hook(exc_type, exc, tb):
        try:
            journal().record(
                "unhandled-exception",
                f"{exc_type.__name__}: {exc}",
                persist=True,
            )
            journal().postmortem("unhandled-exception", exc)
        except Exception:
            pass
        prev_sys(exc_type, exc, tb)

    def _thread_hook(args):
        try:
            if args.exc_type is not SystemExit:
                journal().record(
                    "unhandled-exception",
                    f"{args.exc_type.__name__}: {args.exc_value} "
                    f"(thread {getattr(args.thread, 'name', '?')})",
                    persist=True,
                )
                journal().postmortem(
                    "unhandled-thread-exception", args.exc_value
                )
        except Exception:
            pass
        prev_thread(args)

    sys.excepthook = _sys_hook
    threading.excepthook = _thread_hook
