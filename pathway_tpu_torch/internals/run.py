"""The port's own copy of ``pathway_tpu/internals/run.py``. pw.run / pw.run_all (reference: python/pathway/internals/run.py:12,
GraphRunner internals/graph_runner/__init__.py:36)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch._unported import OBSERVABILITY, unported
from pathway_tpu_torch.engine.runtime import Runtime
from pathway_tpu_torch.internals import parse_graph


class MonitoringLevel:
    AUTO = "auto"
    AUTO_ALL = "auto_all"
    NONE = "none"
    IN_OUT = "in_out"
    ALL = "all"


def run(
    *,
    debug: bool = False,
    monitoring_level: Any = MonitoringLevel.AUTO,
    with_http_server: bool = False,
    default_logging: bool = True,
    persistence_config: Any = None,
    runtime_typechecking: bool | None = None,
    license_key: str | None = None,
    terminate_on_error: bool = True,
    autocommit_duration_ms: int = 50,
    diagnostics: str | None = None,
    **kwargs: Any,
) -> None:
    """Execute the dataflow declared so far (all registered outputs).

    ``persistence_config`` (or ``PATHWAY_REPLAY_STORAGE`` for record/replay)
    restores the store's state before the first tick and records every tick
    into it (``persistence/_runtime_glue.py``).

    Not ported, and raising ``NotImplementedError`` rather than running
    without them: the Graph Doctor (``diagnostics``), the monitoring server
    and dashboard
    (``with_http_server``, ``monitoring_level`` ALL/IN_OUT) and the
    multi-process engine. The reference's terminal dashboard for
    ``monitoring_level=AUTO`` on a tty is not shown.
    """
    if diagnostics not in (None, "off"):
        raise unported("pw.run(diagnostics=...) (the Graph Doctor)", OBSERVABILITY)
    if with_http_server or monitoring_level in (
        MonitoringLevel.ALL,
        MonitoringLevel.IN_OUT,
    ):
        raise unported("the monitoring server and dashboard", OBSERVABILITY)
    G = parse_graph.G
    seeds = list(G.outputs)
    if kwargs.pop("_all_nodes", False):
        from pathway_tpu_torch.engine import nodes as _nodes

        seeds += _nodes.ALL_NODES
    if not seeds:
        return
    # a multi-process group (PATHWAY_PROCESSES > 1) raises in Runtime
    runtime = Runtime(seeds, autocommit_ms=autocommit_duration_ms)
    G.runtime = runtime
    G.last_runtime = runtime
    if persistence_config is None:
        # record/replay debugging via env (PATHWAY_REPLAY_STORAGE, upstream
        # Pathway's internals/config.py:64-97 + `pathway spawn --record`)
        from pathway_tpu_torch.internals.config import get_pathway_config

        pw_cfg = get_pathway_config()
        if pw_cfg.replay_storage:
            from pathway_tpu_torch import persistence as _p

            persistence_config = _p.Config(
                backend=_p.Backend.filesystem(pw_cfg.replay_storage),
                snapshot_access=pw_cfg.snapshot_access or "record",
            )
    if persistence_config is not None:
        from pathway_tpu_torch.persistence._runtime_glue import attach_persistence

        attach_persistence(runtime, persistence_config)
    from pathway_tpu_torch.internals.telemetry import get_telemetry

    from pathway_tpu_torch.internals import errors as _errors

    err_pos = _errors.error_count()
    try:
        with get_telemetry().span(
            "pathway.run", nodes=len(runtime.order)
        ):
            runtime.run()
        if terminate_on_error:
            first = _errors.first_exception_since(err_pos)
            if first is not None:
                # surface the first runtime error with its original type
                # (reference: terminate_on_error=true run semantics,
                # python_api.rs:3329)
                if isinstance(first, BaseException):
                    raise first
                raise RuntimeError(first)
    finally:
        G.runtime = None
        for hook in G.post_run_hooks:
            try:
                hook()
            except Exception:
                pass


def run_all(**kwargs: Any) -> None:
    """Execute the ENTIRE declared graph, including nodes with no
    registered output (reference: GraphRunner run_all vs run_outputs)."""
    run(_all_nodes=True, **kwargs)
