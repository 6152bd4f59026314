"""The port's own copy of ``pathway_tpu/internals/run.py``. pw.run / pw.run_all (reference: python/pathway/internals/run.py:12,
GraphRunner internals/graph_runner/__init__.py:36)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.runtime import Runtime
from pathway_tpu_torch.internals import parse_graph


class MonitoringLevel:
    AUTO = "auto"
    AUTO_ALL = "auto_all"
    NONE = "none"
    IN_OUT = "in_out"
    ALL = "all"


# set by `python -m pathway_tpu_torch.analysis`: the script's pw.run() calls
# declare the graph but never build a Runtime
_build_only = False


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

    ``diagnostics`` runs the Graph Doctor (pathway_tpu_torch.analysis) over
    the declared graph before the engine starts: ``"warn"`` logs findings,
    ``"error"`` raises GraphDoctorError on warning-or-worse findings so not
    a single batch executes, ``"off"``/None skips the pass.

    ``with_http_server`` (or ``monitoring_level`` ALL/IN_OUT) starts the
    monitoring server (internals/monitoring_server.py: ``/metrics``,
    ``/debug/*``, ``/fleet/*``) on port 20000 + ``PATHWAY_PROCESS_ID``; the
    terminal dashboard shows for ALL/IN_OUT, and for AUTO on a tty.

    ``persistence_config`` (or ``PATHWAY_REPLAY_STORAGE`` for record/replay)
    restores the store's state before the first tick and records every tick
    into it (``persistence/_runtime_glue.py``).

    In a process group (``python -m pathway_tpu_torch.cli spawn -n N``)
    the runtime joins the host mesh; the device group on
    ``torch.distributed`` is joined too when ``PATHWAY_JAX_DISTRIBUTED=1``
    (the reference's variable, so one env means the same to both packages).
    """
    if _build_only:
        return
    G = parse_graph.G
    seeds = list(G.outputs)
    if kwargs.pop("_all_nodes", False):
        from pathway_tpu_torch.engine import nodes as _nodes

        seeds += _nodes.ALL_NODES
    if not seeds:
        return
    if diagnostics not in (None, "off"):
        from pathway_tpu_torch.analysis import check_before_run

        check_before_run(seeds, diagnostics)
    # join the process group when `spawn -n N` launched us (reference env
    # contract PATHWAY_PROCESSES/PROCESS_ID, config.rs:88). The engine's
    # multi-process transport is the host mesh (TCP), which the Runtime
    # joins itself; the torch.distributed device group is needed only for
    # cross-process device collectives (sharded KNN) and is joined when
    # PATHWAY_JAX_DISTRIBUTED=1.
    import os as _os

    from pathway_tpu_torch.parallel.host_exchange import dcn_active

    if not dcn_active() or _os.environ.get("PATHWAY_JAX_DISTRIBUTED") == "1":
        from pathway_tpu_torch.parallel.distributed import maybe_initialize

        maybe_initialize()
    else:
        import logging

        logging.getLogger("pathway_tpu_torch").warning(
            "multi-process engine: host-row exchange active; cross-process "
            "DEVICE collectives (sharded KNN over torch.distributed) "
            "are disabled — set PATHWAY_JAX_DISTRIBUTED=1 to join the "
            "device group as well"
        )
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
    if with_http_server or monitoring_level in (
        MonitoringLevel.ALL,
        MonitoringLevel.IN_OUT,
    ):
        from pathway_tpu_torch.internals.monitoring_server import start_http_server

        try:
            start_http_server(runtime)
        except Exception:
            # the run goes on unmonitored, as in the reference, but says so
            import logging

            logging.getLogger("pathway_tpu_torch").warning(
                "monitoring server failed to start", exc_info=True
            )
    monitor = None
    import sys as _sys

    want_tui = monitoring_level in (MonitoringLevel.ALL, MonitoringLevel.IN_OUT) or (
        monitoring_level in (MonitoringLevel.AUTO, MonitoringLevel.AUTO_ALL)
        and _sys.stdout.isatty()
    )
    if want_tui:
        from pathway_tpu_torch.internals.monitoring import StatsMonitor

        monitor = StatsMonitor(runtime)
        monitor.start()
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
        if monitor is not None:
            monitor.stop()
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
