"""pathway_tpu_torch — the PyTorch/CUDA port of ``pathway_tpu``.

The JAX package ``pathway_tpu`` is the reference; this package re-implements
it on PyTorch, with the reference's two Pallas kernels written by hand in
CUDA C++ for Hopper (``csrc/block_topk.cu``, ``csrc/paged_attention.cu``).
What is ported: the incremental dataflow engine and its Table API
(``import pathway_tpu_torch as pw``: ``pw.Table``, ``pw.Schema``,
``pw.this``, ``pw.reducers``, ``pw.udf``, ``pw.io.python``,
``pw.io.subscribe``, the file connectors ``pw.io.fs``/``csv``/``jsonlines``/
``plaintext``/``null``, ``pw.debug``, ``pw.run``, ``pw.persistence``,
``pw.iterate``, ``pw.sql``, the row transformers, ``pw.AsyncTransformer``,
``pw.pandas_transformer``, ``pw.udfs``, ``pw.universes``,
``pw.stdlib.utils``, ``pw.live``/``pw.LiveTable``, ``pw.demo``,
``pw.load_yaml``, and the temporal operators: ``pw.temporal`` windows,
behaviors and interval/asof/window joins, ``.dt``, ``pw.ordered``,
``pw.stateful`` and ``pw.statistical``),
live-RAG retrieval (embedder UDF → ``DataIndex`` → dense top-k, or the
IVF, LSH, BM25 and hybrid indexes; ``pw.stdlib.ml.KNNIndex`` with the kNN
classifiers, LSH clustering, the fuzzy join, ``hmm`` and ``datasets``), and
generation serving.

Modules keep the JAX package's paths and public names so each counterpart is
easy to find. The package imports neither ``jax`` nor ``pandas`` nor
anything of ``pathway_tpu``: what it needs from the framework-neutral layers
it keeps as its own copy. Importing it does not initialise CUDA.

Entry points take ``device=`` and default to ``"cuda"``; without a card they
raise unless the caller passes ``device="cpu"`` explicitly. A reference
feature that is not ported raises ``NotImplementedError`` naming its
``ROADMAP.md`` tag (``_unported.py``).
"""

from __future__ import annotations

import pathway_tpu_torch.reducers as reducers
from pathway_tpu_torch import debug, demo, io, udfs
from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch._unported import ROOT_NAMES, unported
from pathway_tpu_torch.internals import (
    UDF,
    ColumnExpression,
    ColumnReference,
    DateTimeNaive,
    DateTimeUtc,
    GroupedJoinResult,
    GroupedTable,
    Joinable,
    JoinMode,
    JoinResult,
    Json,
    MonitoringLevel,
    PathwayType as Type,
    PersistenceMode,
    Pointer,
    PyObjectWrapper,
    Schema,
    SchemaProperties,
    Table,
    TableLike,
    __version__,
    apply,
    apply_async,
    apply_with_type,
    assert_table_has_schema,
    cast,
    coalesce,
    column_definition,
    declare_type,
    fill_error,
    global_error_log,
    groupby,
    if_else,
    join,
    join_inner,
    join_left,
    join_outer,
    join_right,
    left,
    local_error_log,
    make_tuple,
    require,
    right,
    run,
    run_all,
    schema_builder,
    schema_from_csv,
    schema_from_dict,
    schema_from_types,
    this,
    udf,
    unwrap,
    wrap_py_object,
)
from pathway_tpu_torch.internals.custom_reducers import BaseCustomAccumulator
from pathway_tpu_torch.internals.interactive import LiveTable, live
from pathway_tpu_torch.internals.iterate import iterate, iterate_universe
from pathway_tpu_torch.internals.joins import OuterJoinResult
from pathway_tpu_torch.stdlib.temporal._asof_join import AsofJoinResult
from pathway_tpu_torch.stdlib.temporal._interval_join import IntervalJoinResult
from pathway_tpu_torch.stdlib.temporal._window_join import WindowJoinResult
from pathway_tpu_torch.internals.row_transformer import (
    ClassArg,
    attribute,
    input_attribute,
    input_method,
    method,
    output_attribute,
    transformer,
)
from pathway_tpu_torch.internals.sql import sql
from pathway_tpu_torch.internals.table_slice import TableSlice
from pathway_tpu_torch.internals.yaml_loader import load_yaml
import pathway_tpu_torch.persistence as persistence
import pathway_tpu_torch.universes as universes
from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer
from pathway_tpu_torch.stdlib.utils.pandas_transformer import pandas_transformer


def __getattr__(name: str):
    # stdlib subpackages load lazily, as in the reference; Duration builds
    # (and imports pandas) only when asked for; a reference root name the
    # port lacks raises naming its ROADMAP item
    import importlib

    if name == "Duration":
        from pathway_tpu_torch.internals import datetime_types

        return datetime_types.Duration
    if name in importlib.import_module("pathway_tpu_torch.stdlib").__all__:
        module = importlib.import_module(f"pathway_tpu_torch.stdlib.{name}")
    elif name in ("stdlib", "xpacks"):
        module = importlib.import_module(f"pathway_tpu_torch.{name}")
    elif name in ROOT_NAMES:
        raise unported(f"pw.{name}", ROOT_NAMES[name])
    else:
        raise AttributeError(name)
    globals()[name] = module
    return module


def set_license_key(key: str | None) -> None:
    """No-op: this framework has no license gating (reference:
    src/engine/license.rs — intentionally not reproduced)."""


def set_monitoring_config(*, server_endpoint: str | None = None, **kwargs) -> None:
    from pathway_tpu_torch.internals import config

    config.pathway_config.monitoring_server = server_endpoint


def enable_interactive_mode() -> None:
    """Compatibility no-op, as in the reference: ``pw.live``/``LiveTable``
    work without prior opt-in."""


def table_transformer(*args, **kwargs):
    """Decorator marking a function as a table→table transformer
    (reference: internals/table_transformer.py). Pass-through."""

    def wrap(fn):
        return fn

    if args and callable(args[0]):
        return args[0]
    return wrap


__all__ = [
    "__version__",
    "resolve_device",
    "debug",
    "demo",
    "io",
    "graphs",
    "indexing",
    "ml",
    "ordered",
    "stateful",
    "statistical",
    "temporal",
    "utils",
    "udfs",
    "universes",
    "xpacks",
    "reducers",
    "iterate",
    "iterate_universe",
    "sql",
    "AsyncTransformer",
    "pandas_transformer",
    "ClassArg",
    "attribute",
    "input_attribute",
    "input_method",
    "method",
    "output_attribute",
    "transformer",
    "TableSlice",
    "set_license_key",
    "set_monitoring_config",
    "enable_interactive_mode",
    "LiveTable",
    "live",
    "load_yaml",
    "table_transformer",
    "apply",
    "apply_async",
    "apply_with_type",
    "assert_table_has_schema",
    "cast",
    "coalesce",
    "column_definition",
    "declare_type",
    "fill_error",
    "if_else",
    "make_tuple",
    "require",
    "unwrap",
    "udf",
    "UDF",
    "BaseCustomAccumulator",
    "ColumnExpression",
    "ColumnReference",
    "DateTimeNaive",
    "DateTimeUtc",
    "Duration",
    "GroupedJoinResult",
    "GroupedTable",
    "Joinable",
    "JoinMode",
    "JoinResult",
    "OuterJoinResult",
    "AsofJoinResult",
    "IntervalJoinResult",
    "WindowJoinResult",
    "Json",
    "MonitoringLevel",
    "PersistenceMode",
    "persistence",
    "Pointer",
    "PyObjectWrapper",
    "wrap_py_object",
    "Schema",
    "SchemaProperties",
    "Table",
    "TableLike",
    "Type",
    "global_error_log",
    "local_error_log",
    "groupby",
    "join",
    "join_inner",
    "join_left",
    "join_outer",
    "join_right",
    "left",
    "right",
    "this",
    "run",
    "run_all",
    "schema_builder",
    "schema_from_csv",
    "schema_from_dict",
    "schema_from_types",
]
