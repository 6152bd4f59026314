"""The Table API and the values it carries — counterpart of
``pathway_tpu/internals/__init__.py``, exporting the same names for what is
ported (the interactive ``LiveTable`` and the YAML loader are not;
``iterate``, SQL and the row transformers are modules of their own here as
in the reference)."""

from pathway_tpu_torch.internals import dtype
from pathway_tpu_torch.internals.api import (
    PathwayType,
    PersistenceMode,
    Pointer,
    PyObjectWrapper,
    wrap_py_object,
)
from pathway_tpu_torch.internals.common import (
    apply,
    apply_async,
    apply_with_type,
    cast,
    coalesce,
    declare_type,
    fill_error,
    if_else,
    make_tuple,
    require,
    unwrap,
)
from pathway_tpu_torch.internals.datetime_types import DateTimeNaive, DateTimeUtc
from pathway_tpu_torch.internals.errors import global_error_log, local_error_log
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.groupbys import GroupedJoinResult, GroupedTable
from pathway_tpu_torch.internals.joins import JoinMode, JoinResult
from pathway_tpu_torch.internals.json import Json
from pathway_tpu_torch.internals.run import MonitoringLevel, run, run_all
from pathway_tpu_torch.internals.schema import (
    Schema,
    SchemaProperties,
    assert_table_has_schema,
    column_definition,
    schema_builder,
    schema_from_csv,
    schema_from_dict,
    schema_from_types,
)
from pathway_tpu_torch.internals.table import (
    Joinable,
    Table,
    TableLike,
    groupby,
    join,
    join_inner,
    join_left,
    join_outer,
    join_right,
)
from pathway_tpu_torch.internals.thisclass import left, right, this
from pathway_tpu_torch.internals.udfs import UDF, udf

__version__ = "0.1.0"


def __getattr__(name: str):
    # Duration subclasses pandas' Timedelta: built (and pandas imported)
    # only when asked for
    if name == "Duration":
        from pathway_tpu_torch.internals import datetime_types

        return datetime_types.Duration
    raise AttributeError(name)
