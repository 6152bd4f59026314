"""pw.viz — table visualization helpers, the port's own copy of
``pathway_tpu/stdlib/viz`` (upstream: stdlib/viz/ — Bokeh live plots in
plotting.py, DataFrame-styled table snapshots in table_viz.py). pandas,
rich and bokeh are imported inside the functions that use them: ``plot``
refuses where bokeh is missing, ``show`` prints through rich where it is
installed and through ``pw.debug.compute_and_print`` otherwise.
"""

from __future__ import annotations

from typing import Any, Callable


def table_viz(table: Any, **kwargs: Any):
    """Render the table's current static result as a DataFrame
    (upstream: stdlib/viz/table_viz.py)."""
    from pathway_tpu_torch.debug import table_to_pandas

    return table_to_pandas(table, include_id=False)


def show(table: Any, **kwargs: Any) -> None:
    """Print the table's current result (a rich table where rich and
    pandas are installed)."""
    try:
        from rich.console import Console
        from rich.table import Table as RichTable

        df = table_viz(table)
        rt = RichTable()
        for c in df.columns:
            rt.add_column(str(c))
        for _idx, row in df.iterrows():
            rt.add_row(*[str(v) for v in row])
        Console().print(rt)
    except ImportError:
        from pathway_tpu_torch.debug import compute_and_print

        compute_and_print(table, include_id=False)


def plot(table: Any, plotting_function: Callable | None = None, **kwargs: Any):
    """Bokeh plot of a table's computed result (upstream:
    stdlib/viz/plotting.py). Requires `bokeh`."""
    try:
        import bokeh  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "pw.viz.plot requires bokeh, which is not installed in this "
            "environment; use pw.viz.show / pw.live(table).to_pandas instead"
        ) from e
    df = table_viz(table)
    if plotting_function is not None:
        return plotting_function(df)
    from bokeh.plotting import figure

    return figure()
