"""One place for the ``NotImplementedError`` of every reference hook the
port does not carry yet. Each message names the tag of the ``ROADMAP.md``
item that will port it, so nothing falls back silently to a different
behaviour."""

from __future__ import annotations

COMPILED_TICKS = "[compiled-ticks] (compiled ticks)"
MESH = "[mesh] (multi-device: engine mesh, DCN, sharded top-k)"
REPLICATION = "[replication] (parallel/standby.py and parallel/supervisor.py)"
OBSERVABILITY = "[observability] (the rest of observability)"
STDLIB_REST = "[stdlib-rest] (graphs, viz)"

# subpackages of the reference the port lacks, with their item
PACKAGE_NAMES = {"analysis": OBSERVABILITY, "autoscale": MESH}

# ``pw.stdlib.<name>`` the port lacks (each is a root name too)
STDLIB_NAMES = {
    "graphs": STDLIB_REST,
    "viz": STDLIB_REST,
}

# root names of the reference the port lacks, each with its item
ROOT_NAMES = {
    **STDLIB_NAMES,
    **PACKAGE_NAMES,
}


def unported(what: str, item: str) -> NotImplementedError:
    """The error to raise for ``what``, naming the ROADMAP ``item``."""
    return NotImplementedError(
        f"{what} is not ported to pathway_tpu_torch yet (ROADMAP {item})"
    )


def package_getattr(package: str, names: dict[str, str]):
    """A package's module ``__getattr__``: each reference name in ``names``
    (name -> item) raises naming its item; any other name stays an
    ``AttributeError``."""

    def __getattr__(name: str):
        if name in names:
            raise unported(f"{package}.{name}", names[name])
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    return __getattr__
