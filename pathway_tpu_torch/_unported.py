"""One place for the ``NotImplementedError`` of every reference hook the
port does not carry yet. Each message names the tag of the ``ROADMAP.md``
item that will port it, so nothing falls back silently to a different
behaviour."""

from __future__ import annotations

MESH = "[mesh] (multi-process: host mesh, DCN execs, spawn, elastic, autoscale)"
REPLICATION = "[replication] (parallel/standby.py and parallel/supervisor.py)"

# root names of the reference the port lacks (subpackages), each with its item
ROOT_NAMES = {"autoscale": MESH}


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
