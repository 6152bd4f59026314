"""The Graph Doctor's shard and topology verdicts under a live engine mesh:
with ``PATHWAY_ENGINE_SHARDS=4`` (the port's mesh on
``PATHWAY_MESH_DEVICE=cpu``, the reference's on its virtual CPU devices)
every graph and plane case of ``test_torch_doctor.py`` gives the port the
reference's findings, compared exactly as there; ``graph-stats`` reports
the four engine shards and the plane's exchange-edge rule its sharded
severity."""

import pytest

import pathway_tpu_torch as tpw
from pathway_tpu.parallel import mesh as jmesh_mod
from pathway_tpu_torch.parallel import mesh as tmesh_mod
from test_torch_doctor import GRAPH_CASES, PLANE_CASES, _both, _fresh, _report  # noqa: F401 (autouse)


@pytest.fixture
def four_shards(monkeypatch):
    monkeypatch.setenv("PATHWAY_ENGINE_SHARDS", "4")
    monkeypatch.setenv("PATHWAY_MESH_DEVICE", "cpu")
    # the reference resolves its env once per process: let it read again
    monkeypatch.setattr(jmesh_mod, "_engine_mesh", None)
    monkeypatch.setattr(jmesh_mod, "_engine_mesh_resolved", False)
    tmesh_mod.reset_engine_mesh()
    yield
    tmesh_mod.reset_engine_mesh()


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_rules_under_four_engine_shards_equal_the_reference(case, four_shards, monkeypatch):
    build, env = GRAPH_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = _both(build)
    assert got["port"] == got["jax"]
    stats = [msg for rule, _sev, _node, msg in got["port"] if rule == "graph-stats"]
    assert stats and all("4 engine shard(s) x 1 process(es)" in m for m in stats)


@pytest.mark.parametrize("case", sorted(PLANE_CASES))
def test_plane_rules_under_four_engine_shards_equal_the_reference(case, four_shards, monkeypatch):
    build, env = PLANE_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = _both(build, plane=True)
    assert got["port"] == got["jax"]


def test_sharding_raises_the_exchange_severity(four_shards, monkeypatch):
    """The wire-codec findings on exchange edges are INFO unsharded and
    WARNING once the engine shards, in both packages."""
    build, _env = PLANE_CASES["object_exchange_key"]
    sharded = _report(tpw, build, plane=True)
    monkeypatch.delenv("PATHWAY_ENGINE_SHARDS")
    tmesh_mod.reset_engine_mesh()
    unsharded = _report(tpw, build, plane=True)
    assert {s for _r, s, _n, _m in sharded} != {s for _r, s, _n, _m in unsharded}
    assert "WARNING" in {s for _r, s, _n, _m in sharded}
