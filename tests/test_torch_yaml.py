"""``pw.load_yaml`` of the port against the JAX package's: both packages
read the same YAML text, whose only difference is the module prefix of
each ``$class`` path, so the port's instances come from
``pathway_tpu_torch`` and it never imports the JAX package. Cases:
``$class`` (with nested mappings and lists), ``$ref`` to an earlier key, a
stream and a path, a document that is not a mapping, and an unresolved
``$ref`` raising ``ValueError`` in both. What each builds compares equal:
class names, attributes and what a built splitter makes of a text."""

import io

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

PACKAGES = {"jax": jpw, "port": tpw}

APP = """
splitter:
  $class: {pkg}.xpacks.llm.splitters.TokenCountSplitter
  min_tokens: 3
  max_tokens: 7
hmm:
  $class: {pkg}.stdlib.ml.hmm.DenseHMM
  states: [rain, sun]
  initial: {{rain: 0.25, sun: 0.75}}
same_splitter:
  $ref: splitter
pipeline:
  steps:
    - $ref: splitter
    - $ref: hmm
  name: demo
  sizes: [1, 2, 3]
"""

TEXT = "one two three four five six seven eight nine ten eleven twelve. thirteen"


def _describe(app):
    """What a loaded app holds, in a form both packages' compare equal in."""
    splitter, hmm = app["splitter"], app["hmm"]
    return {
        "classes": [type(splitter).__name__, type(hmm).__name__],
        "splitter": (splitter.min_tokens, splitter.max_tokens, splitter.split(TEXT)),
        "hmm": (hmm.states, hmm.initial, hmm.log_initial("sun")),
        "same": app["same_splitter"] is splitter,
        "steps": [s is o for s, o in zip(app["pipeline"]["steps"], (splitter, hmm))],
        "rest": (app["pipeline"]["name"], app["pipeline"]["sizes"]),
    }


def _load(pw, how, tmp_path):
    text = APP.format(pkg=pw.__name__)
    if how == "text":
        return pw.load_yaml(text)
    if how == "stream":
        return pw.load_yaml(io.StringIO(text))
    path = tmp_path / f"{pw.__name__}.yaml"
    path.write_text(text)
    return pw.load_yaml(str(path))


@pytest.mark.parametrize("how", ["text", "stream", "path"])
def test_load_yaml_class_and_ref(how, tmp_path):
    got = _load(tpw, how, tmp_path)
    want = _load(jpw, how, tmp_path)
    assert type(got["splitter"]).__module__.startswith("pathway_tpu_torch.")
    assert type(got["hmm"]).__module__.startswith("pathway_tpu_torch.")
    assert _describe(got) == _describe(want)
    assert _describe(got)["same"] and all(_describe(got)["steps"])


def test_load_yaml_plain_values():
    for doc in ("- 1\n- two\n", "just text", "a: {b: [1, {c: 2}]}"):
        assert tpw.load_yaml(doc) == jpw.load_yaml(doc)


@pytest.mark.parametrize("pw", [tpw, jpw], ids=["port", "jax"])
def test_load_yaml_unresolved_ref_raises(pw):
    with pytest.raises(ValueError, match="unresolved \\$ref: nowhere"):
        pw.load_yaml("a:\n  $ref: nowhere\n")


def test_load_yaml_without_yaml_raises_import_error(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="pyyaml is required"):
        tpw.load_yaml("a: 1")
