"""Expression namespaces (``.num``, ``.str``, ``.bin``) — counterpart of
``pathway_tpu/internals/expressions``. ``expression.py`` imports each
submodule when its namespace is first used. The ``.dt`` namespace is not
ported (it raises, ROADMAP [temporal])."""
