"""The ``/generate`` route's framework-neutral pieces — counterpart of
``pathway_tpu/generate/serving.py``.

``assemble_prompt`` builds the grounded prompt (retrieved doc keys/scores
prefix the user ask) and ``is_generate_route`` names the route the router
sends to one member. ``attach_generate`` mounts the scheduler on a
``ReplicaServer``, which is not ported yet: it raises naming ROADMAP
[replication].
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch._unported import REPLICATION, unported

GENERATE_ROUTE = "/generate"


def is_generate_route(path: str) -> bool:
    # segment-exact: "/v1/generate" and "/generate/" match, a route
    # that merely ENDS in the word (e.g. "/regenerate") must not — on
    # a sharded plane a false match would divert a scatter-gather read
    # to a single member's partial corpus
    return path.rstrip("/").endswith(GENERATE_ROUTE)


def attach_generate(server: Any, scheduler: Any = None, *, route: str = GENERATE_ROUTE) -> Any:
    """The ``/generate`` route on a ``ReplicaServer``: not ported."""
    raise unported(f"generate.attach_generate (the {route} route on a ReplicaServer)", REPLICATION)


def assemble_prompt(prompt: str, matches: list) -> str:
    """Grounded prompt assembly: retrieved doc keys/scores prefix the
    user ask.  (With the bundled random-init decoder the text is not
    semantically meaningful — what matters is that the tokens fed to the
    decoder are CONDITIONED on the retrieved context: a corpus change
    changes the generation.)"""
    ctx = " ".join(f"[doc {int(k)}:{score:.3f}]" for k, score in matches)
    return f"context: {ctx}\nask: {prompt}\nanswer:" if ctx else (
        f"ask: {prompt}\nanswer:"
    )
