"""A digest of a circuit builder's graph before its build.

Two builders with the same digest compile to the same arrays, so a circuit
too large to build in a test is held against the JAX package's by this
digest alone (the fixture generator, `scripts/make_torch_port_vectors.py`,
takes it of the JAX builder; the tests and `chip_smoke.py` of the port's).
It reads only what both builders keep alike (`gate_instances`,
`public_inputs`, the union-find `_parent`, and the lookup tables and uses
that `build()` turns into rows), so it takes either.
"""

from __future__ import annotations

import hashlib
import json


def graph_digest(builder) -> str:
    """sha256 of the builder's graph before `build()`: every row's gate key
    and constants, the public inputs, the copy classes (each class its
    members' reprs, sorted) and, where the builder has lookup tables, each
    table's pairs and its (input, output) uses in order."""
    # The builder's `_parent` is a union-find forest; its roots are found
    # here with memoised paths (the builder's `_find` compresses one link a
    # call, which is quadratic on the long chains of a 2^16-row circuit).
    parent, root = builder._parent, {}

    def find(x):
        path = []
        while x not in root and x in parent:
            path.append(x)
            x = parent[x]
        r = root.get(x, x)
        for y in path:
            root[y] = r
        return r

    classes: dict = {}
    for t in set(parent) | set(parent.values()):
        classes.setdefault(find(t), []).append(repr(t))
    graph = {
        "rows": [[g.key(), [int(c) for c in cs]]
                 for g, cs in builder.gate_instances],
        "public_inputs": [repr(t) for t in builder.public_inputs],
        "copy_classes": sorted(sorted(c) for c in classes.values()),
    }
    tables = getattr(builder, "_lookup_tables", None)
    if tables:
        graph["lookup_tables"] = [[[int(a), int(b)] for a, b in t] for t in tables]
        graph["lookup_uses"] = [[[repr(x), repr(y)] for x, y in u]
                                for u in builder._lookup_uses]
    raw = json.dumps(graph, separators=(",", ":"), default=repr)
    return hashlib.sha256(raw.encode()).hexdigest()
