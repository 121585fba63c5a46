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
    # The builder's `_parent` is a union-find forest (the JAX builder's
    # `_find` compresses one link a call, so its chains are long): each
    # key's root is found once, its path memoised, in one loop (a batch-20
    # ECDSA builder has about 24 M keys).
    parent, root = builder._parent, {}
    for t in parent:
        if t in root:
            continue
        path, x = [t], parent[t]
        while x in parent and x not in root:
            path.append(x)
            x = parent[x]
        r = root.get(x, x)
        for y in path:
            root[y] = r
    classes: dict = {}
    for t, r in root.items():
        classes.setdefault(r, []).append(repr(t))
    for r in set(root.values()):             # the roots, members of their classes
        classes[r].append(repr(r))
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
