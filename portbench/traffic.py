"""The one traffic generator: it reads a mix's parameters
(`traffic/<name>.json`) and drives the prover with them.

A mix today is a closed loop: `clients` callers (1), each with at most
`in_flight` proofs outstanding (1), each proof on the next inputs of the
pool that the configuration's input maker drew from the seed (`inputs`:
`fresh`).  The window closes to new proofs after `seconds`; the proof in
flight then runs to its end, and the window's wall ends with it.
"""

from __future__ import annotations

import sys
import time
import traceback

SUPPORTED = {"loop": "closed", "clients": 1, "in_flight": 1, "inputs": "fresh"}


def check(mix: dict) -> None:
    for key, value in SUPPORTED.items():
        if mix.get(key) != value:
            raise ValueError(f"traffic {key}={mix.get(key)!r}: this generator runs "
                             f"{key}={value!r}")


class Pool:
    """The inputs drawn from the seed, handed out in turn."""

    def __init__(self, values: list):
        self.values = values
        self.next = 0

    def take(self):
        i = self.next % len(self.values)
        self.next += 1
        return i, self.values[i]


def closed_loop(seconds: float, prove, pool: Pool, clock=time.perf_counter):
    """The mix that `check` passes: one client, one proof in flight ->
    (records [(pool index, start, end, output or None, the process's CPU
    seconds)], wall seconds).  At least one proof runs; a proof that raises
    is recorded with output None and its traceback printed on stderr."""
    records = []
    t0 = clock()
    while not records or clock() - t0 < seconds:
        i, values = pool.take()
        start, cpu = clock(), time.process_time()
        try:
            out = prove(values)
        except Exception:                 # a failed request: counted, the loop goes on
            traceback.print_exc(file=sys.stderr)
            out = None
        records.append((i, start, clock(), out, time.process_time() - cpu))
    return records, records[-1][2] - t0
