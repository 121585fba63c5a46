"""The reference's builder call of `smt-process-d32-x51`: its copy of
`build_smt_process(degree_bits, n_levels)` under the named circuit config
-> (builder, its input targets in order)."""


def build(circuit: dict):
    from portbench.ref.circuits import build_smt_process
    from portbench.ref.ir import CircuitConfig
    b, inputs, _ = build_smt_process(circuit["degree_bits"], circuit["n_levels"],
                                     getattr(CircuitConfig, circuit["circuit_config"])())
    return b, list(inputs)
