"""The port's builder call of `smt-process-d32-x51`:
`build_smt_process(degree_bits, n_levels)` under the named circuit config
-> (builder, its input targets in order)."""


def build(circuit: dict):
    from plonky2_tpu_torch.bench import build_smt_process
    from plonky2_tpu_torch.ir import CircuitConfig
    b, inputs, _ = build_smt_process(circuit["degree_bits"], circuit["n_levels"],
                                     getattr(CircuitConfig, circuit["circuit_config"])())
    return b, list(inputs)
