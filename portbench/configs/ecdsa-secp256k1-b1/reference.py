"""The reference's builder call of `ecdsa-secp256k1-b1`: its copy of
`build_ecdsa(batch)` under the named circuit config -> (builder, its input
targets in order)."""


def build(circuit: dict):
    from portbench.ref.circuits import build_ecdsa
    from portbench.ref.ir import CircuitConfig
    b, inputs, _ = build_ecdsa(circuit["batch"],
                               getattr(CircuitConfig, circuit["circuit_config"])())
    return b, list(inputs)
