"""The port's builder call of `ecdsa-secp256k1-b1`: `build_ecdsa(batch)`
under the named circuit config -> (builder, its input targets in order)."""


def build(circuit: dict):
    from plonky2_tpu_torch.bench import build_ecdsa
    from plonky2_tpu_torch.ir import CircuitConfig
    b, inputs, _ = build_ecdsa(circuit["batch"],
                               getattr(CircuitConfig, circuit["circuit_config"])())
    return b, list(inputs)
