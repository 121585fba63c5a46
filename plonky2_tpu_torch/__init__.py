"""plonky2_tpu_torch — the Plonky2-class prover of `plonky2_tpu`, ported to
PyTorch and CUDA for an NVIDIA H100.

The JAX package `plonky2_tpu` is the reference: for the same circuit and
inputs this package produces the same `serialize_proof` bytes, and each
package verifies the other's proofs.  It imports
torch and numpy, never JAX, and nothing of `plonky2_tpu`.

Field tensors are `torch.int64` holding the u64 bit pattern of a canonical
Goldilocks element.  Entry points run on the card unless the caller asks
for the CPU: `CircuitBuilder.build()` (and `compile_circuit`, `fri.grind`)
place their tensors on `cuda` by default and raise when there is no card;
`build(device="cpu")` places a circuit on the CPU.  `prove` runs where the
circuit lives, and every function runs on the device of the tensors it is
given.  The TPU's Pallas kernels are hand-written CUDA (`csrc/`), built with
nvcc at first use (`_build.py`):

    K1  hashes/cuda_poseidon.py   Poseidon permutation       (csrc/poseidon.cu)
    K2  ntt/cuda_lde.py           values -> coeffs + LDE,    (csrc/lde.cu)
                                  n <= 2^13, bit-reversed or natural order
    K3  ntt/cuda_lde_tiled.py     the same, bit-reversed,    (csrc/lde_tiled.cu)
                                  2^14 <= n <= 2^20, four-step

On a CPU tensor the kernels' dispatchers run their plain torch versions
instead.

Layout (mirrors plonky2_tpu/):
    field/      Goldilocks and its quadratic extension
    hashes/     Poseidon (scalar, plain tensor, kernel K1)
    ntt/        NTT / coset LDE (plain tensor, kernels K2 and K3)
    merkle/     cap-rooted Merkle trees
    transcript/ Fiat-Shamir challenger
    fri/        FRI prover and host verifier
    ir/         CircuitBuilder, config
    gates/      arithmetic, constant, public-input, noop, Poseidon, base-sum,
                u32 arithmetic / add-many / range-check / subtraction,
                comparison and interleave gates
    witness/    witness generation: the static tape (the prover's path) and
                the dynamic scheduler (its reference)
    native/     C++ witness kernels (tape executor, Poseidon rows), g++ at
                first use
    smt/        native sparse Merkle tree (witnesses of the SMT circuits)
    gadgets/    SMT inclusion / process-proof circuits, u32 / B32 gadgets
    prove/      compile, prover and verifier (host)
    serialization/  proof, verifier-key and prover-data bytes, both ways
    bench/      config-1, -2 and -3 circuits; device profile of a prove
    convert.py  numpy <-> tensor bridges to the JAX package's arrays
"""

__version__ = "0.1.0"
