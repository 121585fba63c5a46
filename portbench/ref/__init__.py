"""A frozen plain copy of the port's prover: the benchmark's reference.

The modules below are copies of the port's own (`field`, `hashes`, `ntt`,
`merkle`, `transcript`, `fri`, `ir`, `gates`, `witness`, `gadgets`, `smt`,
`prove`, `serialization`, `utils`), kept here so that a later change to the
port cannot move the yardstick it is measured by.  Every path is plain
PyTorch or Python on whichever device its tensors live on:

* the Poseidon permutation under every Merkle tree and the grind is
  `permute_cols_plain` (the port runs its CUDA kernel K1 there);
* every LDE is the plain iNTT + coset NTT (the port: kernels K2 and K3);
* the witness is the dynamic scheduler `generate_witness` over the
  circuit's generators, then each gate's batched aux fill (the port: the
  native tape), the Poseidon rows' internal wires from the plain
  permutation's rounds (the port: a C++ row engine).

It imports torch and numpy and nothing of the port, of JAX or of the JAX
package.  For the same circuit and inputs it gives the port's
`serialize_proof` bytes, which are the JAX package's.
"""
