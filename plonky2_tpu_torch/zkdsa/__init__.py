from .account import (Account, Address, private_key_to_account,  # noqa: F401
                      private_key_to_public_key, public_key_to_address)
from .gadgets import (AddressTarget, SimpleSignatureTarget,  # noqa: F401
                      verify_simple_signature)
from .circuits import (SimpleSignatureCircuit,  # noqa: F401
                       SimpleSignaturePublicInputs,
                       make_simple_signature_circuit)
