"""pir_tpu — a single-server computational PIR framework on JAX.

A from-scratch JAX/XLA implementation of SealPIR-style private information
retrieval (reference capability surface: OpenMined/PIR, a C++17 library on
Microsoft SEAL 3.5.6).  Unlike the reference, *all* BFV/RNS polynomial
arithmetic — negacyclic NTT/INTT, 64-bit modular multiply, Galois
automorphisms, key switching — is implemented here, served on a GPU:

* ciphertexts are dense ``uint64[size, L, N]`` arrays (RNS limb-major),
* every protocol op is a pure jittable function over those arrays,
* the server hot path (oblivious query expansion + ciphertext×database scan)
  is batched and shardable over a ``jax.sharding.Mesh`` (DB rows × RNS limbs),
* the client↔server contract is the same protobuf schema as the reference
  (see ``pir_tpu/proto/payload.proto``).

64-bit integer mode is required: moduli are up to 61 bits and all modular
arithmetic runs on uint64 lanes.
Importing this package enables ``jax_enable_x64``.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

from pir_tpu.core.params import (  # noqa: E402
    EncryptionParams,
    PirParams,
    generate_encryption_params,
    create_pir_parameters,
)
from pir_tpu.core.context import PirContext  # noqa: E402
from pir_tpu.pir.client import PirClient  # noqa: E402
from pir_tpu.pir.server import PirServer  # noqa: E402
from pir_tpu.pir.database import PirDatabase  # noqa: E402

__all__ = [
    "EncryptionParams",
    "PirParams",
    "PirContext",
    "PirClient",
    "PirServer",
    "PirDatabase",
    "generate_encryption_params",
    "create_pir_parameters",
]

__version__ = "0.1.0"
