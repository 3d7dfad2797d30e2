"""DoublePIR: plain 32-bit integer-LWE PIR (reference: lib/doublepir).

All ciphertext arithmetic is mod 2^32. The host plane (numpy) here is the
oracle and the client, a copy of the JAX package's; the server's big
products (hint build DB*A1, online answer matvecs) run on the card through
the CUDA kernels bound in ``kernels`` (wrapping u32 products, csrc/
dp_matmul_u32.cu) and ``server_torch`` (int8 DB products, csrc/dp_dot_i8.cu).
"""

from .params import Params, pick_params
from .database import Db, DbInfo
from . import scheme

__all__ = ["Params", "pick_params", "Db", "DbInfo", "scheme"]
