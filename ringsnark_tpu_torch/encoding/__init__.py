"""Linear-only homomorphic encodings E(.) — batched symmetric BGV over RNS."""

from .context import EncodingContext, SecretKey, keygen  # noqa: F401
from .encoding import (  # noqa: F401
    Encoding, DecodingError, encode, decode, inner_product, mac_accumulate, finish_inner_product,
)
