"""Example field moduli of the field tests: the same ``EXAMPLE_FIELDS`` as
``msm_zprize_tpu/curves/example_fields.py`` (pasta, BLS12, 25519,
secp256k1, goldilocks, babybear; published constants), its curve entries
taken from the port's own ``curves/params.py``.
"""

__all__ = ["EXAMPLE_FIELDS"]

from .params import BLS12_377, BLS12_381, PALLAS

EXAMPLE_FIELDS = {
    "pasta-fp": PALLAS.modulus,
    "pasta-fq": PALLAS.order,
    "bls12-377-fp": BLS12_377.modulus,
    "bls12-377-fq": BLS12_377.order,
    "bls12-381-fp": BLS12_381.modulus,
    "bls12-381-fq": BLS12_381.order,
    "ed25519-fp": (1 << 255) - 19,
    "secp256k1-fp": (1 << 256) - (1 << 32) - 977,
    "secp256k1-fq": 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    "goldilocks": (1 << 64) - (1 << 32) + 1,
    "babybear": (1 << 31) - (1 << 27) + 1,
}
