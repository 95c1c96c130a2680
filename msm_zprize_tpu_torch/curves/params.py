"""Curve parameters of the port: the published BLS12-377 G1, BLS12-381 G1,
Pallas and ed-on-bls12-377 constants.

The port carries its own copy so that it, and any script that drives it,
needs nothing of the JAX package. The values equal
``msm_zprize_tpu/curves/params.py::BLS12_377``, ``BLS12_381``, ``PALLAS``
and ``ED_ON_BLS12_377`` field for field (checked in
``tests/test_torch_msm.py``, ``tests/test_torch_edwards.py`` and
``tests/test_torch_bls12_381_pallas.py``); any object with the same attributes,
the JAX package's parameter classes included, is accepted wherever the port
takes curve parameters.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "WeierstrassParams", "EdwardsParams", "BLS12_377", "BLS12_381", "PALLAS", "ED_ON_BLS12_377",
    "WEIERSTRASS_CURVES",
]


@dataclass(frozen=True)
class WeierstrassParams:
    """y^2 = x^3 + b over F_p (a = 0), prime-order subgroup of order q,
    with the GLV endomorphism (x, y) -> (beta x, y) acting as lambda."""

    label: str
    modulus: int  # p, base field
    order: int  # q, scalar field (subgroup order)
    cofactor: int
    b: int
    generator: tuple[int, int]
    lambda_: int | None = None
    beta: int | None = None


@dataclass(frozen=True)
class EdwardsParams:
    """-x^2 + y^2 = 1 + d x^2 y^2 over F_p (a = -1), prime-order subgroup of
    order q generated by ``generator``."""

    label: str
    modulus: int  # p, base field
    order: int  # q, scalar field (subgroup order)
    cofactor: int
    d: int
    generator: tuple[int, int]


BLS12_377 = WeierstrassParams(
    label="bls12-377",
    modulus=0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001,
    order=0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001,
    cofactor=0x170B5D44300000000000000000000000,
    b=1,
    generator=(
        0x008848DEFE740A67C8FC6225BF87FF5485951E2CAA9D41BB188282C8BD37CB5CD5481512FFCD394EEAB9B16EB21BE9EF,
        0x01914A69C5102EFF1F674F5D30AFEEC4BD7FB348CA3E52D96D182AD44FB82305C2FE3D3634A9591AFD82DE55559C8EA6,
    ),
    lambda_=0x12AB655E9A2CA55660B44D1E5C37B00114885F32400000000000000000000000,
    beta=0x1AE3A4617C510EABC8756BA8F8C524EB8882A75CC9BC8E359064EE822FB5BFFD1E945779FFFFFFFFFFFFFFFFFFFFFFF,
)

# y^2 = x^3 + 4; lambda = z^2 - 1 for the curve parameter -z = 0xD201000000010000
BLS12_381 = WeierstrassParams(
    label="bls12-381",
    modulus=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    order=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    cofactor=0x396C8C005555E1568C00AAAB0000AAAB,
    b=4,
    generator=(
        0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
        0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    ),
    lambda_=0xD201000000010000**2 - 1,
    beta=0x1A0111EA397FE699EC02408663D4DE85AA0D857D89759AD4897D29650FB85F9B409427EB4F49FFFD8BFD00000000AAAC,
)

# y^2 = x^3 + 5 over p = 2^254 + ~2^125; lambda = 5^((q-1)/3) mod q and
# beta = (5^((p-1)/3))^2 mod p, derived here as the JAX package derives them
_p_pallas = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
_q_pallas = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001
PALLAS = WeierstrassParams(
    label="pallas",
    modulus=_p_pallas,
    order=_q_pallas,
    cofactor=1,
    b=5,
    generator=(1, 0x1B74B5A30A12937C53DFA9F06378EE548F655BD4333D477119CF7A23CAED2ABB),
    lambda_=pow(5, (_q_pallas - 1) // 3, _q_pallas),
    beta=pow(pow(5, (_p_pallas - 1) // 3, _p_pallas), 2, _p_pallas),
)

# base field: BLS12-377's scalar field
ED_ON_BLS12_377 = EdwardsParams(
    label="ed-on-bls12-377",
    modulus=BLS12_377.order,
    order=0x4AAD957A68B2955982D1347970DEC005293A3AFC43C8AFEB95AEE9AC33FD9FF,
    cofactor=4,
    d=3021,
    generator=(
        0x9F1B5A5BAF6ACF06FED91C9AE9EBFA06068DD2835790980894E2328F3EBCA05,
        0x9A20DF36571AC3CD906B256080BA8454453C177AAF3131BB50A67BF1A806781,
    ),
)

WEIERSTRASS_CURVES = {c.label: c for c in (BLS12_377, BLS12_381, PALLAS)}
