"""Curve parameters of the port: the published BLS12-377 G1 constants.

The port carries its own copy so that it, and any script that drives it,
needs nothing of the JAX package. The values equal
``msm_zprize_tpu/curves/params.py::BLS12_377`` field for field (checked in
``tests/test_torch_curve.py``); any object with the same attributes, the JAX
package's ``WeierstrassParams`` included, is accepted wherever the port
takes curve parameters.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["WeierstrassParams", "BLS12_377"]


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
