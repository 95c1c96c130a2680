"""Curve parameters, ops and kernel wrappers of the port."""

from .params import BLS12_377, BLS12_381, ED_ON_BLS12_377, PALLAS, WEIERSTRASS_CURVES

__all__ = ["BLS12_377", "BLS12_381", "PALLAS", "ED_ON_BLS12_377", "WEIERSTRASS_CURVES"]
