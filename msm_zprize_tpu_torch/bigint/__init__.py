"""Pure-Python host math of the port: field inverse and square root, and the
affine short-Weierstrass and extended twisted-Edwards group laws, enough to
draw random curve points on the host (``random_points_fast``'s bases).

The port's own copy of the parts of ``msm_zprize_tpu/bigint`` it needs,
with the same names and the same draws from a ``random.Random``, so the same
seed gives the same points in both packages.
"""
