"""The port's testing library: the property runner, the generators and the
equivalence harness (mirror of ``msm_zprize_tpu/testing``), beside the
port's own oracles and helpers (``points``, ``bounds``, ``mesh_ranks``,
``xdist_replay``, ``k2_turns``)."""

from .equivalent import Spec, equivalent
from .property import test_property
from .random_gen import Random

__all__ = ["test_property", "Random", "equivalent", "Spec"]
