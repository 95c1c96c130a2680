"""Differential-equivalence harness: a host reference function and a port
implementation on the same random inputs, the values mapped through each
spec's ``there`` / ``back`` codecs and compared exactly, and BOTH sides
required to throw together.

Mirror of ``msm_zprize_tpu/testing/equivalent.py``: ``Spec``, ``id_spec``,
``field_spec`` (ints <-> (n, batch) Montgomery limb tensors) and
``scalar_spec`` (ints <-> plain scalar limbs), and ``equivalent``. The
port's specs build torch tensors on ``device``, by default the card
(``parallel/api.py``'s ``DEVICE``, as the JAX harness places its values on
the default accelerator): ``"cuda"`` runs the kernels (K1 and K8 through
``MontgomeryFp``), ``"cpu"`` the plain twins.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..parallel.api import DEVICE
from .property import MAX_RUNS, MIN_RUNS, test_property
from .random_gen import Random

__all__ = ["Spec", "equivalent", "field_spec", "scalar_spec", "id_spec"]


@dataclass
class Spec:
    rng: Random | None  # None for output-only specs
    there: Callable[[Any], Any]  # host value -> port value
    back: Callable[[Any], Any]  # port value -> host value


def id_spec(rng: Random | None = None) -> Spec:
    return Spec(rng, lambda v: v, lambda v: v)


def _same_lanes(vals):
    assert all(v == vals[0] for v in vals), f"lanes disagree: {vals}"
    return vals[0]


def field_spec(F, rng: Random | None = None, montgomery: bool = True, batch: int = 1,
               device=DEVICE) -> Spec:
    """Values cross as (n, batch) limb tensors on ``device``, every lane the
    same value (a batched implementation must be exact in every lane)."""

    def there(v: int):
        return torch.as_tensor(F.pack([v] * batch, montgomery=montgomery), device=device)

    return Spec(rng, there, lambda arr: _same_lanes(F.unpack(arr, montgomery=montgomery)))


def scalar_spec(S, rng: Random | None = None, batch: int = 1, device=DEVICE) -> Spec:
    def there(v: int):
        return torch.as_tensor(S.pack([v] * batch), device=device)

    return Spec(rng, there, lambda arr: _same_lanes(S.unpack(arr)))


def equivalent(*, frm: list[Spec], to: Spec, seed: int = 0, min_runs: int = MIN_RUNS,
               max_runs: int = MAX_RUNS, label: str = ""):
    """equivalent(frm=[specs], to=spec)(f_ref, f_impl): a property check that
    ``to.back(f_impl(*there(xs))) == f_ref(*xs)``; where the reference
    throws, the implementation must throw too."""

    def run(f_ref, f_impl):
        gens = [s.rng for s in frm]
        assert all(g is not None for g in gens), "input specs need generators"

        @test_property(*gens, seed=seed, min_runs=min_runs, max_runs=max_runs)
        def prop(*xs):
            ref_err = None
            try:
                want = f_ref(*xs)
            except (AssertionError, ValueError, ZeroDivisionError, ArithmeticError) as e:
                ref_err = e
            args = [s.there(x) for s, x in zip(frm, xs)]
            if ref_err is not None:
                try:
                    f_impl(*args)
                except Exception:
                    return  # both threw
                raise AssertionError(f"{label}: reference threw ({ref_err!r}) but impl succeeded")
            got = to.back(f_impl(*args))
            assert got == want, f"{label}: {got} != {want}"

        return prop

    return run
