"""The Dirichlet post-fix of a kernel operator on repeat: its plane
rewrite is idempotent, so a second fix of an operator whose planes carry
it already fixes the right-hand side alone, bit for bit what rewriting
the planes again gives; a write to the planes in between makes the next
fix rewrite them."""

import pytest
import torch

from petiga_tpu_torch.assembly import assemble as tasm
from petiga_tpu_torch.core.axis import Axis
from petiga_tpu_torch.core.space import Space
from petiga_tpu_torch.models.elasticity import elasticity_system
from petiga_tpu_torch.models.poisson import poisson_system

CASES = {
    "poisson": (1, poisson_system, {"c": 0.3, "k": 1.2}),
    "elasticity": (3, elasticity_system, {"lambda": 1.0, "mu": 1.0}),
}


def _system(name):
    dof, form, ctx = CASES[name]
    sp = Space([Axis.uniform(p=2, nel=4)] * 3, dof=dof, dtype=torch.float64,
               device="cpu")
    for d in range(3):
        for side in range(2):
            for c in range(dof):
                sp.set_boundary_value(d, side, c, 0.0)
    A, _ = tasm.assemble_system(sp, form, ctx, apply_fix=False)
    b = torch.randn((sp.nnodes, dof), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    return sp, A, b


def _rewrite_always(sp, op, b):
    """The fix as it ran before it could skip: the planes rewritten on
    every call."""
    op.__dict__.pop("_dirichlet_fixed", None)
    return tasm.dirichlet_post_fix_homogeneous(sp, op, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_repeated_fix_rewrites_the_planes_once(name):
    sp, A, b = _system(name)
    op, ref = A.fast_operator(), A.fast_operator()
    _, b1 = tasm.dirichlet_post_fix_homogeneous(sp, op, b)
    _, r1 = _rewrite_always(sp, ref, b)
    assert torch.equal(op.DT, ref.DT) and torch.equal(b1, r1)
    version = op.DT._version
    _, b2 = tasm.dirichlet_post_fix_homogeneous(sp, op, 2.0 * b)
    _, r2 = _rewrite_always(sp, ref, 2.0 * b)
    assert op.DT._version == version  # no plane was written
    assert ref.DT._version > version
    assert torch.equal(op.DT, ref.DT) and torch.equal(b2, r2)


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_write_to_the_planes_makes_the_next_fix_rewrite_them(name):
    sp, A, b = _system(name)
    op, ref = A.fast_operator(), A.fast_operator()
    tasm.dirichlet_post_fix_homogeneous(sp, op, b)
    _rewrite_always(sp, ref, b)
    op.DT.mul_(2.0)
    ref.DT.mul_(2.0)
    _, b1 = tasm.dirichlet_post_fix_homogeneous(sp, op, b)
    _, r1 = _rewrite_always(sp, ref, b)
    # fixed rows hold the multiplicity again, not twice it
    assert torch.equal(op.DT, ref.DT) and torch.equal(b1, r1)
