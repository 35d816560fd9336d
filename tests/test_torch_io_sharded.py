"""Sharded checkpoints (``petiga_tpu_torch.io.sharded``) across packages,
f64 on the CPU, four gloo ranks.

The JAX package writes a seeded dof-2 vector under pgrid (2, 2); the
port's ranks (``tests/_torch_dist_cases.py`` ``io_cases``) write the same
vector under pgrid (2, 2), reload it serially, onto pgrid (4, 1) and onto
a 2-rank subgroup, and read the JAX package's checkpoint onto (1, 4).
The JAX package's ``load_sharded(ds=None)`` reads what the port wrote,
and the two checkpoints — manifest and shard files — are equal byte for
byte, as are their PetIGA binary conversions.  Every reload is exact.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import _torch_dist_cases as cases
from petiga_tpu.core.axis import Axis as JAxis
from petiga_tpu.core.space import Space as JSpace
from petiga_tpu.io import sharded as jsh
from petiga_tpu.parallel.dist import DistSpace as JDistSpace
from petiga_tpu_torch.core.axis import Axis
from petiga_tpu_torch.core.space import Space
from petiga_tpu_torch.io import sharded as tsh
from petiga_tpu_torch.parallel.launch import launch


def _vector():
    sp = JSpace([JAxis.uniform(p=2, nel=7) for _ in range(2)], dof=2, dtype=jnp.float64)
    return sp, np.random.default_rng(2).normal(size=(sp.nnodes, 2))


@pytest.fixture(scope="module")
def io(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    torch_dir, jax_dir = str(root / "torch"), str(root / "jax")
    sp, U = _vector()
    ds = JDistSpace(sp, devices=jax.devices()[:4], pgrid=(2, 2))
    jsh.save_sharded(ds, jnp.asarray(U), jax_dir, "U")
    res = launch(cases.io_cases, 4, (torch_dir, jax_dir), backend="gloo", init_timeout=60.0,
                 timeout=240.0)[0]
    return {"res": res, "torch": torch_dir, "jax": jax_dir, "U": U, "space": sp}


@pytest.mark.parametrize("case", ["serial", "repartitioned", "subgroup", "from_jax"])
def test_reload_is_exact(io, case):
    np.testing.assert_array_equal(io["res"][case], io["U"])


def test_jax_reads_the_port_checkpoint(io):
    np.testing.assert_array_equal(jsh.load_sharded(io["torch"], "U"), io["U"])


def test_checkpoints_equal_byte_for_byte(io):
    names = sorted(os.listdir(io["jax"]))
    assert names == sorted(os.listdir(io["torch"]))
    assert "U.meta.json" in names and len(names) == 5
    for name in names:
        with open(os.path.join(io["jax"], name), "rb") as f, \
                open(os.path.join(io["torch"], name), "rb") as g:
            assert f.read() == g.read(), name


def test_petiga_binary_conversion(io, tmp_path):
    tsp = Space([Axis.uniform(p=2, nel=7) for _ in range(2)], dof=2, device="cpu")
    tsh.sharded_to_petiga_binary(io["torch"], tsp, str(tmp_path / "t.dat"))
    jsh.sharded_to_petiga_binary(io["jax"], io["space"], str(tmp_path / "j.dat"))
    assert (tmp_path / "t.dat").read_bytes() == (tmp_path / "j.dat").read_bytes()


def test_mismatched_space_raises(io):
    assert io["res"]["mismatch"] is not None and "does not match" in io["res"]["mismatch"]
