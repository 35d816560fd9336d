"""The port's distributed example (``petiga_tpu_torch/examples/distributed.py``,
2 gloo ranks on the CPU) against the JAX package's (``examples/distributed.py``,
the 8-device CPU mesh of tests/conftest.py) at the arguments of
tests/test_config.py: both return 0 and print the same results (L2 to
1e-10 relative, CG iterations within one), and the sharded checkpoint
round trip holds: the reference's loader reads the port's
checkpoint back to the reference's solution (1e-12).  Jacobi-preconditioned CG does not depend on the
partition, so the two grids solve the same problem.  (The JAX example
alone takes about 30 s on the CPU: its shard_map compiles.)"""

import numpy as np

from _torch_examples_compare import assert_same_results, out, port_main, reference_main  # noqa: F401

ARGS = ["--dim", "2", "-p", "2", "-N", "8", "--dtype", "float64", "--solver", "cg",
        "--pc", "pbjacobi", "--check-error", "1e-3"]


def test_distributed_matches_reference(tmp_path, out):
    assert reference_main("distributed")(ARGS + ["--checkpoint", str(tmp_path / "j")]) == 0
    ref = out.readouterr().out
    ck = tmp_path / "t"
    from petiga_tpu_torch.examples import distributed
    from petiga_tpu_torch.sparse import spmv

    before = dict(spmv.LAUNCHES)
    assert port_main("distributed")(ARGS + ["--checkpoint", str(ck), "--nranks", "2",
                                            "--device", "cpu"]) == 0
    got = out.readouterr().out
    # the ranks' results stay with the example; this process's counts are its own
    assert [sorted(r) for r in distributed.RANKS] == [["err", "launches", "text"], ["launches"]]
    assert spmv.LAUNCHES == before
    assert_same_results(got, ref)
    assert "device mesh: (1, 2) over 2 ranks (gloo, cpu)" in got
    assert f"sharded checkpoint round trip ok: {ck}" in got
    assert sorted(p.name for p in ck.iterdir()) == [
        "U.meta.json", "U.shard00000.npy", "U.shard00001.npy"]
    # the two solutions, both read back by the reference's loader
    from petiga_tpu.io.sharded import load_sharded

    np.testing.assert_allclose(load_sharded(str(ck), "U"),
                               load_sharded(str(tmp_path / "j"), "U"), rtol=0, atol=1e-12)
