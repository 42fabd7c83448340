"""The port's main path as a whole against the JAX package: the registry,
``host_api`` and the kernels' shape rule, plus the pinned copies of the
JAX package's NumPy helpers and the rule that the port imports no JAX.

Inputs are NumPy draws cast to float32 explicitly (the suite runs JAX with
x64 on).  Tolerances are max-norm relative differences.
"""

import copy
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import cuda_matrix_inversion_tpu as jax_package
import cuda_matrix_inversion_tpu_torch as port
from cuda_matrix_inversion_tpu.bench import reporting as jax_reporting
from cuda_matrix_inversion_tpu.io import fixtures as jax_fixtures
from cuda_matrix_inversion_tpu.io import replicate as jax_replicate
from cuda_matrix_inversion_tpu import types as jax_types
from cuda_matrix_inversion_tpu.ops import host_api as jax_host_api
from cuda_matrix_inversion_tpu.ops import registry as jax_registry
from cuda_matrix_inversion_tpu.ops import xla as jax_xla
from cuda_matrix_inversion_tpu_torch import types as port_types
from cuda_matrix_inversion_tpu_torch.bench.reporting import identity_error_inf
from cuda_matrix_inversion_tpu_torch.io import fixtures, replicate
from cuda_matrix_inversion_tpu_torch.native import build as native_build
from cuda_matrix_inversion_tpu_torch.ops import (
    cuda_build,
    cuda_cholesky,
    cuda_lu,
    host_api,
    linalg,
    lu_bign,
    newton_schulz,
)
from cuda_matrix_inversion_tpu_torch.ops import registry as port_registry
from cuda_matrix_inversion_tpu_torch.ops.registry import (
    get_inverse_algorithm,
    list_inverse_algorithms,
)

LANES = ["cholesky", "cholesky_pallas", "gauss_pallas", "lu",
         "lu_bign_pallas", "lu_hiacc", "lu_pallas", "newton_schulz",
         "newton_schulz_pallas", "newton_schulz_pan500_pallas",
         "newton_schulz_spd", "newton_schulz_spd10_pallas",
         "newton_schulz_spd_pallas"]


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


def test_registry_lanes():
    """The device lanes, then the host lanes: JAX's SciPy three, and the
    native two exactly when the port's oracle is built and loads."""
    built = native_build.ensure_built() is not None
    host = ["cholesky_cpu", "gauss_cpu", "lu_cpu"]
    jax_host = jax_registry.list_inverse_algorithms(cpu=True)
    assert [n for n in jax_host if "native" not in n] == host
    if built:
        host = sorted(host + ["cholesky_native_cpu", "lu_native_cpu"])
    assert list_inverse_algorithms(cpu=False) == LANES
    assert list_inverse_algorithms(cpu=True) == host
    assert list_inverse_algorithms() == LANES + host
    for name in host:
        assert callable(get_inverse_algorithm(name))
    with pytest.raises(KeyError, match="bogus"):
        get_inverse_algorithm("bogus")


@pytest.mark.parametrize("lane,batch,n", [(lane, 8, 32) for lane in LANES]
                         + [("newton_schulz_spd10_pallas", 4, 128),
                            ("lu_pallas", 4, 128)])
def test_inverse_batched_matches_jax(lane, batch, n):
    """≤ 2e-4 on the Newton-Schulz lanes (the port's CPU path rounds
    products to bf16 as the card does; JAX on the CPU computes them in
    fp32), ≤ 1e-4 on lu_pallas, gauss_pallas, lu, cholesky and
    cholesky_pallas."""
    a = fixtures.make_spd_batch(batch, n, np.random.default_rng(n + batch)
                                ).astype(np.float32)
    ref = jax_host_api.inverse_batched(a, algorithm=lane)
    x = host_api.inverse_batched(a, algorithm=lane, device="cpu")
    assert x.dtype == np.float32 and x.shape == a.shape
    assert identity_error_inf(a, ref) < 1e-4
    assert identity_error_inf(a, x) < 1e-4
    assert _rel(x, ref) <= (2e-4 if lane.startswith("newton") else 1e-4)


@pytest.mark.parametrize("lane", ["lu", "lu_pallas"])
def test_check_raises_with_jax_indices(lane):
    a = fixtures.make_square_batch(5, 16, np.random.default_rng(9)
                                   ).astype(np.float32)
    a[1] = 1.0
    a[3] = 0.0
    with pytest.raises(jax_host_api.SingularBatchError) as ref:
        jax_host_api.inverse_batched(a, algorithm="lu", check=True)
    with pytest.raises(host_api.SingularBatchError) as got:
        host_api.inverse_batched(a, algorithm=lane, device="cpu", check=True)
    assert got.value.indices == ref.value.indices == [1, 3]
    assert isinstance(got.value, np.linalg.LinAlgError)


@pytest.mark.parametrize("method,rhs_shape", [("lu", (6, 24, 3)),
                                              ("cholesky", (6, 24))])
def test_solve_batched_matches_jax(method, rhs_shape):
    rng = np.random.default_rng(24)
    a = fixtures.make_spd_batch(6, 24, rng).astype(np.float32)
    rhs = rng.standard_normal(rhs_shape).astype(np.float32)
    ref = jax_host_api.solve_batched(a, rhs, method=method)
    x = host_api.solve_batched(a, rhs, method=method, device="cpu")
    assert x.shape == rhs.shape
    assert _rel(x, ref) <= 1e-5
    host = f"{method}_cpu"
    assert np.array_equal(host_api.solve_batched(a, rhs, method=host),
                          jax_host_api.solve_batched(a, rhs, method=host))
    with pytest.raises(KeyError, match="lu_cpu"):  # the methods it has
        host_api.solve_batched(a, rhs, method="bogus")


def test_cpu_tensors_do_not_launch_kernels():
    counted = (newton_schulz.ns_iterate_cuda, cuda_lu.lu_inverse_cuda,
               cuda_cholesky.inverse_cholesky_cuda, lu_bign.lu_panel_cuda)
    for fn in counted:
        fn.launches = 0
    a = torch.tensor(fixtures.make_spd_batch(3, 16, np.random.default_rng(1)),
                     dtype=torch.float32)
    for lane in LANES:
        assert identity_error_inf(a.numpy(), host_api.inverse_batched_device(
            a, lane).numpy()) < 1e-4
    assert [fn.launches for fn in counted] == [0, 0, 0, 0]


def test_explicit_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    a = np.eye(4, dtype=np.float32)[None]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        host_api.inverse_batched(a, "lu_pallas", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        host_api.solve_batched(a, a[:, :, 0], device="cuda:0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        host_api.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        host_api.inverse_batched(a, "lu_pallas")


def test_kernel_shape_check_rejects_n129():
    """The one-block kernels cap n at 128 (one block's shared memory): the
    shape check rejects larger n on every device.  The lanes route n = 129
    past them, as the JAX package routes past its ceilings (Schur, the
    split3 batched lane, the adaptive loop, the blocked LU), and return
    inverses that pass the gate."""
    cuda_build.check_kernel_input(torch.zeros(2, 128, 128), "k")
    for bad in (torch.zeros(1, 129, 129), torch.zeros(2, 3, 4),
                torch.zeros(4, 4)):
        with pytest.raises(ValueError):
            cuda_build.check_kernel_input(bad, "k")
    spd = fixtures.make_spd_batch(2, 129, np.random.default_rng(129)
                                  ).astype(np.float32)
    general = fixtures.make_nonsym_cond(2, 129, 300.0,
                                        np.random.default_rng(130))
    for lane in ("newton_schulz_spd10_pallas", "newton_schulz_spd_pallas",
                 "newton_schulz_pallas", "newton_schulz_pan500_pallas",
                 "lu_pallas"):
        a = general if lane in ("newton_schulz_pan500_pallas",
                                "lu_pallas") else spd
        x = host_api.inverse_batched_device(torch.tensor(a), lane).numpy()
        assert x.shape == a.shape and x.dtype == np.float32
        assert identity_error_inf(a, x) < 1e-4, lane


@pytest.mark.parametrize("lane", [
    "lu_pallas", "lu_bign_pallas", "newton_schulz_spd10_pallas",
    "newton_schulz_spd_pallas", "newton_schulz_pallas",
    "newton_schulz_pan500_pallas"])
@pytest.mark.parametrize("n", [129, 160, 256])
def test_lanes_past_128_pass_the_gate_and_match_jax(lane, n):
    """Past the one-block kernels every lane returns a gated inverse that
    agrees with the JAX package's library inverse (``xla.inverse_lu``, its
    LU and fp32 polish) on the same float32 input: ≤ 2e-4 relative on the
    Newton-Schulz lanes (bf16 products), ≤ 1e-4 on the LU lanes.  General
    lanes draw κ = 300 nonsymmetric batches, the others the SPD class."""
    rng = np.random.default_rng(n + len(lane))
    if lane in ("lu_pallas", "lu_bign_pallas",
                "newton_schulz_pan500_pallas"):
        a = fixtures.make_nonsym_cond(1, n, 300.0, rng)
    else:
        a = fixtures.make_spd_batch(1, n, rng).astype(np.float32)
    x = host_api.inverse_batched(a, algorithm=lane, device="cpu")
    ref = np.asarray(jax_xla.inverse_lu(a))
    assert x.shape == a.shape and x.dtype == np.float32
    assert identity_error_inf(a, x) < 1e-4
    assert _rel(x, ref) <= (2e-4 if lane.startswith("newton") else 1e-4)


def test_nvcc_missing_is_a_clear_error(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if cuda_build.os.access("/usr/local/cuda/bin/nvcc", cuda_build.os.X_OK):
        pytest.skip("this host has nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()


def test_port_imports_no_jax():
    """A subprocess that refuses any import of jax imports the port,
    inverts a CPU batch through the registry (host lanes included), runs
    every GP method, and drives the reference's harness on the CPU: the
    fixture tree, both bench CLIs, the stream and the autodiff, stats and
    Strassen modules."""
    code = textwrap.dedent("""
        import sys
        class NoJax:
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith(("jax.", "jaxlib")):
                    raise ImportError("jax is blocked: " + name)
                return None
        sys.meta_path.insert(0, NoJax())
        import numpy as np
        import cuda_matrix_inversion_tpu_torch as port
        from cuda_matrix_inversion_tpu_torch import (
            MatrixBatch, default_dtype, read_mats, read_test_folder,
            replicate_matrices, set_default_dtype, write_mats,
        )
        from cuda_matrix_inversion_tpu_torch.io.fixtures import make_spd_batch
        a = make_spd_batch(3, 16, np.random.default_rng(0)).astype(np.float32)
        for lane in port.list_inverse_algorithms():
            x = port.inverse_batched(a, lane, device="cpu")
            err = np.abs(a.astype(np.float64) @ x - np.eye(16)).sum(-1).max()
            assert err < 1e-4, (lane, err)
        from cuda_matrix_inversion_tpu_torch.io.fixtures import make_gp_batch
        from cuda_matrix_inversion_tpu_torch.models.gp import (
            gp_mean_variance_host,
        )
        g = make_gp_batch(3, 16, np.random.default_rng(1))
        f32 = [g[k].astype(np.float32) for k in "abcde"]
        for method in ("solve", "inverse", "lu", "newton_schulz", "pallas",
                       "pallas_ns"):
            mean, var = gp_mean_variance_host(*f32, method=method,
                                              device="cpu")
            assert np.abs(mean - g["means"]).max() < 1e-4, method
            assert np.abs(var - g["variances"]).max() < 1e-4, method
        sizes = (5, 20, 130)
        ms = [make_spd_batch(1, n, np.random.default_rng(n))[0] for n in sizes]
        for m, x in zip(ms, port.bucketed_inverse(ms, "lu_pallas",
                                                  device="cpu")):
            n = m.shape[0]
            assert np.abs(m @ x - np.eye(n)).sum(-1).max() < 1e-4
        import contextlib, io, tempfile
        import torch
        from cuda_matrix_inversion_tpu_torch.bench import (
            gauss_bench, inverse_bench,
        )
        from cuda_matrix_inversion_tpu_torch.io.fixtures import generate_all
        from cuda_matrix_inversion_tpu_torch.io.stream import stream_inverse
        from cuda_matrix_inversion_tpu_torch.native import (
            build, matsio, oracle,
        )
        from cuda_matrix_inversion_tpu_torch.ops import (
            autodiff, cpu_reference, stats, strassen,
        )
        from cuda_matrix_inversion_tpu_torch.utils import printing, timer
        with tempfile.TemporaryDirectory() as root:
            generate_all(root, dims=(4,), num=6)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert inverse_bench.main(
                    [root + "/inverse_6_4x4", "2", "1", "-csv",
                     "--device", "cpu"]) == 0
                assert gauss_bench.main(
                    [root + "/gaussian_6_4x4", "1", "1", "-csv", "--method",
                     "pallas", "--fit", "--device", "cpu"]) == 0
            rows = [line.split() for line in out.getvalue().splitlines()]
            assert rows and all(len(r) in (6, 8) for r in rows), rows
            streamed = list(stream_inverse(
                [root + "/inverse_6_4x4/a.mats"] * 2, "lu_pallas",
                batch_size=5, device="cpu"))
            assert [x.shape[0] for x in streamed] == [5, 5, 2]
        x = torch.eye(3, dtype=torch.float64)[None].requires_grad_(True)
        autodiff.differentiable("lu")(x).sum().backward()
        assert x.grad.shape == (1, 3, 3)
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("maker,args", [
    ("make_spd_batch", (5, 12)), ("make_square_batch", (5, 12)),
    ("make_square_batch", (3, 8, 10.0))])
def test_fixture_copies_match_jax_package(maker, args):
    got = getattr(fixtures, maker)(*args[:2], np.random.default_rng(11),
                                   *args[2:])
    ref = getattr(jax_fixtures, maker)(*args[:2], np.random.default_rng(11),
                                       *args[2:])
    np.testing.assert_array_equal(got, ref)


def test_top_level_exports_cover_the_jax_packages():
    """Every name the JAX package exports is exported by the port too."""
    assert set(jax_package.__all__) <= set(port.__all__)
    assert all(hasattr(port, name) for name in port.__all__)
    assert port.replicate_matrices is replicate.replicate_matrices


@pytest.mark.parametrize("times", [1, 3])
def test_replicate_copy_matches_jax_package(times):
    a = np.random.default_rng(12).standard_normal((4, 5, 6)).astype(np.float32)
    got = replicate.replicate_matrices(a[:, ::2], times)
    ref = jax_replicate.replicate_matrices(a[:, ::2], times)
    np.testing.assert_array_equal(got, ref)
    assert got.flags.c_contiguous and got.dtype == ref.dtype
    with pytest.raises(ValueError, match="times"):
        replicate.replicate_matrices(a, 0)


def test_gate_copy_matches_jax_package():
    rng = np.random.default_rng(2)
    a = fixtures.make_spd_batch(4, 10, rng).astype(np.float32)
    x = np.linalg.inv(a) + 1e-6 * rng.standard_normal(a.shape).astype(np.float32)
    assert identity_error_inf(a, x) == jax_reporting.identity_error_inf(a, x)


def test_types_default_dtype_and_batch():
    assert port_types.default_dtype() == torch.float32
    try:
        for spec, want in (("float64", torch.float64),
                           (np.float32, torch.float32),
                           (torch.bfloat16, torch.bfloat16)):
            port_types.set_default_dtype(spec)
            assert port_types.default_dtype() == want
        with pytest.raises(ValueError, match="unsupported"):
            port_types.set_default_dtype("int8")
    finally:
        port_types.set_default_dtype(torch.float32)
    b = port_types.MatrixBatch(np.ones((3, 4)))
    assert b.shape == (1, 3, 4) and (b.m, b.n, len(b)) == (3, 4, 1)
    assert port_types.as_batch(np.eye(3)).shape == (1, 3, 3)
    with pytest.raises(ValueError):
        port_types.as_batch(np.ones(3))


@pytest.mark.parametrize("times", [1, 2, 3])
def test_matrix_batch_replicate_matches_jax_package(times):
    """``MatrixBatch.replicate`` on the JAX suite's shapes
    (``tests/test_misc_surface.py``) against the JAX package's."""
    a = np.random.default_rng(28).standard_normal((3, 4, 5))
    got = port_types.MatrixBatch(a).replicate(times)
    ref = jax_types.MatrixBatch(a).replicate(times)
    assert isinstance(got, port_types.MatrixBatch)
    assert (got.batch_size, got.m, got.n) == (3 * times, 4, 5)
    np.testing.assert_array_equal(got.data, ref.data)
    with pytest.raises(ValueError, match="times"):
        port_types.MatrixBatch(a).replicate(0)


@pytest.mark.parametrize("cpu", [False, True])
@pytest.mark.parametrize("package", ["jax", "port"])
def test_register_inverse_lists_and_gets_the_lane(monkeypatch, package, cpu):
    """A lane added with ``register_inverse`` is listed with its kind
    (device or host) and in the whole list, is got back by name and
    carries its ``pallas`` mark, in both packages; the registry's tables
    are restored afterwards."""
    reg = jax_registry if package == "jax" else port_registry
    reg.list_inverse_algorithms()  # the JAX registry fills its tables lazily
    tables = ["_CPU_ALGORITHMS", "_PALLAS_ALGORITHMS"]
    tables += (["_DEVICE_ALGORITHMS"] if package == "jax"
               else ["_FUNCTIONS", "LANES"])
    for table in tables:
        monkeypatch.setattr(reg, table, copy.copy(getattr(reg, table)))
    name = "test_lane_cpu" if cpu else "test_lane_device"

    def fn(a):
        return ("ran", a)

    reg.register_inverse(name, fn, cpu=cpu, pallas=not cpu)
    assert name in reg.list_inverse_algorithms(cpu=cpu)
    assert name not in reg.list_inverse_algorithms(cpu=not cpu)
    assert name in reg.list_inverse_algorithms()
    a = np.eye(3, dtype=np.float32)[None]
    got = reg.get_inverse_algorithm(name)(a)
    assert got[0] == "ran" and got[1] is a
    assert reg.is_pallas_algorithm(name) == (not cpu)
    if package == "port":
        assert linalg.batched_inverse(a, name)[1] is a


@pytest.mark.parametrize("lane", LANES)
def test_pallas_marks_match_the_jax_registry(lane):
    assert (port_registry.is_pallas_algorithm(lane)
            == jax_registry.is_pallas_algorithm(lane))


@pytest.mark.parametrize("algorithm", [None, "cholesky", "lu_pallas",
                                       "gauss_pallas", "cholesky_pallas",
                                       "newton_schulz_spd10_pallas"])
def test_batched_inverse_is_the_registry_lane(algorithm):
    """``linalg.batched_inverse`` runs the registry's lane (``lu`` by
    default) on a CPU batch: the same bits as ``get_inverse_algorithm``,
    through the gate; the default also against the JAX package's
    ``xla.batched_inverse``."""
    a = fixtures.make_spd_batch(4, 16, np.random.default_rng(3)).astype(
        np.float32)
    at = torch.tensor(a)
    kw = {} if algorithm is None else {"algorithm": algorithm}
    got = linalg.batched_inverse(at, **kw)
    ref = get_inverse_algorithm(algorithm or "lu")(at)
    assert torch.equal(got, ref)
    assert identity_error_inf(a, got.numpy()) < 1e-4
    if algorithm is None:
        jax_ref = np.asarray(jax_xla.batched_inverse(a))
        assert _rel(got.numpy(), jax_ref) < 1e-5
