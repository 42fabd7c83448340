"""The port's native LAPACK + OpenMP oracle and ``.mats`` parser
(``cuda_matrix_inversion_tpu_torch/native``): sources byte-identical to the
JAX package's, the build in ``build/torch_native/`` (concurrent builds
safe), the oracle against the port's ``cpu_reference``, and the parser
against ``io.mats``.

The JAX package's own build (``cuda_matrix_inversion_tpu.native.build``)
is never called here: the port builds from its own copies.  Skipped only
where ``g++`` or ``liblapack.so.3`` is absent.
"""

import ctypes.util
import filecmp
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from cuda_matrix_inversion_tpu_torch.io import mats
from cuda_matrix_inversion_tpu_torch.io.fixtures import (
    make_gp_batch,
    make_spd_batch,
    make_square_batch,
)
from cuda_matrix_inversion_tpu_torch.io.replicate import replicate_matrices
from cuda_matrix_inversion_tpu_torch.native import build, matsio, oracle
from cuda_matrix_inversion_tpu_torch.ops import cpu_reference
from cuda_matrix_inversion_tpu_torch.ops.registry import (
    get_inverse_algorithm,
    list_inverse_algorithms,
)

REPO = Path(__file__).resolve().parents[1]
# fp32 oracle against the SciPy oracle, max-norm relative: both LAPACK,
# possibly different builds (blocking, summation order)
RTOL_F32 = 1e-5
RTOL_F64 = 1e-12


@pytest.fixture(scope="module", autouse=True)
def built():
    if shutil.which("g++") is None or ctypes.util.find_library("lapack") is None:
        pytest.skip("needs g++ and liblapack.so.3")
    path = build.ensure_built()
    assert path is not None, "the native oracle did not build"
    return path


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("name", ["oracle.cpp", "matsio.cpp"])
def test_sources_are_byte_identical_to_jax(name):
    port = REPO / "cuda_matrix_inversion_tpu_torch" / "native" / name
    jax = REPO / "cuda_matrix_inversion_tpu" / "native" / name
    assert filecmp.cmp(port, jax, shallow=False)


def test_library_lands_in_build_torch_native(built):
    assert Path(built) == REPO / "build" / "torch_native" / "libcmi_native.so"
    assert build.lib_path() == built
    assert oracle.available() and matsio.available()


def test_native_lanes_register_once_the_library_loads():
    host = list_inverse_algorithms(cpu=True)
    assert {"lu_native_cpu", "cholesky_native_cpu"} <= set(host)
    assert get_inverse_algorithm("lu_native_cpu") is oracle.inverse_lu


def test_two_processes_building_at_once_both_load():
    """Each process compiles to a name of its own in ``build/torch_native``
    and renames it onto the library, so neither loads a half-written
    file."""
    code = textwrap.dedent("""
        import numpy as np
        from cuda_matrix_inversion_tpu_torch.native import build, oracle
        path = build.build(verbose=False)
        a = np.eye(4, dtype=np.float32)[None] * 2.0
        assert oracle.available()
        assert np.allclose(oracle.inverse_lu(a), 0.5 * np.eye(4))
        print(path)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == str(build.LIB)
    leftovers = [f.name for f in build.BUILD_DIR.iterdir()
                 if f.name.endswith(".tmp")]
    assert leftovers == []


@pytest.mark.parametrize("dtype,rtol", [(np.float32, RTOL_F32),
                                        (np.float64, RTOL_F64)])
@pytest.mark.parametrize("name,kind", [("inverse_lu", "square"),
                                       ("inverse_cholesky", "spd")])
def test_oracle_matches_cpu_reference(name, kind, dtype, rtol):
    rng = np.random.default_rng(21)
    make = make_spd_batch if kind == "spd" else make_square_batch
    a = make(9, 24, rng).astype(dtype)
    got = getattr(oracle, name)(a)
    ref = getattr(cpu_reference, name)(a)
    assert got.dtype == dtype and got.shape == a.shape
    assert _rel(got, ref) <= rtol


@pytest.mark.parametrize("solve", [True, False])
@pytest.mark.parametrize("want", ["both", "mean", "variance"])
def test_oracle_gp_matches_cpu_reference(solve, want):
    g = make_gp_batch(6, 16, np.random.default_rng(22))
    a, b, c, d, e = (g[k].astype(np.float32) for k in "abcde")
    mean, var = oracle.gp_mean_variance(a, b, c, d, e, solve=solve, want=want)
    if solve:
        ref_m = cpu_reference.calculate_mean_solve_cpu(a, b, c, d)
        ref_v = cpu_reference.calculate_variance_solve_cpu(a, b, c, e)
    else:
        ref_m = cpu_reference.calculate_mean_cpu(a, b, c, d)
        ref_v = cpu_reference.calculate_variance_cpu(a, b, c, e)
    if want in ("both", "mean"):
        assert _rel(mean, ref_m[:, 0, 0]) <= RTOL_F32
    else:
        assert not mean.any()
    if want in ("both", "variance"):
        assert _rel(var, ref_v[:, 0, 0]) <= RTOL_F32
    else:
        assert not var.any()


def test_oracle_reports_the_singular_member():
    a = make_spd_batch(3, 8, np.random.default_rng(23)).astype(np.float32)
    a[2] = 0.0
    with pytest.raises(np.linalg.LinAlgError, match="batch index 2"):
        oracle.inverse_lu(a)


def test_matsio_roundtrips_against_io_mats(tmp_path):
    arr = np.random.default_rng(24).standard_normal((7, 5, 3))
    p1, p2 = str(tmp_path / "port.mats"), str(tmp_path / "native.mats")
    mats.write_mats(p1, arr)
    np.testing.assert_array_equal(matsio.read_mats(p1),
                                  mats.read_mats(p1, dtype=np.float64))
    matsio.write_mats(p2, arr)
    np.testing.assert_array_equal(mats.read_mats(p2, dtype=np.float64), arr)
    np.testing.assert_array_equal(matsio.read_mats(p2), arr)


def test_matsio_replicate_matches_replicate_matrices():
    arr = np.random.default_rng(25).standard_normal((2, 3, 3))
    np.testing.assert_array_equal(matsio.replicate(arr, 4),
                                  replicate_matrices(arr, 4))
